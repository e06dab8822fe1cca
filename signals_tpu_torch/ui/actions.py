"""Frontend-shared edit actions: fuzzy library search, clipboard payloads,
state-editor field marshalling.

The curses patcher (:mod:`signals_tpu_torch.ui.tui`) and the graphical patcher
(:mod:`signals_tpu_torch.ui.gui`) both route every mutation through the
undoable :class:`~signals_tpu_torch.map.control.Controller` command stack; this
module holds the logic they share so the two frontends stay in lockstep.
"""

from __future__ import annotations

import typing

from signals_tpu_torch.map import Coordinates, SigState, SigStateItem


def fuzzy_rank(names: typing.Iterable[str], query: str) -> list[str]:
    """Rank signal names against a query: leaf-substring beats full-path
    substring beats subsequence; shorter and earlier matches first."""
    q = query.lower()
    scored = []
    for name in names:
        low = name.lower()
        leaf = low.rsplit('.', 1)[-1]
        if not q:
            scored.append((2, len(name), name))
            continue
        if q in leaf:
            scored.append((0, len(leaf) + leaf.index(q), name))
        elif q in low:
            scored.append((1, len(name), name))
        else:
            it = iter(low)
            if all(c in it for c in q):
                scored.append((2, len(name), name))
    return [n for _, _, n in sorted(scored)]


def clip_payload(controller, at: Coordinates
                 ) -> typing.Optional[tuple[str, str]]:
    """``(cls_name, state_text)`` of the node at ``at`` — the clipboard
    payload (the reference serializes a MappedSigInfo as a MIME payload,
    ``ui/patcher/window.py:159-178``)."""
    for info in controller.map.iter_signals():
        if info.at == at:
            sig = controller.map.get(at)
            state = SigState.from_signal(sig) if sig is not None \
                else info.state
            return info.cls_name, state.items_text()
    return None


def paste_line(at: Coordinates, payload: tuple[str, str]) -> str:
    """The undoable add-command line re-creating a copied node at ``at``."""
    cls_name, state_text = payload
    return f'+ {at} {cls_name} {state_text}'.rstrip()


def clip_text(payload: tuple[str, str]) -> str:
    """OS-clipboard text form of a copied node: the ``.sigs`` add line
    (with a placeholder coordinate — paste re-targets it).  The Tk/text
    analogue of the reference's ``application/prs.signals.signal`` MIME
    payload, which is also a serialized Add command
    (``ui/patcher/window.py:159-178``); being plain ``.sigs`` grammar it
    pastes into any text editor and round-trips between processes."""
    return paste_line(Coordinates.parse('1a'), payload)


def parse_clip_text(text: str) -> typing.Optional[tuple[str, str]]:
    """Recover a ``(cls_name, state_text)`` payload from OS-clipboard
    text, or None when the text is not a ``.sigs`` add line."""
    parts = text.strip().split(None, 3)
    if len(parts) < 3 or parts[0] != '+':
        return None
    try:
        Coordinates.parse(parts[1])
    except Exception:
        return None
    return parts[2], parts[3] if len(parts) > 3 else ''


def state_fields(controller, at: Coordinates) -> list[tuple[str, str]]:
    """``(name, value_text)`` pairs for a state-editor form (the
    reference's SigStateEditor, ``ui/patcher/dialog.py:72-115``)."""
    sig = controller.map.get(at)
    if sig is None:
        return []
    state = SigState.from_signal(sig)
    return [(k, SigStateItem.dump_value(v)) for k, v in sorted(state.items())]


def edit_line(at: Coordinates, name: str, value_text: str) -> str:
    """The undoable edit-command line setting one state field."""
    return f'* {at} {name}={value_text}'
