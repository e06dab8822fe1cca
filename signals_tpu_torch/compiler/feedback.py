"""Feedback-loop analysis: solving delay cycles without a block loop
(``signals_tpu.compiler.feedback``; the analysis touches no array library,
so this is that module with the port's imports).

Feedback runs through block-quantized :class:`~signals_tpu_torch.nodes.
delay.Delay` lines, which the compiler's fallback renders block by block —
correct, but in eager PyTorch every block pays the host dispatch of a whole
patch lowering.

This module recognizes the structure that makes feedback *solvable in
closed form*: when every path from a delay's output back to its own input
passes only through **frame-local affine** nodes (gains, mixes, ring-mod
by an off-cycle signal), the delay input obeys

    ``u[t] = g[t] * u[t - D] + h[t]``

with ``g``/``h`` independent of ``u``.  Splitting the timeline into
``D``-frame segments turns this into a first-order affine recurrence over
segments — one log-step scan of the segments' maps instead of ``n_blocks``
sequential lowerings.  ``g`` and ``h`` are extracted by lowering the loop
expression twice with the delay output substituted by the constants 0 and
1 (sound because this analysis has *proved* the map affine first; the
subtraction costs ~1 ulp of ``h``, far inside the 1e-5 parity budget).

Delays whose input does not depend on their own output (echo sends, dry
taps) degenerate to ``g = 0`` — a pure shifted read — and are solved by
the same machinery with no substitution traces at all.  Delay-to-delay
*chains* solve in dependency order; mutually-coupled delay pairs (a
2-state system) fall back to the segmented scan.
"""

from __future__ import annotations

import typing

from signals_tpu_torch.graph import Emitter, Receiver


def _is_delay(node) -> bool:
    from signals_tpu_torch.compiler import _is_delay as impl
    return impl(node)


def _is_tap(node) -> bool:
    # single source of truth: the compiler's predicate (a tap kind added
    # there must also disqualify solved-loop paths here, where taps must
    # observe true values)
    from signals_tpu_torch.compiler import _is_tap as impl
    return impl(node)


def _inputs(node) -> typing.Iterator[Emitter]:
    if isinstance(node, Receiver):
        for p in node._ports.values():
            if p.sig is not None:
                yield p.sig


def upstream_ids(node: Emitter) -> set:
    """ids of every node reachable upstream of ``node`` (through delays),
    including ``node`` itself."""
    seen: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        stack.extend(_inputs(n))
    return seen


class DelayPlan(typing.NamedTuple):
    """Solve order for a patch's delay lines.

    ``order``: delays in dependency order (a delay's input may reference
    only earlier delays, or itself); ``cyclic``: ``id(delay) -> bool``,
    True when the delay's input depends on its own output (the affine
    recurrence case), False for pure shifted reads.
    """
    order: list
    cyclic: dict


def _affine_in_delay(start: Emitter, delay: Emitter) -> bool:
    """Whether ``start``'s output is a frame-local affine function of
    ``delay``'s output (degree <= 1 per frame/channel, no cross-frame or
    cross-channel mixing on the dependent path).

    Whitelist semantics per node (all
    :class:`~signals_tpu_torch.nodes.fx` elementwise effects):

    * ``Mix``: affine in left/right jointly; the ``mix`` port must be
      independent of the delay (it is sampled at block rate — dependence
      there would make the map non-frame-local).
    * ``Gain``: affine in ``left``; ``right`` (block-rate) must be
      independent.
    * ``RingMod``: affine in one operand while the other is independent
      (both dependent would be quadratic).

    Any other node type on a dependent path (filters convolve over time,
    ``Amp``/``Drive`` are nonlinear, shape ops mix channels, taps must
    observe true values, stateful nodes carry history) disqualifies the
    loop.  ``enabled`` gating is ``where(enabled, affine, passthru/zero)``
    — affine in both branches — so it needs no special casing.
    """
    from signals_tpu_torch.nodes.fx import Gain, Mix, RingMod

    dep_cache: dict = {}

    def depends(n: typing.Optional[Emitter]) -> bool:
        if n is None:
            return False
        if id(n) not in dep_cache:
            dep_cache[id(n)] = id(delay) in upstream_ids(n)
        return dep_cache[id(n)]

    memo: dict = {}

    def deg(n: typing.Optional[Emitter]) -> typing.Optional[int]:
        """0 = independent of the delay, 1 = affine, None = disqualified."""
        if n is None:
            return 0
        if n is delay:
            return 1
        if not depends(n):
            return 0
        if id(n) in memo:
            return memo[id(n)]
        if _is_delay(n) or _is_tap(n):
            # another delay on the path is a cross-delay cycle (the
            # caller has ruled those out, so reaching one here means the
            # plan is invalid); a dependent tap must observe true values
            r = None
        elif isinstance(n, Mix):
            dm = deg(n._ports['mix'].sig)
            dl = deg(n._ports['left'].sig)
            dr = deg(n._ports['right'].sig)
            r = (None if dm != 0 or dl is None or dr is None
                 else max(dl, dr))
        elif isinstance(n, Gain):
            dr = deg(n._ports['right'].sig)
            dl = deg(n._ports['left'].sig)
            r = None if dr != 0 or dl is None else dl
        elif isinstance(n, RingMod):
            dl = deg(n._ports['left'].sig)
            dr = deg(n._ports['right'].sig)
            if dl is None or dr is None or (dl and dr):
                r = None
            else:
                r = max(dl, dr)
        else:
            r = None
        memo[id(n)] = r
        return r

    return deg(start) is not None


def structural_delays(index, block_frames: int, rate: int
                      ) -> typing.Optional[list]:
    """The patch's delay nodes, if the *surrounding* structure supports
    whole-window (mega-style) lowering — or None.

    Conditions mirror :attr:`CompiledPatch.mega_compatible` for the
    non-delay part of the patch:

    * at least one delay; every delay >= one block long (the engine's
      feedback-latency rule);
    * no host-fed sources (mega windows stage no host input);
    * every other stateful node offers ``mega_step``/grid lowering
      (consumers may read it at any non-future window — the compiler
      serves those from the node's ``hist`` carry ring).

    Shared precondition of the loop-free solver (:func:`plan_delays`)
    and the segmented scan (:func:`segment_blocks`).
    """
    from signals_tpu_torch.compiler import (
        _is_grid_stateless,
        _is_host_source,
        _is_stateful,
    )

    delays = [n for n in index.order if _is_delay(n)]
    if not delays:
        return None
    for node in index.order:
        if _is_host_source(node):
            return None
        if _is_delay(node):
            if node.delay_frames(rate) < block_frames:
                return None
            continue
        if _is_stateful(node) and not _is_grid_stateless(node):
            if not getattr(node, 'supports_mega_step', False):
                return None
    return delays


def segment_blocks(index, block_frames: int, rate: int) -> int:
    """Largest whole-window segment length, in blocks, for the segmented
    feedback scan — or 0 when the structure disqualifies it.

    Inside a window of ``S`` blocks with ``S * block_frames <= D`` for
    every delay ``D``, every delay read is served entirely from the
    carried buffer — there is NO cycle within the window, whatever the
    loop topology (nonlinear saturated echoes, mutually-coupled
    ping-pong pairs, longer chains).  The compiler can therefore lower
    the whole segment like one mega window and loop over segments,
    paying the lowering's host overhead once per ``S`` blocks instead of
    per block.  This is the general fallback between the closed-form
    affine solver (:func:`plan_delays`, O(log n) depth) and the
    per-block scan (S effectively 1).

    Delays may be consumed at any window — the main window, context
    lookbacks, block-rate samples: the collect pass guarantees every
    window is non-future (it rejects ``end > block_frames`` at compile),
    so the carried buffer (sized ``D`` + history headroom) serves them
    all.
    """
    delays = structural_delays(index, block_frames, rate)
    if not delays:
        return 0
    return min(d.delay_frames(rate) // block_frames for d in delays)


def plan_delays(index, block_frames: int, rate: int
                ) -> typing.Optional[DelayPlan]:
    """Build a :class:`DelayPlan` for the patch, or None when any delay
    (or the surrounding patch structure) cannot be solved loop-free.

    Conditions: :func:`structural_delays` plus per-delay solvability:

    * no two distinct delays are mutually dependent (a coupled 2-state
      system — the segmented scan handles it);
    * every self-dependent delay's loop is frame-local affine
      (:func:`_affine_in_delay`).
    """
    delays = structural_delays(index, block_frames, rate)
    if delays is None:
        return None

    up_in: dict = {}
    for d in delays:
        inp = d._ports['input'].sig
        up_in[id(d)] = set() if inp is None else upstream_ids(inp)
    cyclic = {id(d): id(d) in up_in[id(d)] for d in delays}
    # cross-delay dependence graph (self-loops excluded)
    deps = {id(d): [e for e in delays
                    if e is not d and id(e) in up_in[id(d)]]
            for d in delays}
    for d in delays:
        for e in deps[id(d)]:
            if d in deps[id(e)]:
                return None              # mutually coupled pair
    # dependency (topological) order
    order: list = []
    placed: set = set()
    pending = list(delays)
    while pending:
        progressed = False
        for d in list(pending):
            if all(id(e) in placed for e in deps[id(d)]):
                order.append(d)
                placed.add(id(d))
                pending.remove(d)
                progressed = True
        if not progressed:
            return None                  # longer dependency cycle
    for d in delays:
        if cyclic[id(d)]:
            if not _affine_in_delay(d._ports['input'].sig, d):
                return None
    return DelayPlan(order=order, cyclic=cyclic)
