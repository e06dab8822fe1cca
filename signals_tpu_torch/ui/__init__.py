"""UI layer.

Split Qt-free from Qt-bound: themes (:mod:`signals_tpu_torch.ui.theme`) and
geometry (:mod:`signals_tpu_torch.ui.geometry`) are pure data/math usable by any
frontend; the visualization rack (:mod:`signals_tpu_torch.ui.vis`) renders with
matplotlib; the interactive patcher TUI (:mod:`signals_tpu_torch.ui.tui`) runs in
any terminal.  The reference's PyQt5 patcher GUI (``src/signals/ui/``,
half-finished there) maps onto these pieces; a Qt frontend can be layered on
when PyQt is available, but nothing in the framework requires it.
"""
