"""Parameter and carry exchange with the JAX package.

``signals_tpu``'s ``CompiledPatch.params()`` / ``PolyPatch.params()[0]``
and this port's share one layout — node uid (same numbering scheme) → leaf
name → array — so a parameter set taken from one engine renders the same
values in the other, and edits made on the JAX side replay on the port.
The carried state has one layout too (``carry0`` / the carry a render
returns: uid → ``zi`` ``(nsec, 2, ch)`` coupled-form filter state, ``buf``
``(B, ch)`` delay input line, ``hist`` ``(H, ch)`` output ring), so a
render begun in one engine continues in the other.
This module touches no JAX: it converts any array-likes (numpy arrays or
JAX arrays) via numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from signals_tpu_torch.compiler import check_device


def params_from_jax(params: dict, device) -> dict:
    """``{uid: {leaf: array}}`` → ``{uid: {leaf: tensor on device}}``,
    keeping each leaf's dtype (bool, int32, float32)."""
    device = check_device(device)
    return {uid: {name: torch.as_tensor(np.asarray(v), device=device)
                  for name, v in leaves.items()}
            for uid, leaves in params.items()}


def carry_from_jax(carry: dict, device) -> dict:
    """A carry of the JAX package (``CompiledPatch.carry0`` or the second
    value of its ``render`` / ``step``, as numpy or JAX arrays) as the
    port's carry ``{uid: {name: float32 tensor on device}}``."""
    device = check_device(device)
    return {uid: {name: torch.as_tensor(np.array(v, dtype=np.float32),
                                        device=device)
                  for name, v in leaves.items()}
            for uid, leaves in carry.items()}
