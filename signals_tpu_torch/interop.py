"""Parameter exchange with the JAX package.

``signals_tpu``'s ``CompiledPatch.params()`` / ``PolyPatch.params()[0]``
and this port's share one layout — node uid (same numbering scheme) → leaf
name → array — so a parameter set taken from one engine renders the same
values in the other, and edits made on the JAX side replay on the port.
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
