"""Render-state checkpointing (``signals_tpu.utils.checkpoint``).

The reference's checkpoint system is the ``.sigs`` patch file plus seekable
sink positions.  The compiled engine adds one more piece of state: the
carry (delay lines, filter states, output-history rings).  A checkpoint is
all three — patch text, timeline position, carry — so a render resumes
*sample-exactly*.

The file is the JAX package's: an ``.npz`` with a ``__meta__`` JSON entry
(position, graph hash, patch lines, carry keys) and one ``carry:<uid>/<leaf>``
array a carry leaf, so a checkpoint written by either package loads in the
other (the carry layout is shared, :mod:`signals_tpu_torch.interop`).  The
port's carry lives on the device: :func:`save` copies it off in one
transfer per dtype, :func:`load` puts it back on ``device`` the same way,
each leaf with its own dtype.  A recorded graph hash refuses a checkpoint
against an incompatibly edited patch.  (The port's graph hash includes the
compile device, so a checkpoint of the other package or of another device
loads with ``expect_graph_hash=None``.)
"""

from __future__ import annotations

import json
import pathlib
import typing

import numpy as np
import torch


def _flatten(carry: dict, prefix: str = '') -> dict:
    flat = {}
    for k, v in carry.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            flat.update(_flatten(v, key + '/'))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    carry: dict = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = carry
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return carry


def _by_dtype(flat: dict) -> dict:
    groups: dict = {}
    for key, v in flat.items():
        groups.setdefault(v.dtype, []).append(key)
    return groups


def _to_host(flat: dict) -> dict[str, np.ndarray]:
    """Every leaf as numpy; the tensors of one dtype copied off their
    device in one transfer."""
    out = {k: np.asarray(v) for k, v in flat.items()
           if not isinstance(v, torch.Tensor)}
    tensors = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}
    for keys in _by_dtype(tensors).values():
        host = torch.cat([tensors[k].detach().reshape(-1)
                          for k in keys]).cpu().numpy()
        at = 0
        for k in keys:
            n = tensors[k].numel()
            out[k] = host[at:at + n].reshape(tuple(tensors[k].shape))
            at += n
    return out


def _to_device(flat: dict[str, np.ndarray], device) -> dict:
    """Every leaf as a tensor on ``device`` with its own dtype; the leaves
    of one dtype copied in one transfer."""
    from signals_tpu_torch.compiler import check_device
    device = check_device(device)
    out = {}
    for keys in _by_dtype(flat).values():
        host = torch.from_numpy(np.concatenate(
            [np.ascontiguousarray(flat[k]).reshape(-1) for k in keys]))
        if device.type == 'cuda':
            host = host.pin_memory()
        dev = host.to(device, non_blocking=True)
        at = 0
        for k in keys:
            n = flat[k].size
            out[k] = dev[at:at + n].reshape(flat[k].shape)
            at += n
    return out


class CheckpointMismatch(Exception):
    pass


def save(path,
         *,
         position: int,
         carry: typing.Optional[dict] = None,
         graph_hash: str = '',
         patch_lines: typing.Iterable[str] = ()) -> None:
    """Write a resume checkpoint: ``carry`` as a render returned it
    (tensors on any device, or numpy arrays).  ``patch_lines`` is typically
    the patch's ``.sigs`` dump."""
    path = pathlib.Path(path)
    flat = _to_host(_flatten(carry or {}))
    meta = {
        'position': int(position),
        'graph_hash': graph_hash,
        'patch': list(patch_lines),
        'carry_keys': sorted(flat.keys()),
    }
    np.savez(path, __meta__=json.dumps(meta),
             **{f'carry:{k}': v for k, v in flat.items()})


def load(path, *, expect_graph_hash: typing.Optional[str] = None,
         device='cuda') -> dict:
    """Read a checkpoint -> ``{'position', 'carry', 'graph_hash',
    'patch'}`` with the carry on ``device`` (each leaf a tensor of its
    stored dtype).  Raises
    :class:`CheckpointMismatch` when ``expect_graph_hash`` is given and
    differs from the recorded hash."""
    path = pathlib.Path(path)
    with np.load(path if path.suffix else path.with_suffix('.npz'),
                 allow_pickle=False) as data:
        meta = json.loads(str(data['__meta__']))
        flat = {k[len('carry:'):]: data[k]
                for k in data.files if k.startswith('carry:')}
    if (expect_graph_hash is not None
            and meta['graph_hash']
            and meta['graph_hash'] != expect_graph_hash):
        raise CheckpointMismatch(
            f'checkpoint was taken against graph {meta["graph_hash"][:12]}…, '
            f'current graph is {expect_graph_hash[:12]}…')
    return {
        'position': meta['position'],
        'graph_hash': meta['graph_hash'],
        'patch': meta['patch'],
        'carry': _unflatten(_to_device(flat, device)),
    }
