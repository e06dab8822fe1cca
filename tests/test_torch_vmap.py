"""The kernel entries under ``torch.func.vmap``: the voice-folding rule.

``PolyPatch(layout='vmap')`` vmaps a one-voice plan over the voices, so
every cascade entry of :mod:`signals_tpu_torch.compiler.kernels` meets
tensors batched over the voices.  Each entry's ``autograd.Function`` has a
``vmap`` rule that folds the voice axis into the lane axis and makes ONE
call of the entry on ``V x lanes`` lanes.  On the CPU that call runs the
plain version, which these tests count; a vmap over V = 3 voices must give
the same bits as three separate calls, with a shared (unbatched) operand,
a one-channel input read through a stride-0 lane, lane-group sums and
start states, and its gradients must equal the separate calls' to f32
rounding (the backward runs once, on the folded lanes).  The ``cuda`` cases
hold the kernels to the same on the card, one launch a call (skipped
without one).
"""

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import filters as FL
from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.core.xp import TorchXP

V = 3
RATE = 44100
F, C, NSEG = 32, 64, 4


def _coeffs(cutoffs, btype='lp', device='cpu'):
    """``design_coupled`` rows ``(nsec, len(cutoffs), 11)``."""
    xp = TorchXP(device)
    crits = ((torch.tensor([cutoffs], dtype=torch.float32),)
             if btype in ('lp', 'hp') else
             (torch.tensor([cutoffs], dtype=torch.float32),
              torch.tensor([[c * 1.6 for c in cutoffs]],
                           dtype=torch.float32)))
    return FL.design_coupled(xp, btype, crits, np.float32(RATE / 2))


def _block_coeffs(rng, n, lanes, btype='lp'):
    """``(n, nsec, lanes, 11)``: a cutoff per block and lane."""
    cut = rng.uniform(300.0, 4000.0, (n, lanes))
    co = [_coeffs(list(cut[b]), btype) for b in range(n)]
    return torch.stack(co)


def _counting(monkeypatch, name):
    """Count the calls of the plain version ``name`` of kernels.py."""
    calls = []
    orig = getattr(K, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(K, name, wrapped)
    return calls


# Each case returns (entry, plain name, operands, in_dims, kwargs); the
# batched operands carry a leading voice axis of V.


def _gen_case(rng, batched_coeffs):
    L = 2
    co = _block_coeffs(rng, NSEG, L)
    if batched_coeffs:
        co = torch.stack([_block_coeffs(rng, NSEG, L) for _ in range(V)])
    toff = torch.full((L,), 5 * F - C, dtype=torch.int32)
    lanef = torch.tensor(np.stack([
        np.stack([rng.uniform(100, 900, L), rng.uniform(0, 1, L),
                  np.ones(L)]) for _ in range(V)]), dtype=torch.float32)
    kw = dict(n_segments=NSEG, seg_frames=F, context=C, osc_code=K.OSC_SAW,
              rate=RATE, sum_groups=0, blocks_per_seg=2)
    return (K.sosfilt_segments_gen, 'sosfilt_segments_gen_plain',
            (co, toff, lanef), (0 if batched_coeffs else None, None, 0), kw)


def _seg_case(rng, x_kind, sum_groups):
    L = 4
    co = torch.stack([_block_coeffs(rng, NSEG, L) for _ in range(V)])
    T = C + NSEG * F
    if x_kind == 'shared_one_channel':      # one column read by every lane
        x, xd = torch.tensor(rng.standard_normal((T, 1)),
                             dtype=torch.float32), None
    else:
        x, xd = torch.tensor(rng.standard_normal((V, T, L)),
                             dtype=torch.float32), 0
    kw = dict(n_segments=NSEG, seg_frames=F, context=C,
              sum_groups=sum_groups, blocks_per_seg=1)
    return (K.sosfilt_segments, 'sosfilt_segments_plain', (co, x), (0, xd),
            kw)


def _timeline_case(rng):
    co = _coeffs([700.0, 2500.0])                     # shared (1, 2, 11)
    x = torch.tensor(rng.standard_normal((V, 100, 2)), dtype=torch.float32)
    return (K.sosfilt_timeline, 'sosfilt_timeline_plain', (co, x),
            (None, 0), {})


def _stream_case(rng):
    co = torch.stack([_coeffs(list(rng.uniform(400, 3000, 2)), 'bp')
                      for _ in range(V)])             # (V, 2, 2, 11)
    x = torch.tensor(rng.standard_normal((90, 2)), dtype=torch.float32)
    zi = torch.tensor(rng.standard_normal((V, 2, 2, 2)) * 0.1,
                      dtype=torch.float32)
    return (K.sosfilt_stream, 'sosfilt_stream_plain', (co, x, zi),
            (0, None, 0), {})


def _batch_case(rng, with_state, ch=2):
    B, Lr = 3, 40
    co = torch.stack([_coeffs(list(rng.uniform(400, 3000, ch)))
                      for _ in range(B)])             # shared (B, 1, 2, 11)
    x = torch.tensor(rng.standard_normal((V, Lr, B, ch)),
                     dtype=torch.float32)
    args, dims = [co, x], [None, 0]
    if with_state:
        args.append(torch.tensor(rng.standard_normal((V, B, 1, 2, ch)) * 0.1,
                                 dtype=torch.float32))
        dims.append(0)

    def entry(co, x, zi=None):
        return K.sosfilt_batch(co, x, tail=16, zi=zi, return_state=True)

    return entry, 'sosfilt_batch_plain', tuple(args), tuple(dims), {}


CASES = {
    'segments_gen': lambda rng: _gen_case(rng, False),
    'segments_gen_batched_coeffs': lambda rng: _gen_case(rng, True),
    'segments_one_channel': lambda rng: _seg_case(rng, 'shared_one_channel',
                                                  0),
    'segments_sum_groups': lambda rng: _seg_case(rng, 'batched', 2),
    'timeline': _timeline_case,
    'stream': _stream_case,
    'batch': lambda rng: _batch_case(rng, False),
    'batch_state': lambda rng: _batch_case(rng, True),
    'batch_one_lane': lambda rng: _batch_case(rng, False, ch=1),
}


def _separate(entry, args, dims, kw):
    """The entry called once per voice; outputs stacked over the voices."""
    outs = []
    for v in range(V):
        one = [a if d is None else a[v] for a, d in zip(args, dims)]
        outs.append(entry(*one, **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _as_tuple(y):
    return y if isinstance(y, tuple) else (y,)


@pytest.mark.parametrize('case', list(CASES))
def test_vmap_rule_matches_separate_calls(case, monkeypatch):
    rng = np.random.default_rng(11)
    entry, plain, args, dims, kw = CASES[case](rng)
    want = _separate(entry, args, dims, kw)
    calls = _counting(monkeypatch, plain)
    got = torch.func.vmap(lambda *a: entry(*a, **kw), in_dims=dims)(*args)
    assert len(calls) == 1                     # ONE call for all voices
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        assert g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize('case', list(CASES))
def test_vmap_rule_gradients_match_separate_calls(case, monkeypatch):
    rng = np.random.default_rng(12)
    entry, plain, args, dims, kw = CASES[case](rng)
    float_args = [i for i, a in enumerate(args) if a.is_floating_point()]
    outs = _as_tuple(_separate(entry, args, dims, kw))
    weights = [torch.tensor(rng.standard_normal(o.shape), dtype=torch.float32)
               for o in outs]

    def grads(run):
        leaves = [a.detach().clone().requires_grad_(i in float_args)
                  for i, a in enumerate(args)]
        ys = _as_tuple(run(leaves))
        loss = sum((y * w).sum() for y, w in zip(ys, weights))
        return torch.autograd.grad(loss, [leaves[i] for i in float_args])

    want = grads(lambda leaves: _separate(entry, leaves, dims, kw))
    vjp_calls = _counting(monkeypatch, plain.replace('_plain', '_vjp_plain'))
    got = grads(lambda leaves: torch.func.vmap(
        lambda *a: entry(*a, **kw), in_dims=dims)(*leaves))
    assert len(vjp_calls) == 1                 # one backward for all voices
    # the adjoint's sums over rows reduce a wider lane axis in one call than
    # in three, so they associate differently: equal to f32 rounding of the
    # largest gradient (the forward above is bit for bit)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


def test_vmap_rule_nests():
    """A vmap inside a vmap folds twice: the rule calls the entry, which
    meets the outer level's batched tensor and folds again."""
    rng = np.random.default_rng(13)
    co = _coeffs([900.0])
    x = torch.tensor(rng.standard_normal((2, V, 64, 1)), dtype=torch.float32)
    got = torch.func.vmap(torch.func.vmap(
        lambda xx: K.sosfilt_timeline(co, xx)))(x)
    want = torch.stack([torch.stack([K.sosfilt_timeline(co, x[i, v])
                                     for v in range(V)]) for i in range(2)])
    assert torch.equal(got, want)


#: the batch entry's output layout: (channels a voice, rows kept, under
#: vmap) -> the layout its call writes
LAYOUTS = {
    'one_lane': (1, 16, True, 'time_major'),
    'two_lanes': (2, 16, True, 'lane_major'),
    'tail1': (1, 1, True, 'lane_major'),
    'no_vmap': (1, 16, False, 'lane_major'),
}


@pytest.mark.parametrize('case', list(LAYOUTS))
def test_vmap_rule_picks_the_output_layout(case, monkeypatch):
    """The batch entry's rule asks for time-major rows when the fold gives
    one lane a voice and more than one row is kept: a voice's blocks,
    permuted and flattened as ``_batch_compute`` and ``_mega_kernel`` do,
    are then a view of the call's output, not a copy.  Two lanes a voice,
    one row kept (``_sampled_kernel``) or no vmap keep lane-major rows.
    Each gives the bits of separate calls, and ``ROWS_OUT`` counts the one
    call by its layout."""
    ch, tail, vmapped, layout = LAYOUTS[case]
    rng = np.random.default_rng(14)
    B, L = 5, 48
    co = _block_coeffs(rng, B, ch)
    x = torch.tensor(rng.standard_normal((V, L - tail + B * tail, ch)),
                     dtype=torch.float32)

    def blocks(xv):
        xw = xv.unfold(0, L, tail)[:B].permute(2, 0, 1)
        yt = K.sosfilt_batch(co, xw, tail=tail)
        return yt.permute(1, 0, 2).reshape(B * tail, ch)

    want = torch.stack([blocks(x[v]) for v in range(V)])
    outs = []
    run = K._batch_run

    def spy(*a, **k):
        outs.append(run(*a, **k))
        return outs[-1]

    monkeypatch.setattr(K, '_batch_run', spy)
    K.reset_launch_counts()
    got = torch.func.vmap(blocks)(x) if vmapped else blocks(x[0])[None]
    other = ({'time_major', 'lane_major'} - {layout}).pop()
    assert K.ROWS_OUT == {layout: 1, other: 0} and len(outs) == 1
    assert torch.equal(got, want if vmapped else want[:1])
    y = outs[0][0] if vmapped else outs[0]     # the rule asks for zf too
    assert y.shape == (tail, B, V * ch if vmapped else ch)
    assert y.is_contiguous() == (layout == 'lane_major')
    if layout == 'time_major':
        assert y.stride() == (1, tail, B * tail)
        assert got.untyped_storage().data_ptr() == \
            y.untyped_storage().data_ptr()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def _to(obj, device):
    return tuple(a.to(device) for a in obj)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(CASES))
def test_cuda_vmap_rule_one_launch(case, cuda):
    """On the card the rule launches the kernel once for all voices (never
    the plain version) and agrees with the separate launches within 1e-6
    of their scale."""
    rng = np.random.default_rng(11)
    entry, _plain, args, dims, kw = CASES[case](rng)
    args = _to(args, cuda)
    want = _separate(entry, args, dims, kw)
    K.reset_launch_counts()
    got = torch.func.vmap(lambda *a: entry(*a, **kw), in_dims=dims)(*args)
    torch.cuda.synchronize()
    assert sum(K.LAUNCHES.values()) == 1
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-6 * scale
