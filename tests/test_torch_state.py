"""Carried state in the port against the JAX package: streaming filters,
delay lines and feedback loops.

Every comparison feeds the same graph (built once per package from the
same numbers) or the same seeded numpy inputs through the JAX function and
its counterpart in the port, on the CPU, at small sizes (F = 256, a few
blocks, at most 8 channels):

* ``tanh_exact`` bit for bit against the JAX package's numpy path;
* the frame loop ``sosfilt_stream_plain`` against
  ``signals_tpu.compiler.filters.sosfilt_stream`` within 1e-5, and the
  batched wrapper with ``zi`` / ``return_state`` against a loop over its
  windows;
* ``CritFilter.mega_step`` (swept cutoffs, one and two sections) against
  block-by-block ``step`` and the JAX render;
* ``feedback.plan_delays`` / ``segment_blocks`` and the plan
  ``render_core`` picks, on the graphs of ``tests/test_feedback.py``;
* the slice as a whole — the FM voice with a feedback delay (bench c5 at
  its ``Mix``), the saturated echo (bench c6), a streaming voice, a
  streaming filter read by a context filter — each against the JAX render
  and the JAX numpy oracle within 1e-5, with the carry continued across a
  split batch, a prime batch with a tail window, a disabled delay, the
  ``Transport`` threading the carry, and ``carry_from_jax`` continuing a
  render that the JAX package began.
"""

import importlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.compiler import compile_node
from signals_tpu_torch.compiler import kernels as K
from signals_tpu_torch.compiler.filters import design_coupled
from signals_tpu_torch.core.xp import NP, TorchXP
from signals_tpu_torch.interop import carry_from_jax
from signals_tpu_torch.runtime import Transport

RATE, F = 44100, 256
TOL = 1e-5
JAX, PORT = 'signals_tpu', 'signals_tpu_torch'


def nodes(pkg):
    return {m: importlib.import_module(f'{pkg}.nodes.{m}')
            for m in ('delay', 'fixed', 'fx', 'osc')}


def fixed(mod, value):
    f = mod['fixed'].Fixed()
    f.get_state().value = np.atleast_2d(np.asarray(value, np.float32))
    return f


def osc(mod, kind, hz, phase=None):
    o = getattr(mod['osc'], kind)()
    o.hertz = fixed(mod, hz)
    if phase is not None:
        o.phase = phase
    return o


def gain(mod, left, amount):
    g = mod['fx'].Gain()
    g.left = left
    g.right = fixed(mod, amount)
    return g


def mix(mod, left, right, amount):
    m = mod['fx'].Mix()
    if left is not None:
        m.left = left
    if right is not None:
        m.right = right
    m.mix = fixed(mod, amount)
    return m


def delay(mod, frames, inp=None, channels=1):
    d = mod['delay'].Delay()
    d.get_state().frames = frames
    d.get_state().channels = channels
    if inp is not None:
        d.input = inp
    return d


def loop(mod, source, frames, on_cycle, amount=0.6):
    """``source -> mix <- on_cycle(delay) ; delay <- mix``: returns (mix,
    delay)."""
    d = delay(mod, frames)
    m = mix(mod, source, on_cycle(d), amount)
    d.input = m
    return m, d


# --- the graphs ---------------------------------------------------------------


def fm_delay(pkg):
    """bench c5 (``bench.py:191-223``) at the ``Mix`` under its ``Spec``."""
    mod = nodes(pkg)
    i3 = gain(mod, osc(mod, 'Sine', 660.0), 1.5)
    i2 = gain(mod, osc(mod, 'Sine', 220.0, i3), 2.0)
    op1 = osc(mod, 'Sine', 110.0, i2)
    return loop(mod, op1, 4 * F, lambda d: gain(mod, d, 0.45))


def saturated_echo(pkg, frames=5 * F + 5):
    """bench c6 (``bench.py:226-253``): a streaming LowPass and a Drive on
    the return of the loop; S_max = 5 here."""
    mod = nodes(pkg)

    def on_cycle(d):
        lp = mod['fx'].LowPass()
        lp.input = d
        lp.cutoff = fixed(mod, 2500.0)
        lp.get_state().streaming = True
        shaper = mod['fx'].Drive()
        shaper.input = gain(mod, lp, 0.55)
        shaper.drive = fixed(mod, 3.0)
        return shaper

    return loop(mod, osc(mod, 'Sawtooth', 110.0), frames, on_cycle)


HZ8 = (110.0 * 2 ** (np.arange(8) / 12.0)).astype(np.float32).reshape(1, 8)


def streaming_voice(pkg, kind='LowPass', swept=False):
    """8 saws through a streaming filter (cutoff fixed, or swept by a 3 Hz
    LFO so that every block has its own coefficients), gain 0.5."""
    mod = nodes(pkg)
    fx = mod['fx']
    filt = getattr(fx, kind)()
    filt.input = osc(mod, 'Sawtooth', HZ8)
    filt.get_state().streaming = True

    def crit(center, depth):
        if not swept:
            return fixed(mod, center)
        return mix(mod, gain(mod, osc(mod, 'Sine', 3.0), depth),
                   fixed(mod, 2 * center), 0.5)

    if kind == 'LowPass':
        filt.cutoff = crit(1500.0, 900.0)
    else:
        filt.low = crit(400.0, 200.0)
        filt.high = fixed(mod, 3000.0)
    return gain(mod, filt, 0.5), filt


def streaming_into_context(pkg):
    """8 saws -> streaming LowPass 1800 Hz -> context LowPass 900 Hz with a
    384-frame context (one and a half blocks of the streaming filter's
    output history)."""
    mod = nodes(pkg)
    root, filt = streaming_voice(pkg)
    filt.cutoff = fixed(mod, 1800.0)
    lp = mod['fx'].LowPass()
    lp.input = filt
    lp.cutoff = fixed(mod, 900.0)
    lp.get_state().context = 384
    return lp, filt


GRAPHS = {
    'fm_delay': (fm_delay, 1, 'delay_mega'),
    'saturated_echo': (saturated_echo, 1, 'segment_scan'),
    'streaming_voice': (streaming_voice, 8, 'mega'),
    'streaming_into_context': (streaming_into_context, 8, 'mega'),
}


def pull_oracle(pkg, root, n, channels):
    core = importlib.import_module(f'{pkg}.core')
    return np.concatenate([np.broadcast_to(root.respond(core.Request(
        requestor=None, port='test',
        loc=core.BlockLoc(position=i * F, rate=RATE,
                          shape=core.Shape(F, channels)))), (F, channels))
        for i in range(n)])


def jax_compile(root, channels):
    import signals_tpu.compiler as C
    C._compile_cache.clear()
    return C.compile_node(root, block_frames=F, rate=RATE, channels=channels)


def port_compile(root, channels):
    return compile_node(root, block_frames=F, rate=RATE, channels=channels,
                        device='cpu')


# --- the pieces ---------------------------------------------------------------


@pytest.mark.parametrize('engine', ['numpy', 'torch'])
def test_tanh_exact_bit_exact(engine):
    from signals_tpu.core.mathx import tanh_exact as want_fn
    from signals_tpu_torch.core.mathx import tanh_exact
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(100_000) * 3, rng.standard_normal(2000) * 1e-6,
        rng.uniform(-12, 12, 20_000),
        [0.0, -0.0, 5e-7, -5e-7, 10.0, -10.0, 10.5, 30.0, -50.0, 1e-30]
    ]).astype(np.float32)
    want = want_fn(np, x)
    if engine == 'numpy':
        got = tanh_exact(NP, x)
    else:
        got = tanh_exact(TorchXP('cpu'), torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.abs(got - np.tanh(x.astype(np.float64))).max() < 1e-7


def stream_case(rng, nsec, n, ch):
    lo = rng.uniform(200.0, 2000.0, (1, ch)).astype(np.float32)
    crits = (lo,) if nsec == 1 else (lo, lo * 4)
    co = design_coupled(NP, 'lp' if nsec == 1 else 'bp', crits,
                        np.float32(RATE / 2))
    x = rng.standard_normal((n, ch)).astype(np.float32)
    zi = rng.standard_normal((nsec, 2, ch)).astype(np.float32)
    return co, x, zi


@pytest.mark.parametrize('nsec,n,ch', [(1, 256, 1), (1, 300, 8), (2, 256, 3)])
def test_stream_plain_matches_jax(nsec, n, ch):
    from signals_tpu.compiler.filters import sosfilt_stream as jax_stream
    co, x, zi = stream_case(np.random.default_rng(nsec + ch), nsec, n, ch)
    want_y, want_zf = (np.asarray(a) for a in jax_stream(co, x, zi))
    t = torch.as_tensor
    got_y, got_zf = K.sosfilt_stream_plain(t(co), t(x), t(zi))
    assert np.abs(got_y.numpy() - want_y).max() <= TOL
    assert np.abs(got_zf.numpy() - want_zf).max() <= TOL
    # the wrapper on CPU tensors is the plain version; two calls over the
    # halves of the window continue one another bit for bit in the loop
    y, zf = K.sosfilt_stream(t(co), t(x), t(zi))
    assert torch.equal(y, got_y) and torch.equal(zf, got_zf)
    ya, za = K.sosfilt_stream(t(co), t(x[:100]), t(zi))
    yb, zb = K.sosfilt_stream(t(co), t(x[100:]), za)
    assert torch.equal(torch.cat([ya, yb]), y) and torch.equal(zb, zf)


@pytest.mark.parametrize('with_zi', [False, True], ids=['zero', 'zi'])
def test_batch_state_matches_window_loop(with_zi):
    """``sosfilt_batch(..., zi, return_state=True)`` equals
    ``sosfilt_stream`` over each window; without ``zi`` and the state it is
    the zero-state call it was."""
    rng = np.random.default_rng(5)
    B, nsec, ch, L, tail = 4, 2, 3, 200, 150
    cos, xs, zis = zip(*(stream_case(rng, nsec, L, ch) for _ in range(B)))
    t = torch.as_tensor
    co, x, zi = t(np.stack(cos)), t(np.stack(xs, axis=1)), t(np.stack(zis))
    y, zf = K.sosfilt_batch(co, x, tail=tail, zi=zi if with_zi else None,
                            return_state=True)
    assert y.shape == (tail, B, ch) and zf.shape == (B, nsec, 2, ch)
    for b in range(B):
        z0 = zi[b] if with_zi else torch.zeros_like(zi[b])
        wy, wzf = K.sosfilt_stream_plain(co[b], x[:, b], z0)
        assert torch.equal(y[:, b], wy[L - tail:])
        assert torch.equal(zf[b], wzf)
    if not with_zi:
        assert torch.equal(y, K.sosfilt_batch(co, x, tail=tail))


def test_state_wrappers_reject_bad_state():
    rng = np.random.default_rng(6)
    co, x, zi = (torch.as_tensor(a) for a in stream_case(rng, 2, 64, 3))
    with pytest.raises(ValueError, match='zi'):
        K.sosfilt_stream(co, x, zi[:1])                 # one section short
    with pytest.raises(ValueError, match='zi'):
        K.sosfilt_stream(co, x, zi.double())
    with pytest.raises(ValueError, match='zi'):
        K.sosfilt_batch(co[None], x[:, None], zi=zi)    # no window axis
    # a narrower state broadcasts over the channels
    y, zf = K.sosfilt_stream(co, x, zi[:, :, :1])
    assert y.shape == (64, 3) and zf.shape == (2, 2, 3)


@pytest.mark.parametrize('kind', ['LowPass', 'BandPass'])
def test_mega_step_matches_steps_and_jax(kind):
    """A swept streaming filter over 6 blocks as one window
    (``mega_step``: one batched launch per section, the scan of the
    blocks' state maps, the f64 correction) against block-by-block
    ``step`` and against the JAX package's ``mega_step``; the end state
    too."""
    nb = 6
    jc = jax_compile(streaming_voice(JAX, kind, swept=True)[0], 8)
    assert jc._use_mega
    want, jcarry = jc.render(n_blocks=nb, deliver_taps=False)
    root, filt = streaming_voice(PORT, kind, swept=True)
    compiled = port_compile(root, 8)
    assert compiled.plan(nb) == 'mega' and filt.supports_mega_step
    calls = []
    batch = K.sosfilt_batch

    def spy(*args, **kw):
        calls.append((args[1].shape, kw.get('return_state')))
        return batch(*args, **kw)

    K.sosfilt_batch = spy
    try:
        got, carry = compiled.render(n_blocks=nb)
    finally:
        K.sosfilt_batch = batch
    # one launch per section over nb windows of F rows, with the state
    assert calls == [((F, nb, 8), True)] * filt.n_sections
    params = compiled.params()
    c, blocks = compiled.carry0, []
    for i in range(nb):
        block, c = compiled.step(params, c, i * F)
        blocks.append(block)
    steps = torch.cat(blocks)
    uid = compiled.index.info(filt).uid
    assert float((got - steps).abs().max()) <= TOL
    assert float((carry[uid]['zi'] - c[uid]['zi']).abs().max()) <= TOL
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert np.abs(carry[uid]['zi'].numpy()
                  - np.asarray(jcarry[uid]['zi'])).max() <= TOL
    assert float(got.abs().max()) > 0.1


def test_mega_step_static_cutoff_is_one_stream_call():
    """With fixed crits every block has the same coefficients, so the
    window is ONE run of the carried-state cascade (no batched launch, no
    scan): the same audio and end state as block-by-block ``step``."""
    nb = 6
    root, filt = streaming_voice(PORT, 'BandPass')
    compiled = port_compile(root, 8)
    calls = []
    stream, batch = K.sosfilt_stream, K.sosfilt_batch

    def spy(coeffs, x, zi):
        calls.append(tuple(x.shape))
        return stream(coeffs, x, zi)

    K.sosfilt_stream = spy
    K.sosfilt_batch = None              # must not be reached
    try:
        got, carry = compiled.render(n_blocks=nb)
        assert calls == [(nb * F, 8)]
        params, c, blocks = compiled.params(), compiled.carry0, []
        for i in range(nb):
            block, c = compiled.step(params, c, i * F)
            blocks.append(block)
        assert calls[1:] == [(F, 8)] * nb
    finally:
        K.sosfilt_stream, K.sosfilt_batch = stream, batch
    uid = compiled.index.info(filt).uid
    # the frame loop cut at other rows: the same bits
    assert torch.equal(got, torch.cat(blocks))
    assert torch.equal(carry[uid]['zi'], c[uid]['zi'])


# --- feedback analysis on the graphs of tests/test_feedback.py ----------------


def fb_affine(pkg):
    mod = nodes(pkg)
    return loop(mod, osc(mod, 'Sine', 110.0), 3 * F + 17,
                lambda d: gain(mod, d, 0.45))[0]


def fb_ringmod(pkg):
    mod = nodes(pkg)

    def on_cycle(d):
        rm = mod['fx'].RingMod()
        rm.left = d
        rm.right = osc(mod, 'Sine', 2.0)
        return rm

    return loop(mod, osc(mod, 'Sine', 220.0), 2 * F, on_cycle, 0.5)[0]


def fb_chain(pkg):
    mod = nodes(pkg)
    d1 = delay(mod, F, osc(mod, 'Sine', 110.0))
    d2 = delay(mod, 2 * F, d1)
    return mix(mod, d1, d2, 0.5)


def fb_nonlinear(pkg, frames=5 * F + 17):
    mod = nodes(pkg)

    def on_cycle(d):
        shaper = mod['fx'].Drive()
        shaper.input = gain(mod, d, 0.6)
        shaper.drive = fixed(mod, 2.5)
        return shaper

    return loop(mod, osc(mod, 'Sine', 110.0), frames, on_cycle, 0.55)[0]


def fb_coupled(pkg):
    mod = nodes(pkg)
    dA, dB = delay(mod, 4 * F), delay(mod, 6 * F + 3)
    dA.input = mix(mod, osc(mod, 'Sine', 220.0), gain(mod, dB, 0.5), 0.5)
    dB.input = gain(mod, dA, 0.55)
    return mix(mod, dA, dB, 0.5)


def fb_short(pkg):
    return fb_nonlinear(pkg, frames=F)


def fb_block_rate_on_cycle(pkg):
    mod = nodes(pkg)

    def on_cycle(d):
        g = mod['fx'].Gain()
        g.left = osc(mod, 'Sine', 110.0)
        g.right = d                     # block-rate port on the cycle
        return g

    return loop(mod, osc(mod, 'Sine', 110.0), 2 * F, on_cycle, 0.5)[0]


FEEDBACK = {
    'affine_loop': (fb_affine, 'delay_mega'),
    'ringmod_on_cycle': (fb_ringmod, 'delay_mega'),
    'delay_chain': (fb_chain, 'delay_mega'),
    'nonlinear': (fb_nonlinear, 'segment_scan'),
    'coupled_pair': (fb_coupled, 'segment_scan'),
    'short_delay': (fb_short, 'blocks'),
    'block_rate_on_cycle': (fb_block_rate_on_cycle, 'segment_scan'),
}


@pytest.mark.parametrize('case', list(FEEDBACK))
def test_feedback_plans_match_jax(case):
    from signals_tpu.compiler import feedback as jax_feedback
    from signals_tpu_torch.compiler import feedback
    build, plan_name = FEEDBACK[case]
    n = 12
    jc = jax_compile(build(JAX), 1)
    compiled = port_compile(build(PORT), 1)

    def summary(fb, index):
        plan = fb.plan_delays(index, F, RATE)
        return (None if plan is None else
                ([index.info(d).uid for d in plan.order],
                 {index.info(d).uid: plan.cyclic[id(d)] for d in plan.order}),
                fb.segment_blocks(index, F, RATE))

    want = summary(jax_feedback, jc.index)
    assert summary(feedback, compiled.index) == want
    # render_core picks among its plans where the JAX package does
    jax_plan = ('delay_mega' if jc.delay_mega_plan() is not None else
                'segment_scan' if jc.segment_scan_core(n) is not None
                else 'blocks')
    assert not jc._use_mega and not compiled._use_mega
    assert compiled.plan(n) == jax_plan == plan_name
    assert compiled.plan(1) == 'blocks'
    # and every plan renders what the per-block loop renders
    fast, _ = compiled.render(n_blocks=n)
    slow = port_compile(build(PORT), 1)
    slow.enable_mega = False
    assert slow.plan(n) == 'blocks'
    assert float((fast - slow.render(n_blocks=n)[0]).abs().max()) <= 1e-6
    want_audio, _ = jc.render(n_blocks=n, deliver_taps=False)
    assert np.abs(fast.numpy() - np.asarray(want_audio)).max() <= TOL


# --- the slice as a whole -----------------------------------------------------


@pytest.fixture(scope='module', params=list(GRAPHS))
def slice_ref(request):
    """(name, JAX render of 13 blocks, its carry after 7 blocks, the JAX
    oracle)."""
    build, channels, _ = GRAPHS[request.param]
    jc = jax_compile(build(JAX)[0], channels)
    full, _ = jc.render(n_blocks=13, deliver_taps=False)
    _, mid = jc.render(n_blocks=7, deliver_taps=False)
    mid = {u: {k: np.asarray(v) for k, v in c.items()}
           for u, c in mid.items()}
    oracle = pull_oracle(JAX, build(JAX)[0], 13, channels)
    return request.param, np.asarray(full), mid, oracle


@pytest.mark.parametrize('how', ['whole', 'split', 'from_jax_carry',
                                 'transport'])
def test_slice_matches_jax_render_and_oracle(slice_ref, how):
    """13 blocks (a prime batch: the saturated echo runs two 5-block
    segments and a 3-block tail window) as one render, as 7 + 6 with the
    carry passed on, as the last 6 continued from the JAX package's carry
    after 7, and as ``Transport`` batches of 5, 5 and 3."""
    name, jax_audio, jax_mid, oracle = slice_ref
    build, channels, plan = GRAPHS[name]
    compiled = port_compile(build(PORT)[0], channels)
    assert compiled.plan(13) == plan and compiled.carry0
    lo = 0
    if how == 'whole':
        got, carry = compiled.render(n_blocks=13)
        assert carry.keys() == compiled.carry0.keys()
    elif how == 'split':
        a, carry = compiled.render(n_blocks=7)
        b, _ = compiled.render(position=7 * F, n_blocks=6, carry=carry)
        got = torch.cat([a, b])
    elif how == 'from_jax_carry':
        carry = carry_from_jax(jax_mid, 'cpu')
        mine = compiled.render(n_blocks=7)[1]
        assert carry.keys() == mine.keys()
        for uid in mine:                       # one layout, the same state
            assert carry[uid].keys() == mine[uid].keys()
            for k, v in mine[uid].items():
                assert carry[uid][k].shape == v.shape
                assert float((carry[uid][k] - v).abs().max()) <= TOL
        got, _ = compiled.render(position=7 * F, n_blocks=6, carry=carry)
        lo = 7 * F
    else:
        tr = Transport(compiled, consumer=None, blocks_per_call=5)
        got = torch.as_tensor(np.concatenate(
            [tr.render(5), tr.render(5), tr.render(3)]))
        assert tr.position == 13 * F
        tr.seek(0)                              # a seek starts from carry0
        assert float((torch.as_tensor(tr.render(5)) - got[:5 * F])
                     .abs().max()) == 0.0
    got = got.numpy()
    assert got.shape == jax_audio[lo:].shape and np.isfinite(got).all()
    assert np.abs(got - jax_audio[lo:]).max() <= TOL
    assert np.abs(got - oracle[lo:]).max() <= TOL
    assert np.abs(oracle).max() > 0.1


def test_port_oracle_matches_jax_oracle():
    """The port's own numpy pull engine renders feedback (``Delay``'s
    cycle-safe evaluation, ``Drive``, the streaming filter) bit for bit as
    the JAX package's."""
    for build, channels, _ in GRAPHS.values():
        want = pull_oracle(JAX, build(JAX)[0], 9, channels)
        got = pull_oracle(PORT, build(PORT)[0], 9, channels)
        assert np.array_equal(got, want)


def test_disabled_delay_outputs_dry():
    root, d = fm_delay(PORT)
    d.get_state().enabled = False
    jroot, jd = fm_delay(JAX)
    jd.get_state().enabled = False
    want, _ = jax_compile(jroot, 1).render(n_blocks=9, deliver_taps=False)
    compiled = port_compile(root, 1)
    got, carry = compiled.render(n_blocks=9)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    # the disabled delay is silent but its line still advances
    uid = compiled.index.info(d).uid
    assert float((carry[uid]['buf'] - got[-4 * F:]).abs().max()) == 0.0
    d.get_state().enabled = True
    wet, _ = compiled.render(n_blocks=9)
    assert float((wet - got).abs().max()) > 0.01


def test_one_block_tail_window():
    """11 blocks at S_max = 5: two 5-block segments and a tail window of
    ONE block, which a streaming filter takes through ``step`` (its
    ``mega_step`` needs a window of several blocks)."""
    compiled = port_compile(saturated_echo(PORT)[0], 1)
    assert compiled.plan(11) == 'segment_scan'
    got, _ = compiled.render(n_blocks=11)
    want = pull_oracle(JAX, saturated_echo(JAX)[0], 11, 1)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_history_sizes_and_refusals():
    """The collect pass sizes the rings as the JAX package does: a context
    reader gives the streaming filter a ``hist`` ring of its lookback.  A
    swept-cutoff filter with carry segments downstream of carried state is
    no longer refused: the delay line keeps the segment's lookback and the
    render agrees with the JAX package's."""
    root, filt = streaming_into_context(PORT)
    compiled = port_compile(root, 8)
    jc = jax_compile(streaming_into_context(JAX)[0], 8)
    uid = compiled.index.info(filt).uid
    assert {k: tuple(v.shape) for k, v in compiled.carry0[uid].items()} \
        == {k: np.asarray(v).shape for k, v in jc.carry0[uid].items()} \
        == {'zi': (1, 2, 8), 'hist': (384, 8)}

    def swept_after_delay(pkg):
        mod = nodes(pkg)
        swept = mod['fx'].LowPass()
        swept.input = delay(mod, 4 * 1024, osc(mod, 'Sine', 110.0))
        swept.cutoff = gain(mod, osc(mod, 'Sine', 1.0), 900.0)
        return swept

    import signals_tpu.compiler as C
    C._compile_cache.clear()
    want, _ = C.compile_node(swept_after_delay(JAX), block_frames=1024,
                             rate=RATE, channels=1).render(n_blocks=10)
    swept = swept_after_delay(PORT)
    got, _ = compile_node(swept, block_frames=1024, rate=RATE, channels=1,
                          device='cpu').render(n_blocks=10)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    swept.get_state().carry = 1                 # per-block replay: fine
    compile_node(swept, block_frames=1024, rate=RATE, channels=1,
                 device='cpu')


def test_polypatch_threads_a_carry():
    """Eight streaming voices through ``PolyPatch``: the carry comes back
    and continues the render."""
    from signals_tpu_torch.parallel import PolyPatch
    mod = nodes(PORT)
    hz = fixed(mod, 110.0)
    saw = mod['osc'].Sawtooth()
    saw.hertz = hz
    lp = mod['fx'].LowPass()
    lp.input = saw
    lp.cutoff = fixed(mod, 1500.0)
    lp.get_state().streaming = True
    poly = PolyPatch(gain(mod, lp, 0.125), n_voices=8,
                     overrides={(hz, 'value'): HZ8.reshape(8)},
                     block_frames=F, rate=RATE, device='cpu')
    whole, _ = poly.render(n_blocks=8)
    a, carry = poly.render(n_blocks=3)
    b, _ = poly.render(position=3 * F, n_blocks=5, carry=carry)
    assert carry and whole.shape == (8 * F, 1)
    assert float((torch.cat([a, b]) - whole).abs().max()) <= 1e-6
    restart, _ = poly.render(position=3 * F, n_blocks=5)
    assert float((restart - b).abs().max()) > 1e-3   # the state matters
