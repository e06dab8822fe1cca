"""``TorchXP``'s scalar operands: a Python or numpy scalar beside a tensor
takes the tensor's dtype and stays on the host, so it costs no copy onto
the device and no wait for it; a scalar alone is filled on the device.

* Each op that takes a scalar (``where``, ``maximum``, ``minimum``,
  ``arctan2``, ``clip``, ``asarray``) gives numpy's dtype and values for a
  scalar of each kind against a tensor of each dtype, in both operand
  orders, and hands :func:`~signals_tpu_torch.core.xp.to_device` nothing.
* The benchmark's two patches at tiny sizes: the plan hands ``to_device``
  no 0-dim value (the rule of copying each scalar handed it eight), and
  the audio and the gradient of an ``ADSR`` leaf are those of that rule
  bit for bit.
* On the card (``cuda``): the full-size renders are bit for bit those of
  the copying rule, and neither plan nor a fit step's forward makes a
  synchronizing call.
"""

import contextlib

import numpy as np
import pytest
import torch

from signals_tpu_torch.core import xp
from signals_tpu_torch.core.xp import TorchXP

CPU = torch.device('cpu')
X = TorchXP(CPU)

SCALARS = {'float': 2.7, 'int': 2, 'bool': True,
           'np.float32': np.float32(2.7), 'np.float64': np.float64(2.7),
           'ndarray0': np.array(2.7)}
DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
          torch.int32: np.int32, torch.bool: np.bool_}
VALUES = np.array([-3.5, -1.0, 0.0, 0.1, 2.0, 2.7, 3.0])
COND = VALUES > 0.05
FLOATS = (torch.float32, torch.float64)


def _ops():
    """``(op, torch dtype)`` pairs: every dtype each op takes."""
    for op in ('where', 'maximum', 'minimum', 'arctan2', 'clip', 'asarray'):
        for dtype in DTYPES:
            if op == 'arctan2' and dtype not in FLOATS:
                continue
            if op == 'clip' and dtype == torch.bool:
                continue
            yield op, dtype


def _call(ns, op, s, t, scalar_first, cond=None):
    """``op`` on the scalar ``s`` and the array ``t`` in the namespace
    ``ns`` (``TorchXP``, numpy or torch); ``cond`` is ``where``'s."""
    if op == 'where':
        if cond is None:
            cond = COND if ns is np else torch.as_tensor(COND)
        return ns.where(cond, s, t) if scalar_first else ns.where(cond, t, s)
    if op == 'clip':
        return ns.clip(t, s, None) if scalar_first else ns.clip(t, None, s)
    fn = getattr(ns, op)
    return fn(s, t) if scalar_first else fn(t, s)


@contextlib.contextmanager
def spied():
    """The host values handed to ``to_device`` inside the block."""
    seen = []
    real = xp.to_device

    def listed(data, device, dtype=None, **kw):
        if not isinstance(data, torch.Tensor):
            seen.append(np.ndim(data))
        return real(data, device, dtype, **kw)

    xp.to_device = listed
    try:
        yield seen
    finally:
        xp.to_device = real


@pytest.mark.parametrize('kind', sorted(SCALARS))
@pytest.mark.parametrize('op, dtype', list(_ops()))
def test_a_scalar_takes_the_tensors_dtype_and_is_not_copied(op, dtype,
                                                            kind):
    s = SCALARS[kind]
    np_dtype = DTYPES[dtype]
    if op == 'asarray':
        # no partner: a Python float (np.float64 is one) is f32, as in
        # the compiled engines; the scalar is filled, not copied
        want = np.asarray(s, np.float32 if isinstance(s, float) else None)
        for cast in (None, dtype):
            with spied() as seen:
                got = X.asarray(s, cast)
            ref = want if cast is None else want.astype(np_dtype)
            assert seen == [] and got.dim() == 0
            assert got.dtype == torch.from_numpy(ref).dtype
            assert got.item() == ref.item()
        return
    arr = VALUES.astype(np_dtype)
    weak = np.asarray(s).astype(np_dtype)          # the weak-scalar rule
    for scalar_first in (True, False):
        with spied() as seen:
            got = _call(X, op, s, torch.as_tensor(arr), scalar_first)
        want = np.asarray(_call(np, op, weak, arr, scalar_first))
        assert seen == [], (op, kind, dtype, scalar_first)
        assert got.dtype == dtype and want.dtype == np_dtype
        if op == 'arctan2':
            # torch's atan2 and numpy's differ by an ulp: the values are
            # torch's on the scalar filled out to the tensor's shape
            full = torch.as_tensor(np.full_like(arr, weak))
            want = _call(torch, 'atan2', full, torch.as_tensor(arr),
                         scalar_first).numpy()
        np.testing.assert_array_equal(got.numpy(), want)


def test_host_arrays_are_still_copied_and_counted():
    t = torch.zeros(3)
    with spied() as seen:
        X.maximum(np.ones(3, np.float64), t)
        X.asarray([1.0, 2.0])
        X.where(torch.tensor([True, False, True]), np.ones(3), 0.0)
    assert seen == [1, 1, 1]


# -- the lowering of the benchmark's patches -------------------------------


def _old_t(self, x, dtype=None):
    """The rule before: every host value, scalars too, through
    ``to_device``."""
    if not isinstance(x, torch.Tensor):
        x = (xp.to_device(x, self.device, torch.float32)
             if isinstance(x, float)
             else xp.to_device(np.asarray(x), self.device))
    return x if dtype is None else x.to(dtype)


def _old_pair(self, a, b, number=False):
    if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a = xp.to_device(a, b.device, b.dtype)
    elif not isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        b = xp.to_device(b, a.device, a.dtype)
    return _old_t(self, a), _old_t(self, b)


@contextlib.contextmanager
def copying_rule():
    saved = TorchXP._t, TorchXP._pair
    TorchXP._t, TorchXP._pair = _old_t, _old_pair
    try:
        yield
    finally:
        TorchXP._t, TorchXP._pair = saved


SMALL_SCORE = dict(voices=8, score_seconds=4.0, melody_notes=20, chords=5)
CELLS = {'flagship': (dict(voices=4), 16), 'score': (SMALL_SCORE, 32)}


def system(config, device, over, blocks):
    """The benchmark's configuration ``config`` built on ``device`` for
    renders of ``blocks`` (``over`` replaces entries of its file);
    ``(system, blocks)``."""
    from benchmark.lib import harness
    cfg = dict(harness.read_json(harness.BENCH / 'configs'
                                 / f'{config}.json'), **over)
    build = harness.load_file(harness.BENCH / 'configs'
                              / f'{config}.py').build
    return build(cfg, 7, device, {'kind': 'render', 'blocks': blocks}), blocks


def plan_call(p, n, params=None):
    """A render's plan alone, from its params to its mix."""
    if params is None:
        params, _ = p.params()
    return p.render_fn(n)(params, p.init_carry(), 0,
                          p.compiled.host_inputs(0, n))[0]


@pytest.mark.parametrize('config', sorted(CELLS))
def test_a_plan_hands_to_device_no_scalar_and_renders_as_before(config):
    s, n = system(config, CPU, *CELLS[config])
    p = s.poly
    plan_call(p, n)
    params, _ = p.params()
    with spied() as seen:
        mix = plan_call(p, n, params)
    with copying_rule(), spied() as before:
        old = plan_call(p, n, params)
    assert all(d >= 1 for d in seen), seen
    # the ADSR's six, the Nyquist rate and the coupled form's floor
    assert sorted(before) == [0] * 8 + sorted(seen)
    assert torch.equal(mix, old)


def adsr_uid(p):
    from signals_tpu_torch.nodes.env import ADSR
    index = p.compiled.index
    (env,) = [n for n in index.order if isinstance(n, ADSR)]
    return index.info(env).uid


@pytest.mark.parametrize('leaf', ['attack', 'release'])
@pytest.mark.parametrize('config', sorted(CELLS))
def test_an_adsr_leafs_gradient_is_unchanged(config, leaf):
    """The fit's forward (the plan and ``spectral_loss``) and backward
    with respect to an envelope leaf, against the copying rule."""
    from signals_tpu_torch import learn
    s, n = system(config, CPU, *CELLS[config])
    p = s.poly
    target = plan_call(p, n).detach().reshape(-1, 1) * 0.5
    uid = adsr_uid(p)

    def grad():
        params, _ = p.params()
        x = params[uid][leaf] = params[uid][leaf].clone().requires_grad_()
        mix = plan_call(p, n, params)
        value = learn.spectral_loss(mix.reshape(-1, 1), target)
        return torch.autograd.grad(value, x)[0]

    new = grad()
    with copying_rule():
        old = grad()
    assert torch.count_nonzero(new) and torch.equal(new, old)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda', 0)


@contextlib.contextmanager
def no_sync():
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize('config', sorted(CELLS))
def test_full_size_renders_are_those_of_the_copying_rule(card, config):
    s, n = system(config, card, {}, 2584)
    p = s.poly
    mix = p.render(n_blocks=n)[0]
    with copying_rule():
        old = p.render(n_blocks=n)[0]
    assert torch.equal(mix, old)


@pytest.mark.cuda
def test_on_the_card_a_scalar_rides_in_the_kernels_arguments(card):
    """Each case of the rule on the card: no synchronizing call, and the
    values of torch's op with the scalar filled out to the tensor."""
    ns = TorchXP(card)
    cond = torch.as_tensor(COND, device=card)
    for op, dtype in _ops():
        for kind, s in SCALARS.items():
            if op == 'asarray':
                with no_sync():
                    got = ns.asarray(s, dtype)
                assert got.device == card
                assert torch.equal(got.cpu(), X.asarray(s, dtype))
                continue
            t = torch.as_tensor(VALUES.astype(DTYPES[dtype]), device=card)
            full = torch.as_tensor(np.asarray(s)).to(dtype).expand(
                t.shape).to(card)
            for scalar_first in (True, False):
                with no_sync():
                    got = _call(ns, op, s, t, scalar_first, cond)
                want = _call(torch, {'arctan2': 'atan2'}.get(op, op), full,
                             t, scalar_first, cond)
                assert got.dtype == dtype, (op, kind, dtype)
                assert torch.equal(got, want), (op, kind, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('config', sorted(CELLS))
def test_a_plan_makes_no_synchronizing_call(card, config):
    s, n = system(config, card, {}, 2584)
    p = s.poly
    want = plan_call(p, n)
    params, _ = p.params()
    host = p.compiled.host_inputs(0, n)
    carry = p.init_carry()
    plan = p.render_fn(n)
    torch.cuda.synchronize(card)
    with no_sync():
        mix = plan(params, carry, 0, host)[0]
    assert torch.equal(mix, want)


@pytest.mark.cuda
def test_a_fit_steps_forward_makes_no_synchronizing_call(card,
                                                         monkeypatch):
    from benchmark.lib import harness
    from signals_tpu_torch import learn
    cfg = harness.read_json(harness.BENCH / 'configs' / 'score.json')
    traffic = harness.read_json(harness.BENCH / 'traffic' / 'fit_cutoff.json')
    s = harness.load_file(harness.BENCH / 'configs' / 'score.py').build(
        cfg, 7, card, traffic)
    descent = learn.fused_descent
    forwards = []

    def checked(loss_fn, train, **kw):
        def forward(*args):
            forwards.append(1)
            with no_sync():
                return loss_fn(*args)
        return descent(forward, train, **kw)

    args = traffic['learning_rate'], traffic['relative_lr']
    s.fit(1, *args)               # a first call makes the loss's window
    monkeypatch.setattr(learn, 'fused_descent', checked)
    losses = s.fit(2, *args)
    assert len(forwards) == 2 and all(np.isfinite(losses))
