"""The port's public names against the JAX package's.

Every module of ``signals_tpu`` has a module of the same path in
``signals_tpu_torch`` (``compiler.pallas_kernels``: ``compiler.kernels``),
and each class and function a JAX module defines under a public name is
there too, unless ``OMITTED`` lists it with its reason (ROADMAP §A, "left
out by design").  The one ``__all__`` of the JAX package (``graph``) is
held whole.  ``graph.RequestRate`` and ``Emitter.rate`` give the JAX
package's values after pull requests of one frame and of more.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import signals_tpu
import signals_tpu_torch

#: JAX module -> {public name it defines: why the port has none}
OMITTED = {
    'signals_tpu.compiler.filters': {
        'default_backend': 'the JAX platform probe; the port takes a torch '
                           'device',
        'platform_override': 'the JAX platform pin (interpret-mode plans)',
        'design_sos': 'the 6-column SOS form, left out with FILTER_IMPL',
        'sosfilt_chunked': 'a FILTER_IMPL mode, left out by design',
        'resolve_mega_impl': "the FILTER_IMPL / MEGA_FILTER_IMPL modes' "
                             'resolver, left out with them',
        'sosfilt_tv': 'the associative-scan engine of those modes; swept '
                      'crits run the segment kernels (K1 / K2)',
    },
    'signals_tpu.core.mathx': {
        'sin2pi_f32': 'the f32 sine of the Mosaic generator kernel; the '
                      'CUDA generator keeps the f64 sin2pi',
    },
    'signals_tpu.runtime.codecs': {
        'ima_encode_jax': 'the lax.scan encoder; its device form is '
                          'ima_encode (csrc/codecs.cu)',
        'slac_encode_jax': 'a scan; the device half is tensor ops '
                           '(slac_encode)',
        'slac2_encode_jax': 'a scan; the device half is tensor ops '
                            '(slac2_encode)',
    },
    'signals_tpu.utils': {
        'enable_persistent_compile_cache': "JAX's compile cache: PyTorch "
                                           'runs eagerly',
    },
    'signals_tpu.compiler.pallas_kernels': {
        'pl_ds': 'a Pallas slice helper',
    },
}

#: a JAX module whose counterpart has another path, and its renamed names
MOVED = {'signals_tpu.compiler.pallas_kernels': (
    'signals_tpu_torch.compiler.kernels',
    {'sosfilt_pallas': 'sosfilt_timeline'})}


def jax_modules():
    return ['signals_tpu'] + sorted(
        m.name for m in pkgutil.walk_packages(signals_tpu.__path__,
                                              'signals_tpu.'))


def defined_names(mod):
    """The public classes and functions ``mod`` defines itself."""
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith('_')
                  and (inspect.isclass(v) or inspect.isfunction(v))
                  and getattr(v, '__module__', None) == mod.__name__)


@pytest.mark.parametrize('jax_name', jax_modules())
def test_public_names_match_the_jax_package(jax_name):
    jmod = importlib.import_module(jax_name)
    port_name, renamed = MOVED.get(
        jax_name, ('signals_tpu_torch' + jax_name[len('signals_tpu'):], {}))
    pmod = importlib.import_module(port_name)
    omitted = OMITTED.get(jax_name, {})
    names = defined_names(jmod)
    for name in omitted:
        assert name in names, f'{jax_name}.{name} is listed but not defined'
    missing = [n for n in names if n not in omitted
               and not hasattr(pmod, renamed.get(n, n))]
    assert not missing, f'{port_name} lacks {missing}'
    present = [n for n in omitted if hasattr(pmod, n)]
    assert not present, f'{port_name} has {present}: take them off OMITTED'
    port_all = getattr(pmod, '__all__', None)
    for name in getattr(jmod, '__all__', ()):
        assert port_all is not None and name in port_all, \
            f'{port_name}.__all__ lacks {name!r}'
        assert hasattr(pmod, name), name


def test_every_jax_all_is_checked():
    """``graph`` holds the JAX package's only ``__all__``."""
    with_all = [m for m in jax_modules()
                if hasattr(importlib.import_module(m), '__all__')]
    assert with_all == ['signals_tpu.graph']
    from signals_tpu import graph as jg
    from signals_tpu_torch import graph as tg
    assert set(jg.__all__) <= set(tg.__all__)
    assert 'RequestRate' in tg.__all__


def pull(pkg, frames):
    """A ``Sine`` of ``pkg`` answering one pull request of ``frames``
    frames, and its ``rate`` before and after."""
    core = importlib.import_module(f'{pkg}.core')
    osc = importlib.import_module(f'{pkg}.nodes.osc')
    fixed = importlib.import_module(f'{pkg}.nodes.fixed')
    hz = fixed.Fixed()
    hz.get_state().value = np.array([[220.0]], np.float32)
    node = osc.Sine()
    node.hertz = hz
    before = node.rate
    loc = core.BlockLoc(position=0, rate=44100,
                        shape=core.Shape(frames=frames, channels=1))
    node.respond(core.Request(requestor=None, port='test', loc=loc))
    return before, node.rate


@pytest.mark.parametrize('frames', [1, 2, 512])
def test_request_rate_matches_the_jax_package(frames):
    """Before any request ``UNKNOWN``; after a request of one frame
    ``BLOCK``, of more ``FRAME`` (the reference's mapping), in both
    packages, with the same members."""
    from signals_tpu.graph import RequestRate as JaxRate
    from signals_tpu_torch.graph import Emitter, RequestRate
    assert [(m.name, m.value) for m in RequestRate] == \
        [(m.name, m.value) for m in JaxRate]
    assert isinstance(Emitter.rate, property)
    want = [r.name for r in pull('signals_tpu', frames)]
    got = [r.name for r in pull('signals_tpu_torch', frames)]
    assert got == want == ['UNKNOWN', 'BLOCK' if frames == 1 else 'FRAME']
    assert isinstance(pull('signals_tpu_torch', frames)[1], RequestRate)


def test_port_package_lists_only_modules_of_the_jax_package():
    """The port adds no module path the JAX package lacks, beyond its own
    helpers (the build, the device-neutral array namespace, the interop
    with JAX values, the native ring and the kernels)."""
    own = {'signals_tpu_torch.compiler._build', 'signals_tpu_torch.core.xp',
           'signals_tpu_torch.interop', 'signals_tpu_torch.runtime.ring',
           'signals_tpu_torch.compiler.kernels',
           'signals_tpu_torch.runtime.native',
           'signals_tpu_torch.entry'}
    jax_paths = {'signals_tpu_torch' + m[len('signals_tpu'):]
                 for m in jax_modules()}
    for m in pkgutil.walk_packages(signals_tpu_torch.__path__,
                                   'signals_tpu_torch.'):
        assert m.name in jax_paths or m.name in own, m.name
