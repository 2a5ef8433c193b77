"""The eager API surface of paddle_tpu_torch against the JAX package's:
every public callable of ``paddle_tpu.tensor`` and every public attribute
of its Tensor has a counterpart (only the listed deferrals raise, citing
their ROADMAP item; fft and signal are ported), the device rule, and the
dtype canonicalization."""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.tensor as ref_tensor
import paddle_tpu_torch as port
import paddle_tpu_torch.tensor as port_tensor
from paddle_tpu_torch import device as port_device

# name -> (the ROADMAP item its NotImplementedError cites, a call)
DEFERRED = {
    'create_array': ('item 12', lambda f: f('float32')),
    'array_read': ('item 12', lambda f: f([], 0)),
    'array_write': ('item 12', lambda f: f(port.to_tensor([1.0]), 0)),
    'array_length': ('item 12', lambda f: f([])),
}
# ported with step I's rest (ROADMAP Queue 1 item 6): module -> the call
# of each public name on a float32 signal that does not take it alone
# (istft takes stft's result)
PORTED_MODULES = {'fft': {'fftfreq': lambda f, x: f(8),
                          'rfftfreq': lambda f, x: f(8)},
                  'signal': {'frame': lambda f, x: f(x, 4, 2),
                             'overlap_add': lambda f, x: f(
                                 x.reshape([4, 4]), 2),
                             'stft': lambda f, x: f(x, 8)}}


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _public_callables(mod):
    return sorted(n for n in dir(mod) if not n.startswith('_')
                  and callable(getattr(mod, n))
                  and not inspect.ismodule(getattr(mod, n)))


def test_every_public_callable_of_the_namespace_has_a_counterpart():
    names = _public_callables(ref_tensor)
    assert len(names) >= 279
    missing = [n for n in names if not callable(getattr(port_tensor, n,
                                                        None))]
    assert missing == []
    top = [n for n in names if not callable(getattr(port, n, None))]
    assert top == []


@pytest.mark.parametrize('name', sorted(DEFERRED))
def test_only_the_listed_deferrals_raise(name):
    item, call = DEFERRED[name]
    with pytest.raises(NotImplementedError, match=item):
        call(getattr(port_tensor, name))


@pytest.mark.parametrize('module', sorted(PORTED_MODULES))
def test_fft_and_signal_names_all_defer(module):
    """Ported with step I's rest (ROADMAP Queue 1 item 6; the name is the
    deferral test's): every public name of the reference's fft / signal
    module has a counterpart that runs, with the reference's shape and
    dtype."""
    ref_mod, port_mod = getattr(ref, module), getattr(port, module)
    names = [n for n in _public_callables(ref_mod)
             if getattr(getattr(ref_mod, n), '__module__', '').endswith(
                 module)]
    assert len(names) == {'fft': 16, 'signal': 4}[module]
    a = np.random.RandomState(1).rand(16).astype('float32')
    if module == 'fft':         # fft2 and friends want two axes
        a = a.reshape(4, 4)
    for n in names:
        call = PORTED_MODULES[module].get(n, lambda f, x: f(x))
        if n == 'istft':
            got = port_mod.istft(port_mod.stft(port.to_tensor(a), 8), 8)
            want = ref_mod.istft(ref_mod.stft(ref.to_tensor(a), 8), 8)
        else:
            got = call(getattr(port_mod, n), port.to_tensor(a))
            want = call(getattr(ref_mod, n), ref.to_tensor(a))
        assert got.shape == list(want.shape), n
        assert str(got.dtype).replace('torch.', '') == str(
            want.dtype).replace('paddle_tpu.', ''), n


def test_create_parameter_waits_for_item_7():
    """Ported with nn (ROADMAP Queue 1 item 7, step J1): a trainable
    Parameter as the reference's, zeros for a bias."""
    w = port.create_parameter([2, 3], name='w')
    r = ref.create_parameter([2, 3])
    assert isinstance(w, port.nn.Parameter) and w.shape == r.shape
    assert w.dtype == port.float32 and not w.stop_gradient and w.name == 'w'
    assert w._value.is_leaf
    b = port.create_parameter([3], is_bias=True)
    np.testing.assert_array_equal(b.numpy(), ref.create_parameter(
        [3], is_bias=True).numpy())


def test_every_public_tensor_attribute_has_a_counterpart():
    r = ref.to_tensor(np.ones((2, 2), 'float32'))
    t = port.to_tensor(np.ones((2, 2), 'float32'))
    want = {n for n in dir(r) if not n.startswith('_')}
    assert len(want) >= 262
    assert sorted(want - {n for n in dir(t) if not n.startswith('_')}) == []
    assert not isinstance(t, torch.Tensor)       # wraps, does not subclass
    assert t.shape == [2, 2] and t.size == 4 and t.ndim == 2


def test_the_top_level_exports():
    for name in ('Tensor', 'to_tensor', 'no_grad', 'enable_grad', 'seed',
                 'get_rng_state', 'set_rng_state', 'autograd', 'linalg',
                 'set_device', 'get_device', 'grad', 'float32', 'int64',
                 'bfloat16', 'bool', 'add_n', 'set_default_dtype',
                 'get_default_dtype', 'set_grad_enabled', 'in_dygraph_mode',
                 'crop_tensor', 'CPUPlace', 'CUDAPlace', 'device_count',
                 'is_compiled_with_cuda', 'resolve_device'):
        assert hasattr(port, name), name
    assert port.in_dygraph_mode()
    assert port.linalg.inv is port.inverse


def test_creating_a_tensor_without_a_card_raises(monkeypatch):
    """Without set_device('cpu') the device is the card; with none,
    creating a tensor raises. Nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    port_device._current = None
    assert port.get_device() == 'gpu:0'
    for make in (lambda: port.to_tensor([1.0]), lambda: port.ones([2]),
                 lambda: port.rand([2]), lambda: port.arange(3),
                 lambda: port.Tensor(np.ones(2))):
        with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
            make()
    with pytest.raises(RuntimeError, match='CUDA'):
        port.set_device('gpu')
    assert port_device._current is None          # unchanged
    port.set_device('cpu')
    assert port.to_tensor([1.0]).place == port.CPUPlace()
    assert port.get_device() == 'cpu:0'


def test_places_and_the_tpu_refusal():
    assert str(port.CUDAPlace(1)) == 'gpu:1' and str(port.CPUPlace()) == 'cpu'
    for bad in (lambda: port.set_device('tpu'), lambda: port.TPUPlace(0),
                lambda: port.set_device('tpu:0')):
        with pytest.raises(ValueError, match="'gpu'"):
            bad()
    with pytest.raises(ValueError, match="'gpu'"):
        port.set_device('xpu')
    x = port.to_tensor([1.0], place='cpu')
    assert x.place == port.CPUPlace() and 'cpu' in repr(x.place)


def test_set_device_is_restored_by_the_fixture():
    port.set_device(port.CPUPlace())
    assert port.get_device() == 'cpu:0'
    assert port_device._current == port.CPUPlace()


@pytest.mark.parametrize('data,dtype', [
    (np.arange(3, dtype='int64'), None), (np.ones(2), None),
    (np.ones(2, 'complex128'), None), ([1, 2], None), (3, None),
    (2.5, None), ([True], None), (np.ones(2, 'float32'), 'int64'),
    (np.ones(2, 'float32'), 'float64'), (np.ones(2, 'int32'), np.int64),
    (np.ones(2, 'float32'), 'complex128'), (np.ones(2, 'uint8'), None),
])
def test_dtype_canonicalization_matches_the_reference(data, dtype):
    r = ref.to_tensor(data, dtype=dtype)
    t = port.to_tensor(data, dtype=dtype)
    assert str(t.dtype).replace('torch.', '') == np.dtype(r.dtype).name
    assert t.astype('int64').dtype == port.int32
    assert t.cast(port.float64).dtype == port.float32


def test_the_default_dtype_is_recorded_not_set_on_torch():
    before = torch.get_default_dtype()
    try:
        for P in (ref, port):
            P.set_default_dtype('float16')
            assert P.get_default_dtype() == 'float16'
            P.set_default_dtype('float64')
            assert P.get_default_dtype() == 'float32'
        assert torch.get_default_dtype() == before
    finally:
        ref.set_default_dtype('float32')
        port.set_default_dtype('float32')
