"""paddle_tpu_torch.amp (auto_cast and GradScaler) against the JAX
package's paddle_tpu.amp, on the CPU.

Tolerances: dtypes and shapes equal; products in bfloat16 or float16
within 2^-7 of the output's largest value (one rounding of the output:
XLA and torch sum the products in other orders); fp8 numerics through
bfloat16 the same (the e4m3 quantize-dequantize is bit-exact,
tests/test_torch_fp8.py).

Tests of the reference's that need ``nn.Linear`` or hapi (the float8
Linear, the O2 training journey, the hapi step cache) wait for ``nn``
(ROADMAP Queue 1 step J1); here the same flows run over ``paddle.matmul``
and a duck-typed optimizer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.models import gpt as tgpt

SIZES = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=32, matmul_precision='fp8')


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _name(dt):
    return getattr(dt, 'name', None) or str(dt).replace('torch.', '')


def _xy(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 8).astype('float32'),
            rng.randn(8, 6).astype('float32'))


def _both(fn, *arrays, **amp_kw):
    """fn(P, *tensors) under ``P.amp.auto_cast(**amp_kw)`` in both
    packages -> (port result, reference result)."""
    out = []
    for P in (port, ref):
        ts = [P.to_tensor(a) for a in arrays]
        with P.amp.auto_cast(**amp_kw):
            out.append(fn(P, *ts))
    return out


def _close(got, want, rel=2 ** -7):
    assert _name(got.dtype) == _name(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    g = np.asarray(got.numpy(), 'float32')
    w = np.asarray(want.numpy(), 'float32')
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16', 'float8'])
def test_auto_cast_matmul_matches_the_reference(dtype):
    got, want = _both(lambda P, x, y: P.matmul(x, y), *_xy(), dtype=dtype)
    assert _name(got.dtype) == ('float16' if dtype == 'float16'
                                else 'bfloat16')
    _close(got, want)
    if dtype == 'float8':      # the fp8 grid, not the bf16 product
        x, y = _xy()
        plain = port.matmul(port.to_tensor(x).astype('bfloat16'),
                            port.to_tensor(y).astype('bfloat16'))
        assert not np.array_equal(got.numpy(), plain.numpy())


def test_auto_cast_restores_and_rejects_a_bad_dtype():
    with port.amp.auto_cast(dtype='float8'):
        assert port.amp.amp_state()['fp8']
        assert port.amp.amp_state()['enable']
    assert not port.amp.amp_state()['fp8']
    assert not port.amp.amp_state()['enable']
    x, y = _xy()
    out = port.matmul(port.to_tensor(x), port.to_tensor(y))
    assert out.dtype == port.float32
    for bad in ('int8', 'float64'):
        with pytest.raises(ValueError, match='dtype'):
            with port.amp.auto_cast(dtype=bad):
                pass
    with pytest.raises(ValueError, match='dtype'):
        port.amp.decorate(object(), dtype='int8')


@pytest.mark.parametrize('kw', [
    dict(level='O2'), dict(level='O2', custom_black_list=['matmul']),
    dict(custom_white_list=['add']), dict(enable=False)],
    ids=['O2', 'O2-black-matmul', 'O1-white-add', 'off'])
def test_levels_and_custom_lists_match_the_reference(kw):
    def ops(P, x, y, z):
        return [P.matmul(x, y), P.mm(x, y), P.sum(x), P.mean(z),
                P.cast(x, 'float32'), P.maximum(x, z)]
    x, y = _xy()
    z = np.random.RandomState(1).randn(4, 8).astype('float32')
    got, want = _both(ops, x, y, z, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_lists_see_the_names_of_table_generated_ops():
    """Known, deliberate difference: the lists match the port's
    table-generated ops (``exp``, ``log``, ``add``, ...) by their names,
    as the lists intend. The reference's are all named ``_f``
    (``paddle_tpu/tensor/math.py:30-32``, ``:50-54``), so under O2 it casts
    black-listed ``exp`` and a custom white ``add`` never matches."""
    x = _xy()[0]
    for P, exp_dt, add_dt in ((port, 'float32', 'bfloat16'),
                              (ref, 'bfloat16', 'float32')):
        t = P.to_tensor(x)
        with P.amp.auto_cast(level='O2'):
            assert _name(P.exp(t).dtype) == exp_dt
        with P.amp.auto_cast(custom_white_list=['add']):
            assert _name(P.add(t, t).dtype) == add_dt


def test_float8_grads_flow():
    x, y = _xy()
    xt = port.to_tensor(x, stop_gradient=False)
    with port.amp.auto_cast(dtype='float8'):
        loss = port.matmul(xt, port.to_tensor(y)).astype('float32').sum()
    loss.backward()
    assert xt.grad is not None and xt.grad.dtype == port.float32
    assert np.isfinite(xt.grad.numpy()).all()


def test_amp_signature_folds_custom_lists():
    sigs = {}
    for P in (port, ref):
        assert P.amp._amp_signature() is None
        out = []
        for kw in ({}, dict(custom_black_list=['mean']),
                   dict(custom_white_list=['relu']), dict(dtype='float8'),
                   dict(level='O2', dtype='float16')):
            with P.amp.auto_cast(**kw):
                out.append(P.amp._amp_signature())
        assert len(set(out)) == 5
        sigs[P.__name__] = out
    assert sigs['paddle_tpu_torch'] == sigs['paddle_tpu']


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

class _StubOpt:
    def __init__(self):
        self.steps = 0

    def step(self):
        self.steps += 1


def _fp8_states():
    cfg = tgpt.GPTConfig(**SIZES)
    clean, bad = (tgpt.init_fp8_state(cfg, 'cpu') for _ in range(2))
    bad['blocks']['qkv']['x']['ahist'][0, 0] = float('inf')
    return clean, bad


def test_grad_scaler_skips_step_on_fp8_overflow():
    clean, bad = _fp8_states()
    scaler = port.amp.GradScaler(init_loss_scaling=2. ** 10,
                                 decr_every_n_nan_or_inf=1)
    opt = _StubOpt()
    assert scaler.step_fp8(opt, clean)
    assert opt.steps == 1
    before = scaler.get_loss_scaling()
    assert not scaler.step_fp8(opt, bad)
    assert opt.steps == 1
    assert scaler.get_loss_scaling() < before
    off = port.amp.GradScaler(enable=False)
    assert not off.is_enable() and off.step_fp8(opt, bad)
    assert opt.steps == 2


def test_check_fp8_returns_a_device_bool():
    clean, bad = _fp8_states()
    scaler = port.amp.GradScaler()
    for state, want in ((clean, False), (bad, True)):
        flag = scaler.check_fp8(state)
        assert isinstance(flag, torch.Tensor) and flag.dtype == torch.bool
        assert flag.dim() == 0 and flag.device == state['blocks'][
            'qkv']['x']['ahist'].device
        assert bool(flag) is want


class _SGD:
    """Duck-typed optimizer over port Tensors: ``_parameters`` and
    ``step()``."""

    def __init__(self, params, lr):
        self._parameters, self.lr = params, lr

    def step(self):
        for p in self._parameters:
            p.set_value(p - self.lr * p.grad)

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None


def _quad(seed=0):
    rng = np.random.RandomState(seed)
    w = port.to_tensor(rng.rand(4, 4).astype('float32'), stop_gradient=False)
    x = port.to_tensor(rng.rand(8, 4).astype('float32'))
    return w, x


def test_grad_scaler_skips_step_on_inf_grads():
    w, x = _quad()
    opt = _SGD([w], 0.1)
    scaler = port.amp.GradScaler(init_loss_scaling=1024.0,
                                 decr_every_n_nan_or_inf=1)
    before = w.numpy().copy()
    scaler.scale(port.matmul(x, w).mean()).backward()
    w.grad = torch.full((4, 4), float('inf'))
    scaler.step(opt)
    opt.clear_grad()
    np.testing.assert_array_equal(w.numpy(), before)
    assert scaler.get_loss_scaling() == 512.0


def test_grad_scaler_steps_and_grows_on_finite_grads():
    w, x = _quad()
    opt = _SGD([w], 0.1)
    scaler = port.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                 incr_ratio=2.0)
    before = w.numpy().copy()
    for _ in range(2):
        scaler.scale(port.matmul(x, w).mean()).backward()
        scaler.minimize(opt, None)
        opt.clear_grad()
    assert not np.allclose(w.numpy(), before)
    assert scaler.get_loss_scaling() == 16.0


def test_grad_scaler_unscales_before_apply():
    def train(scaling):
        w, x = _quad(1)
        scaler = port.amp.GradScaler(init_loss_scaling=scaling,
                                     use_dynamic_loss_scaling=False)
        scaler.scale(port.matmul(x, w).mean()).backward()
        scaler.step(_SGD([w], 0.1))
        return w.numpy()
    np.testing.assert_allclose(train(1.0), train(4096.0), rtol=1e-5)


def test_decorate_o2_casts_models_and_passes_optimizers():
    class Model:
        def to(self, dtype):
            self.dtype = dtype

    m, opt = Model(), _StubOpt()
    assert port.amp.decorate(m, opt, level='O2', dtype='float8') == (m, opt)
    assert m.dtype == 'bfloat16'
    assert port.amp.decorate([m], level='O2', dtype='float16') == [m]
    assert m.dtype == 'float16'


def test_fp8_config_round_trips_through_the_reference_config():
    from paddle_tpu.models import gpt as jgpt
    cfg = jgpt.GPTConfig(**SIZES)
    assert tgpt.GPTConfig(**dataclasses.asdict(cfg)).matmul_precision == 'fp8'
