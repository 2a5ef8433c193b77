"""fp8 training in the port (paddle_tpu_torch/quantization/fp8.py and the
GPT and MoE train steps at matmul_precision='fp8') against the JAX
package's, on the CPU, at tests/test_precision.py's sizes (vocab 64,
hidden 32, 2 layers, 4 heads, max_seq_len 32, f32).

Tolerances:
- the primitives (quantize_dequantize, compute_scale, update_history,
  qdq_dynamic) bit-exact in both formats: torch's float8 casts round as
  JAX's do, and the arithmetic around them is the same f32 ops;
- fp8_matmul's output, dx, dw and new meta against ``jax.value_and_grad``
  over (x, w, meta): 1e-6 of each tensor's largest value in f32 (the
  products sum in another order), 2^-7 in bf16 (one bf16 rounding);
- the train steps over 2 steps: losses 1e-5 relative; the new fp8 state
  1e-6 of each tensor's largest value; parameters 1e-4 absolute (lr/10:
  Adam moves an element whose gradient is rounding noise by up to lr a
  step either way; measured <= 7.2e-6);
- tests/test_precision.py's fp8 bars, run on the port, as they are there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import moe_gpt as jmoe
from paddle_tpu.quantization import fp8 as jf8
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import moe_gpt as tmoe
from paddle_tpu_torch.quantization import fp8 as tf8

SIZES = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=32, dtype='float32', use_flash=False)
FORMATS = [(jf8.E4M3, tf8.E4M3), (jf8.E5M2, tf8.E5M2)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _wide(seed, *shape):
    """Magnitudes from e^-12 to e^8, with saturating, infinite and zero
    entries."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp(rng.uniform(-12, 8, shape)))
    x = x.astype('float32')
    x.flat[:4] = [1e9, -1e9, np.inf, 0.0]
    return x


# ---------------------------------------------------------------------------
# the primitives, bit for bit
# ---------------------------------------------------------------------------

HISTORIES = {'cold': np.zeros(16, 'float32'),
             'warm': np.array([0, 3.5, 0, 1e3] + [0] * 12, 'float32')}


@pytest.mark.parametrize('fmt', FORMATS, ids=['e4m3', 'e5m2'])
def test_quantize_dequantize_is_bit_exact(fmt):
    jq, tq = fmt
    x = _wide(0, 64, 32)
    for s in (1.0, 0.37, 1e-3, 1e3):
        want = np.asarray(jf8.quantize_dequantize(jnp.asarray(x), jq,
                                                  jnp.float32(s)))
        got = tf8.quantize_dequantize(_t(x), tq, torch.tensor(s)).numpy()
        np.testing.assert_array_equal(got, want)
    # saturation: out-of-range magnitudes land on the format max
    assert np.abs(got).max() == tf8.dtype_max(tq) * 1e3


@pytest.mark.parametrize('fmt', FORMATS, ids=['e4m3', 'e5m2'])
def test_qdq_dynamic_is_bit_exact(fmt):
    jq, tq = fmt
    x = _wide(1, 48, 16)[1:]
    x[0, :3] = [1e9, -1e9, 0.0]
    np.testing.assert_array_equal(tf8.qdq_dynamic(_t(x), tq).numpy(),
                                  np.asarray(jf8.qdq_dynamic(jnp.asarray(x),
                                                             jq)))
    zero = np.zeros((4, 4), 'float32')       # amax 0: scale 1
    np.testing.assert_array_equal(tf8.qdq_dynamic(_t(zero), tq).numpy(), zero)


@pytest.mark.parametrize('hist', sorted(HISTORIES))
@pytest.mark.parametrize('fmt', FORMATS, ids=['e4m3', 'e5m2'])
def test_scale_and_history_are_bit_exact(fmt, hist):
    jq, tq = fmt
    h = HISTORIES[hist]
    x = _wide(2, 16, 8)[1:]
    assert tf8.compute_scale(_t(h), tq).item() == float(
        jf8.compute_scale(jnp.asarray(h), jq))
    np.testing.assert_array_equal(
        tf8.update_history(_t(h), _t(x)).numpy(),
        np.asarray(jf8.update_history(jnp.asarray(h), jnp.asarray(x))))
    assert tf8.compute_scale(_t(HISTORIES['cold']), tq).item() == 1.0


# ---------------------------------------------------------------------------
# fp8_matmul: output, dx, dw and the new meta
# ---------------------------------------------------------------------------

def _meta_leaves(meta):
    return [meta[r][k] for r in ('x', 'w', 'g') for k in ('scale', 'ahist')]


@pytest.mark.parametrize('dt,tol', [('float32', 1e-6), ('bfloat16', 2 ** -7)])
def test_fp8_matmul_matches_value_and_grad(dt, tol):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 32).astype('float32')
    w = (rng.randn(32, 16) * 0.1).astype('float32')
    meta = jf8.init_matmul_meta()
    tdt = getattr(torch, dt)

    def f(xv, wv, m):
        out = jf8.fp8_matmul(xv.astype(dt), wv.astype(dt), m)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    for _ in range(2):       # a cold meta, then a warm one
        (_, jout), (gx, gw, new) = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x),
                                                jnp.asarray(w), meta)
        tm = {r: {k: _t(v).clone().requires_grad_() for k, v in m.items()}
              for r, m in meta.items()}
        tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
        out = tf8.fp8_matmul(tx.to(tdt), tw.to(tdt), tm)
        loss = (out.float() ** 2).sum()
        got = torch.autograd.grad(loss, [tx, tw] + _meta_leaves(tm))
        want = [gx, gw] + _meta_leaves(new)
        assert out.dtype == tdt
        pairs = [(out.float(), jout.astype(jnp.float32))] + list(zip(got,
                                                                     want))
        for a, b in pairs:
            b = np.asarray(b, dtype='float32')
            err = np.abs(a.detach().float().numpy() - b).max()
            assert err <= tol * max(np.abs(b).max(), 1e-30), (err, dt)
        meta = new


def test_fp8_matmul_refuses_other_devices():
    meta = tf8.init_matmul_meta(device='cpu')
    with pytest.raises(ValueError, match='cuda or cpu'):
        tf8.fp8_matmul(torch.ones(2, 2, device='meta'),
                       torch.ones(2, 2, device='meta'), meta)


# ---------------------------------------------------------------------------
# tests/test_precision.py's fp8 bars, on the port
# ---------------------------------------------------------------------------

def _warm_meta(x, w, steps=3):
    meta = tf8.init_matmul_meta(device='cpu')
    for _ in range(steps):
        leaves = [t.requires_grad_() for t in _meta_leaves(meta)]
        loss = (tf8.fp8_matmul(x, w, meta) ** 2).sum()
        new = iter(torch.autograd.grad(loss, leaves))
        meta = {r: {k: next(new) for k in ('scale', 'ahist')}
                for r in ('x', 'w', 'g')}
    return meta


def test_fp8_matmul_forward_error_bound():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(32, 64, generator=g), torch.randn(64, 16, generator=g)
    got = tf8.fp8_matmul(x, w, _warm_meta(x, w))
    err = (got - x @ w).abs().max().item()
    assert 0.0 < err < 0.05 * (x @ w).abs().max().item()


def test_fp8_matmul_backward_matches_f32():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 32, generator=g).requires_grad_()
    w = torch.randn(32, 8, generator=g).requires_grad_()
    meta = _warm_meta(x.detach(), w.detach())
    g8 = torch.autograd.grad((tf8.fp8_matmul(x, w, meta) ** 2).sum(), [x, w])
    g32 = torch.autograd.grad(((x @ w) ** 2).sum(), [x, w])
    for a, b in zip(g8, g32):
        assert ((a - b).abs().max() / b.abs().max()).item() < 0.1


def test_delayed_scaling_amax_history_converges():
    g = torch.Generator().manual_seed(2)
    x = 3.0 * torch.randn(64, 64, generator=g)
    w = torch.randn(64, 64, generator=g)
    meta = tf8.init_matmul_meta(device='cpu')
    assert meta['x']['scale'].item() == 1.0
    for _ in range(4):
        leaves = [t.requires_grad_() for t in _meta_leaves(meta)]
        new = iter(torch.autograd.grad(tf8.fp8_matmul(x, w, meta).sum(),
                                       leaves))
        meta = {r: {k: next(new) for k in ('scale', 'ahist')}
                for r in ('x', 'w', 'g')}
    amax = x.abs().max().item()
    hist = meta['x']['ahist']
    assert hist[0].item() == pytest.approx(amax, rel=1e-5)
    assert int((hist != 0).sum()) == 4
    assert meta['x']['scale'].item() == pytest.approx(amax / tf8.E4M3_MAX,
                                                      rel=1e-5)
    assert meta['g']['scale'].item() == pytest.approx(
        meta['g']['ahist'].max().item() / tf8.E5M2_MAX, rel=1e-5)


def test_found_inf_flags_overflowed_state():
    state = tgpt.init_fp8_state(tgpt.GPTConfig(**SIZES), 'cpu')
    flag = tf8.found_inf(state)
    assert flag.dtype == torch.bool and flag.dim() == 0 and not flag.item()
    state['blocks']['fc']['g']['ahist'][0, 0] = float('inf')
    assert tf8.found_inf(state).item()


# ---------------------------------------------------------------------------
# the GPT and MoE fp8 train steps against the reference's
# ---------------------------------------------------------------------------

MODELS = {'gpt': (jgpt, tgpt, {}), 'moe': (jmoe, tmoe, dict(n_experts=4))}
TOKS = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                     64)).astype(np.int32)


def _configs(name, **over):
    jm, tm, extra = MODELS[name]
    ref_cls = jgpt.GPTConfig if jm is jgpt else jmoe.MoEConfig
    cfg = ref_cls(**SIZES, **extra, remat=False, matmul_precision='fp8')
    port_cls = tgpt.GPTConfig if tm is tgpt else tmoe.MoEConfig
    return cfg, port_cls(**dict(dataclasses.asdict(cfg), **over))


def _port_run(name, steps, **over):
    """The port's fp8 step from the reference's init: (losses, params,
    fp8 state, each step's count of filled history slots [matmul, role,
    slot])."""
    jm, tm, _ = MODELS[name]
    cfg, tcfg = _configs(name, **over)
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(cfg, jax.random.PRNGKey(0)))
    tp = tgpt.params_from_numpy(jp, tcfg, 'cpu')
    opt = topt.AdamW(learning_rate=1e-3)
    state, f8 = opt.functional_init(tp), tm.init_fp8_state(tcfg, 'cpu')
    step = tm.make_train_step(tcfg, opt)
    toks = _t(TOKS)
    losses, filled = [], []
    for _ in range(steps):
        loss, tp, state, f8 = step(tp, state, f8, 0, 1e-3, toks, toks)
        losses.append(loss.item())
        filled.append(torch.stack([(role['ahist'] != 0).sum(0)
                                   for meta in f8['blocks'].values()
                                   for role in meta.values()]))
    return losses, tp, f8, filled


@pytest.fixture(scope='module')
def reference_runs():
    """Each model's reference fp8 step, 2 steps from its init (one jit
    build a model)."""
    out = {}
    for name, (jm, _, _) in MODELS.items():
        cfg, _ = _configs(name)
        params = jm.init_params(cfg, jax.random.PRNGKey(0))
        opt = paddle.optimizer.AdamW(learning_rate=1e-3)
        state, f8 = opt.functional_init(params), jm.init_fp8_state(cfg)
        step = jm.make_train_step(cfg, opt)
        losses = []
        for i in range(2):
            loss, params, state, f8 = step(
                params, state, f8, jax.random.PRNGKey(100 + i),
                jnp.asarray(1e-3), jnp.asarray(TOKS), jnp.asarray(TOKS))
            losses.append(float(loss))
        out[name] = (losses, jax.tree_util.tree_map(np.asarray, params),
                     jax.tree_util.tree_map(np.asarray, f8))
    return out


@pytest.mark.parametrize('name', sorted(MODELS))
def test_fp8_train_step_matches_the_reference(name, reference_runs):
    want_l, want_p, want_f8 = reference_runs[name]
    got_l, got_p, got_f8, _ = _port_run(name, 2)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_l[-1] < got_l[0]
    for a, b in zip(tgpt._leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    f8_leaves = jax.tree_util.tree_leaves(want_f8)
    assert len(tgpt._leaves(got_f8)) == len(f8_leaves)
    for a, b in zip(tgpt._leaves(got_f8), f8_leaves):
        assert np.abs(a.numpy() - b).max() <= 1e-6 * max(np.abs(b).max(),
                                                         1e-30)


REMAT = {'none': dict(remat=False), 'dots': dict(remat=True),
         'block': dict(remat=True, remat_policy='full')}


@pytest.mark.parametrize('remat', sorted(REMAT))
def test_one_step_pushes_each_history_once(remat):
    """A block recomputed in the backward must not push its amax again:
    after one step from a cold state every history holds exactly its slot
    0, after two steps slots 0 and 1."""
    names = ('gpt', 'moe') if remat == 'block' else ('gpt',)
    for name in names:         # MoE's remat is always the whole block
        over = dict(REMAT[remat])
        if name == 'moe':
            over.pop('remat_policy')
        _, _, _, filled = _port_run(name, 2, **over)
        for step, nz in enumerate(filled, 1):     # 2 layers fill each slot
            assert (nz[:, :step] == 2).all() and (nz[:, step:] == 0).all()


def test_gpt_fp8_curve_tracks_full_width():
    """test_precision.py's tier-1 bar on the port: two fp8 steps land
    within 5e-3 of the full-width steps (same init, same batch)."""
    fp8, _, _, _ = _port_run('gpt', 2)
    cfg, tcfg = _configs('gpt', matmul_precision='none')
    jp = jax.tree_util.tree_map(np.asarray,
                                jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    tp = tgpt.params_from_numpy(jp, tcfg, 'cpu')
    opt = topt.AdamW(learning_rate=1e-3)
    state, step, toks = opt.functional_init(tp), tgpt.make_train_step(
        tcfg, opt), _t(TOKS)
    base = []
    for _ in range(2):
        loss, tp, state = step(tp, state, 0, 1e-3, toks, toks)
        base.append(loss.item())
    np.testing.assert_allclose(fp8, base, atol=5e-3)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_fp8_with_sequence_parallelism_raises_item_10(name):
    """fp8 under sp raises the reference's own refusal: GPT's (step K1
    ported its mesh step), and the MoE GPT's (step K2: its step has no
    shard_map region, so its ring meets an unbound 'sp' axis)."""
    _, tcfg = _configs(name, sp=2)
    msg = 'shard_map' if name == 'gpt' else 'unbound axis name: sp'
    with pytest.raises(NotImplementedError, match=msg):
        MODELS[name][1].make_train_step(tcfg, topt.AdamW())


# ---------------------------------------------------------------------------
# the card's route (torch._scaled_mm), run here on the CPU's _scaled_mm:
# layouts, padding, the backward's operand order, the state, and the
# product count under every remat setting
# ---------------------------------------------------------------------------

def _card_route(x, w, meta):
    return tf8._ScaledMatmul.apply(x, w, *_meta_leaves(meta))


@pytest.mark.parametrize('dt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('lead,k,n', [((4, 64), 128, 384), ((3, 10), 40, 24)])
def test_scaled_mm_route_matches_the_twin(lead, k, n, dt):
    """Exact at a cold meta (scale 1: every dequantized operand is exact
    in the compute dtype); at a warm one within one rounding of the twin's
    dequantized operands (2^-6 of the output in bf16, 1e-6 in f32); the
    new state exactly."""
    g = torch.Generator().manual_seed(k)
    tdt = getattr(torch, dt)
    x = torch.randn(*lead, k, generator=g).to(tdt)
    w = (torch.randn(k, n, generator=g) * 0.05).to(tdt)
    gy = torch.randn(*lead, n, generator=g).to(tdt)
    meta = tf8.init_matmul_meta(device='cpu')
    for warm in (False, True):
        res = []
        for fn in (_card_route, tf8.fp8_matmul):
            xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
            m = {r: {kk: t.clone().requires_grad_() for kk, t in v.items()}
                 for r, v in meta.items()}
            before = tf8.scaled_mm_calls
            out = fn(xi, wi, m)
            got = torch.autograd.grad(out, [xi, wi] + _meta_leaves(m), gy)
            res.append([out.detach().float()] + [t.float() for t in got])
            if fn is _card_route:
                assert tf8.scaled_mm_calls == before + 3
        tol = 0.0 if not warm else (2 ** -6 if dt == 'bfloat16' else 1e-6)
        for a, b in zip(res[0][:3], res[1][:3]):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= tol * b.abs().max()
        for a, b in zip(res[0][3:], res[1][3:]):
            assert torch.equal(a, b)
        it = iter(res[1][3:])
        meta = {r: {kk: next(it) for kk in ('scale', 'ahist')} for r in 'xwg'}


class _ScaledMmRuns(TorchDispatchMode):
    """Counts the ``aten._scaled_mm`` calls that reach the kernel: a
    selective-checkpoint recompute enters its cache above this mode, so a
    product the policy saved is answered before it gets here."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten._scaled_mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('remat,per_layer', [('none', 12), ('dots', 12),
                                             ('block', 16)])
def test_scaled_mm_route_counts_products_once_a_step(remat, per_layer,
                                                     monkeypatch):
    """The GPT fp8 step with every product on the card's route: 4
    matmuls x (forward, dx, dw) a layer run, plus the forward again when
    the whole block is recomputed; under 'dots' the recompute requests
    the 4 forward products again and the policy's cache answers them."""
    monkeypatch.setattr(tgpt._fp8, 'fp8_matmul', _card_route)
    over = {'none': dict(remat=False), 'dots': dict(remat=True),
            'block': dict(remat=True, remat_policy='full')}[remat]
    _, tcfg = _configs('gpt', **over)
    before = tf8.scaled_mm_calls
    with _ScaledMmRuns() as runs:
        _, _, f8, _ = _port_run('gpt', 1, **over)
    requested = per_layer + (4 if remat == 'dots' else 0)
    assert tf8.scaled_mm_calls - before == requested * tcfg.num_layers
    assert runs.n == per_layer * tcfg.num_layers
    assert all(int((role['ahist'] != 0).sum()) == tcfg.num_layers
               for meta in f8['blocks'].values() for role in meta.values())


def test_layer_scales_sit_at_16_byte_addresses_and_route_back():
    """A stacked [L] scale's per-layer views at 16-byte addresses (the
    product refuses any other: cuBLASLt has no fp8 algorithm for it), and
    each layer's "gradient" lands back in its own slot, exactly."""
    scale = torch.tensor([0.5, 2.0, 3.0, 7.0], requires_grad=True)
    views = tf8.layer_scales(scale)
    assert all(v.dim() == 0 and v.data_ptr() % 16 == 0 for v in views)
    assert [v.item() for v in views] == [0.5, 2.0, 3.0, 7.0]
    new = torch.tensor([1.25, 1e-30, 448.0, 6.5])
    got = torch.autograd.grad(views, scale, list(new.unbind(0)))[0]
    assert torch.equal(got, new)
    a = torch.ones((16, 16)).to(tf8.E4M3)
    with pytest.raises(ValueError, match='16-byte'):
        tf8._scaled_mm(a, a.t(), scale.detach()[1], scale.detach()[0],
                       torch.float32)
