"""The port's attention dropout and flash backward
(paddle_tpu_torch/ops/flash_attention.py) against the JAX package's, on
the CPU: the counter-hash dropout helpers bit for bit; kernel 1's twin
with dropout against ``_jnp_attention`` and the Pallas forward in
interpret mode; the backward twin (kernels 2 and 3) against both branches
of the reference's backward, ``_bwd_pallas`` (Pallas in interpret mode)
and ``_bwd_blockwise`` (``PADDLE_TPU_FLASH_JNP_BWD=1``), through
``jax.grad`` of the reference's ``flash_attention`` and autograd of the
port's. Inputs come from numpy seeds.

Tolerance: float32 2e-5 (the twins repeat the kernels' block-wise
arithmetic; only the order of the sums inside a dot differs)."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import flash_attention as tfa

fa = importlib.import_module('paddle_tpu.ops.flash_attention')

TOL = 2e-5
# u32 seeds on both sides of 2**31 (a signed int32 would wrap there)
SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 12345, 3_000_000_000,
         2 ** 32 - 1]


@pytest.fixture
def interpret():
    fa.set_interpret(True)
    try:
        yield
    finally:
        fa.set_interpret(False)


# ---------------------------------------------------------------------------
# the counter hash, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('rate', [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize('seed', SEEDS)
def test_dropout_keep_is_bit_exact(seed, rate):
    rng = np.random.RandomState(seed % 1000)
    row = rng.randint(0, 4096, size=(5, 1, 1))
    q_pos = rng.randint(0, 8192, size=(1, 33, 1))
    k_pos = rng.randint(0, 8192, size=(1, 1, 47))
    want = fa._dropout_keep(jnp.uint32(seed), jnp.asarray(row, jnp.uint32),
                            jnp.asarray(q_pos, jnp.int32),
                            jnp.asarray(k_pos, jnp.int32), rate)
    got = tfa._dropout_keep(seed, torch.from_numpy(row),
                            torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                            rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kept share is the rate's complement
    assert abs(got.float().mean().item() - (1 - rate)) < 0.02


@pytest.mark.parametrize('seed', SEEDS)
def test_mix_seed_and_per_layer_seeds_are_bit_exact(seed):
    assert int(tfa.mix_seed(seed)) == int(fa.mix_seed(jnp.uint32(seed)))
    xs = np.array([seed, 7, 2 ** 32 - 2], np.uint32)
    np.testing.assert_array_equal(tfa.mix_seed(torch.from_numpy(
        xs.astype(np.int64))).numpy(),
        np.asarray(fa.mix_seed(jnp.asarray(xs))).astype(np.int64))
    got = tfa.per_layer_seeds(seed, 24)
    want = np.asarray(fa.per_layer_seeds(jnp.uint32(seed), 24))
    assert got.dtype == torch.int64 and int(got.max()) < 2 ** 32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_drop_mult_matches_reference_tile():
    shape = (128, 256)
    want = fa._drop_mult(shape, jnp.uint32(2 ** 31 + 5), 37, 1, 2, 128, 128,
                         0.3)
    q_pos = torch.arange(128, 256)[:, None]
    k_pos = torch.arange(256, 512)[None, :]
    got = tfa._drop_mult(2 ** 31 + 5, 37, q_pos, k_pos, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# kernel 1 with dropout
# ---------------------------------------------------------------------------

def _qkv(b, s_q, s_k, h, h_kv, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s_q, h, d).astype(np.float32),
            rng.randn(b, s_k, h_kv, d).astype(np.float32),
            rng.randn(b, s_k, h_kv, d).astype(np.float32),
            rng.randn(b, s_q, h, d).astype(np.float32))


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
def test_forward_with_dropout_matches_jnp_attention(causal, h, h_kv):
    q, k, v, _ = _qkv(2, 200, 200, h, h_kv, seed=1)
    seed = 2 ** 31 + 99
    want = fa._jnp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, None, drop_rate=0.25, seed=seed)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              dropout_rate=0.25, dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    plain = tfa.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal,
                                    drop_rate=0.25, seed=seed)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_forward_with_dropout_matches_pallas_kernel(interpret):
    q, k, v, _ = _qkv(2, 256, 256, 4, 2, seed=2)
    bh, d = 2 * 4, 64
    seed = 3_000_000_000
    qt = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(bh, 256, d))
    kt = jnp.asarray(k.transpose(0, 2, 1, 3).reshape(4, 256, d))
    vt = jnp.asarray(v.transpose(0, 2, 1, 3).reshape(4, 256, d))
    out, lse = fa._flash_fwd(qt, kt, vt, True, h=4, g=2, drop_rate=0.1,
                             seed=jnp.asarray([seed], jnp.uint32))
    got_o, got_l = tfa.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True,
        drop_rate=0.1, seed=seed)
    np.testing.assert_allclose(
        got_o.permute(0, 2, 1, 3).reshape(bh, 256, d).numpy(),
        np.asarray(out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_l.reshape(bh, 256).numpy(),
                               np.asarray(lse), atol=TOL, rtol=TOL)


def test_dropout_arguments_are_checked():
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match='< 1'):
        tfa.flash_attention(q, q, q, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match='dropout_seed'):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)


# ---------------------------------------------------------------------------
# kernels 2 and 3: the backward twin against both reference branches
# ---------------------------------------------------------------------------

# (b, s_q, s_k, h, h_kv, causal, masked, drop)
BWD_CASES = {
    'causal': (2, 256, 256, 2, 2, True, False, 0.0),
    'noncausal': (2, 256, 256, 2, 2, False, False, 0.0),
    'gqa_4_2': (2, 256, 256, 4, 2, True, False, 0.0),
    'kmask': (2, 256, 256, 2, 2, False, True, 0.0),
    'ragged_200': (2, 200, 200, 2, 2, True, False, 0.0),
    'sq_lt_sk': (2, 128, 256, 2, 2, True, False, 0.0),
    'dropout_0.25': (2, 256, 256, 4, 2, True, False, 0.25),
}


def _grads_both(case, seed=0):
    """(reference out + grads, port out + grads) of sum(out * dO)."""
    b, s_q, s_k, h, h_kv, causal, masked, drop = case
    q, k, v, g = _qkv(b, s_q, s_k, h, h_kv, seed=seed)
    mask = None
    if masked:
        mask = np.ones((b, s_k), bool)
        mask[1, s_k - 70:] = False
    dseed = 2 ** 31 + 7 if drop else None

    def jloss(q, k, v):
        o = fa.flash_attention(q, k, v, causal=causal,
                               mask=None if mask is None else
                               jnp.asarray(mask),
                               dropout_rate=drop, dropout_seed=dseed)
        return jnp.sum(o * g), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to = tfa.flash_attention(*leaves, causal=causal,
                             mask=None if mask is None else
                             torch.from_numpy(mask),
                             dropout_rate=drop, dropout_seed=dseed)
    (to * torch.from_numpy(g)).sum().backward()
    return ([np.asarray(jo)] + [np.asarray(x) for x in jg],
            [to.detach().numpy()] + [x.grad.numpy() for x in leaves])


@pytest.mark.parametrize('case', sorted(BWD_CASES))
@pytest.mark.parametrize('branch', ['pallas', 'blockwise'])
def test_backward_twin_matches_reference(interpret, monkeypatch, case,
                                         branch):
    if branch == 'blockwise':
        monkeypatch.setenv('PADDLE_TPU_FLASH_JNP_BWD', '1')
    else:
        monkeypatch.delenv('PADDLE_TPU_FLASH_JNP_BWD', raising=False)
    want, got = _grads_both(BWD_CASES[case], seed=len(case))
    for name, w, t in zip(('out', 'dq', 'dk', 'dv'), want, got):
        assert t.shape == w.shape, name
        np.testing.assert_allclose(t, w, atol=TOL, rtol=TOL, err_msg=name)


def test_backward_twin_matches_bwd_pallas_pre_directly(interpret):
    """The twin on the reference's own [BH, S, D] inputs and lse (GQA,
    dropout): the kernels' function, without autograd around it."""
    b, s, h, h_kv, d = 2, 256, 4, 2, 64
    q, k, v, g = _qkv(b, s, s, h, h_kv, seed=9)
    bh = b * h
    to_bh = lambda x, n: jnp.asarray(  # noqa: E731
        x.transpose(0, 2, 1, 3).reshape(n, s, d))
    qt, gt = to_bh(q, bh), to_bh(g, bh)
    kt, vt = to_bh(k, b * h_kv), to_bh(v, b * h_kv)
    seed = jnp.asarray([12345], jnp.uint32)
    out, lse = fa._flash_fwd(qt, kt, vt, True, h=h, g=2, drop_rate=0.2,
                             seed=seed)
    lse_b, dta_b = fa.bwd_broadcasts(out, lse, gt)
    want = fa._bwd_pallas_pre(qt, kt, vt, gt, lse_b, dta_b, True, h=h,
                              groups=2, drop_rate=0.2, seed=seed)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    t_out = torch.from_numpy(np.array(out)).reshape(b, h, s, d).permute(
        0, 2, 1, 3)
    t_lse = torch.from_numpy(np.array(lse)).reshape(b, h, s)
    delta = tfa.bwd_delta(t_out, tg)
    np.testing.assert_allclose(delta.reshape(bh, s).numpy(),
                               np.asarray(dta_b[:, :, 0]), atol=TOL,
                               rtol=TOL)
    got = tfa.flash_bwd_reference(tq, tk, tv, tg, t_lse, delta, True,
                                  drop_rate=0.2, seed=12345)
    for name, w, t, n in zip(('dq', 'dk', 'dv'), want, got,
                             (bh, b * h_kv, b * h_kv)):
        np.testing.assert_allclose(
            t.permute(0, 2, 1, 3).reshape(n, s, d).numpy(), np.asarray(w),
            atol=TOL, rtol=TOL, err_msg=name)


def test_bf16_backward_twin_rounds_where_the_kernels_round(interpret):
    """bf16: ds, pd and the GQA partials are rounded where the reference's
    kernels round them, so the twin stays within bf16's few ulps of the
    Pallas backward (2e-2 at these outputs' size)."""
    q, k, v, g = _qkv(1, 128, 128, 4, 2, seed=11)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731

    def jloss(q, k, v):
        o = fa.flash_attention(q, k, v, causal=True)
        return jnp.sum(o.astype(jnp.float32) * g)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jb(q), jb(k), jb(v))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=True)
    (o.float() * torch.from_numpy(g)).sum().backward()
    for w, t in zip(jg, leaves):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)


def test_cpu_backward_runs_the_twin_and_never_a_kernel():
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 2, 2))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    (tfa.flash_attention(*leaves, causal=True) * g).sum().backward()
    assert all(x.grad is not None for x in leaves)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before
