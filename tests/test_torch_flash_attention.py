"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU: the plain twins of the Hopper
kernels 1, 4 and 5 against the Pallas kernels ``_flash_fwd``,
``flash_decode`` and ``flash_decode_int8`` run in interpret mode, the
plain attention against ``_jnp_attention``, and ``quantize_kv`` against
the reference bit for bit. Inputs come from numpy seeds.

Tolerances: float32 2e-5 (the twins repeat the kernels' block-wise
arithmetic; only the order of the sums inside a dot differs); the int8
decode 5e-5 (the reference's own bound for its int8 kernel); bfloat16
decode 2e-2 (p is rounded to bf16 before p.V on both sides, but a 1-ulp
f32 difference can flip a rounding, and outputs are bf16: 2e-2 is a few
bf16 ulps at the outputs' size)."""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import weight_only as two

fa = importlib.import_module('paddle_tpu.ops.flash_attention')
jwo = importlib.import_module('paddle_tpu.ops.weight_only')

_TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@pytest.fixture
def interpret():
    fa.set_interpret(True)
    try:
        yield
    finally:
        fa.set_interpret(False)


def _t(x, dtype='float32'):
    return torch.from_numpy(np.asarray(x, np.float32)).to(_TDT[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# kernel 4: flash_decode
# ---------------------------------------------------------------------------

def _decode_case(t, h, h_kv, s_max=256, d=64, seed=0):
    rng = np.random.RandomState(seed)
    b = 2
    q = rng.randn(b, t, h, d).astype(np.float32)
    kc = rng.randn(b, s_max, h_kv, d).astype(np.float32)
    vc = rng.randn(b, s_max, h_kv, d).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize('dtype,tol', [('float32', 2e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('pos', [0, 5, 100, 255])
@pytest.mark.parametrize('t', [1, 4])
def test_decode_twin_matches_pallas_kernel(interpret, t, pos, h, h_kv, dtype,
                                           tol):
    if pos + t > 256:
        t = 256 - pos            # rows past the window do not exist
    q, kc, vc = _decode_case(t, h, h_kv, seed=pos + t)
    jdt = jnp.dtype(dtype)
    want = fa.flash_decode(jnp.asarray(q, jdt), jnp.asarray(kc, jdt),
                           jnp.asarray(vc, jdt), jnp.int32(pos))
    pos_t = torch.tensor([pos], dtype=torch.int32)
    got = tfa.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               pos_t)
    assert got.dtype == _TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


def test_decode_twin_takes_an_int_position_and_a_prefill_past_128_rows():
    """A Python-int ``pos`` and T > 128 (the TPU kernel's q tile) run too:
    against the plain masked softmax over the cache."""
    q, kc, vc = _decode_case(200, 2, 2, s_max=384, seed=3)
    got = tfa.flash_decode_reference(_t(q), _t(kc), _t(vc), 40)
    k, v = _t(kc)[:, :240], _t(vc)[:, :240]
    want = tfa.attention_reference(_t(q), k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# kernel 5: flash_decode_int8
# ---------------------------------------------------------------------------

def test_quantize_kv_is_bit_exact():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 17, 4, 64).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                               # amax 0: the 1e-8 floor
    x[1, 2, 3, :5] = [0.5, -0.5, 1.5, 2.5, 127.0]  # ties round half to even
    jq, js = jwo.quantize_kv(jnp.asarray(x))
    tq, ts = two.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        two.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jwo.dequantize_kv(jq, js, jnp.float32)))
    bank = two.init_kv_bank((2, 8, 4, 64), 'cpu')
    assert bank['int8'].shape == (2, 8, 4, 64) and bank['scale'].shape == (
        2, 8, 4)
    assert not bank['int8'].any() and not bank['scale'].any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('t,pos', [(1, 0), (1, 130), (4, 60)])
def test_decode_int8_twin_matches_pallas_kernel(interpret, t, pos, h, h_kv,
                                                dtype):
    q, kc, vc = _decode_case(t, h, h_kv, seed=7 + pos)
    kq, ks = jwo.quantize_kv(jnp.asarray(kc))
    vq, vs = jwo.quantize_kv(jnp.asarray(vc))
    jdt = jnp.dtype(dtype)
    want = fa.flash_decode_int8(jnp.asarray(q, jdt),
                                {'int8': kq, 'scale': ks},
                                {'int8': vq, 'scale': vs}, jnp.int32(pos))
    kb = {'int8': torch.from_numpy(np.array(kq)),
          'scale': torch.from_numpy(np.array(ks))}
    vb = {'int8': torch.from_numpy(np.array(vq)),
          'scale': torch.from_numpy(np.array(vs))}
    got = tfa.decode_attention(_t(q, dtype), kb, vb,
                               torch.tensor([pos], dtype=torch.int32))
    tol = 5e-5 if dtype == 'float32' else 2e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# kernel 1: _flash_fwd (out and lse)
# ---------------------------------------------------------------------------

def _bhsd(x):
    """[B,S,H,D] numpy -> the reference kernel's [B*H, S, D]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _pad(x, s):
    return np.pad(x, ((0, 0), (0, s - x.shape[1]), (0, 0), (0, 0)))


_FWD_CASES = {
    # name: (b, s_q, s_k, h, h_kv, d, causal, key-padding mask)
    'causal_d64': (2, 256, 256, 2, 2, 64, True, False),
    'full_d64': (2, 256, 256, 2, 2, 64, False, False),
    'causal_d128': (1, 128, 128, 2, 2, 128, True, False),
    'ragged_kv_valid': (2, 200, 200, 2, 2, 64, True, False),
    'key_mask': (2, 256, 256, 2, 2, 64, False, True),
    'cross_q_off': (2, 128, 384, 2, 2, 64, True, False),
    'gqa_g2': (2, 256, 256, 4, 2, 64, True, False),
}


@pytest.mark.parametrize('case', sorted(_FWD_CASES))
def test_fwd_twin_matches_pallas_kernel(interpret, case):
    b, s_q, s_k, h, h_kv, d, causal, masked = _FWD_CASES[case]
    rng = np.random.RandomState(len(case))
    q = rng.randn(b, s_q, h, d).astype(np.float32)
    k = rng.randn(b, s_k, h_kv, d).astype(np.float32)
    v = rng.randn(b, s_k, h_kv, d).astype(np.float32)
    q_off = (s_k - s_q) if causal else 0
    kmask = None
    if masked:
        valid = rng.randint(s_k // 2, s_k + 1, size=b)
        kmask = np.where(np.arange(s_k)[None] < valid[:, None], 0.0,
                         -1e30).astype(np.float32)
    # the reference kernel takes block multiples: pad, and bound the keys
    s_qp, s_kp = -(-s_q // 128) * 128, -(-s_k // 128) * 128
    kv_valid = s_k if s_kp != s_k else None
    bq, bk = fa._pick_blocks(s_q, s_k)
    assert (bq, bk) == tfa._pick_blocks(s_q, s_k)
    want_o, want_l = fa._flash_fwd(
        _bhsd(_pad(q, s_qp)), _bhsd(_pad(k, s_kp)), _bhsd(_pad(v, s_kp)),
        causal, q_off=q_off, kv_valid=kv_valid,
        kmask=None if kmask is None else jnp.asarray(kmask), h=h,
        g=h // h_kv, bq=bq, bk=bk)
    want_o = np.asarray(want_o).reshape(b, h, s_qp, d)[:, :, :s_q]
    want_l = np.asarray(want_l).reshape(b, h, s_qp)[:, :, :s_q]
    got_o, got_l = tfa._flash_fwd(
        _t(q), _t(k), _t(v), causal, q_off=q_off,
        kmask=None if kmask is None else torch.from_numpy(kmask))
    np.testing.assert_allclose(got_o.permute(0, 2, 1, 3).numpy(), want_o,
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=2e-5, rtol=2e-5)
    if kv_valid is not None:
        # the reference's own padded inputs with kv_valid give the same rows
        pad_o, pad_l = tfa._flash_fwd(_t(_pad(q, s_qp)), _t(_pad(k, s_kp)),
                                      _t(_pad(v, s_kp)), causal, q_off=q_off,
                                      kv_valid=kv_valid)
        np.testing.assert_allclose(pad_o[:, :s_q].numpy(),
                                   got_o.numpy(), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(pad_l[:, :, :s_q].numpy(),
                                   got_l.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('causal,mask_kind,s_q,s_k', [
    (True, None, 64, 64),
    (False, 'bool', 64, 96),
    (True, 'additive', 32, 96),
    (True, None, 96, 64),            # S_q > S_k: the plain path
    (False, 'per_head', 64, 64),     # per-head mask: the plain path
])
def test_flash_attention_matches_reference_routing(interpret, causal,
                                                   mask_kind, s_q, s_k):
    rng = np.random.RandomState(s_q + s_k)
    b, h, h_kv, d = 2, 4, 2, 64
    q = rng.randn(b, s_q, h, d).astype(np.float32)
    k = rng.randn(b, s_k, h_kv, d).astype(np.float32)
    v = rng.randn(b, s_k, h_kv, d).astype(np.float32)
    mask = None
    if mask_kind == 'bool':
        mask = np.arange(s_k)[None] < np.array([[s_k], [s_k - 20]])
    elif mask_kind == 'additive':
        mask = np.where(np.arange(s_k)[None, None] < 80, 0.0,
                        -1e30).astype(np.float32).repeat(b, 0)
    elif mask_kind == 'per_head':
        mask = rng.rand(b, h, s_k) > 0.2
        mask[..., 0] = True
    want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal,
                              mask=None if mask is None else jnp.asarray(mask))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    plain = fa._jnp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, None if mask is None
                              else jnp.asarray(mask))
    np.testing.assert_allclose(
        tfa.attention_reference(_t(q), _t(k), _t(v), causal,
                                None if mask is None
                                else torch.from_numpy(mask)).numpy(),
        np.asarray(plain), atol=2e-5, rtol=2e-5)


def test_dropout_waits_for_the_training_slice():
    # the training slice has come: dropout runs, with the reference's mask
    # (tests/test_torch_flash_backward.py holds it bit for bit)
    rng = np.random.RandomState(5)
    x = rng.randn(1, 8, 2, 64).astype(np.float32)
    want = fa._jnp_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                             True, None, drop_rate=0.1, seed=1)
    got = tfa.flash_attention(_t(x), _t(x), _t(x), causal=True,
                              dropout_rate=0.1, dropout_seed=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
