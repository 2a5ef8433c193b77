"""The port's paged attention (paddle_tpu_torch/ops/paged_attention.py)
against the JAX package's: the plain twins of the Hopper kernels 6 and 7
against the Pallas kernels ``paged_flash_decode`` and
``paged_flash_decode_int8`` run in interpret mode, and the gather
fallback against the reference fallback, on the same inputs.

Tolerances: float32 2e-5 (the repo's own interpret-mode bound for this
kernel; the two sum in different orders), int8 5e-5 (the reference's
bound for its int8 kernels), bfloat16 2e-2 (p is rounded to bf16 before
p.V on both sides, but a 1-ulp f32 difference can flip a rounding),
fallback float32 1e-6 (same op sequence)."""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import paged_attention as tpa

fa = importlib.import_module('paddle_tpu.ops.flash_attention')
jpa = importlib.import_module('paddle_tpu.ops.paged_attention')

PS, D, P_MAX = 128, 64, 3


def _case(t, h, h_kv, seed=0):
    """Scattered pages, positions that cross page boundaries (row j of
    slot b sees positions <= pos[b] + j), trash entries past each slot's
    pages, as the engine leaves them."""
    rng = np.random.RandomState(seed)
    b = 2
    n = b * P_MAX + 1
    q = rng.randn(b, t, h, D).astype(np.float32)
    kp = rng.randn(n, PS, h_kv, D).astype(np.float32)
    vp = rng.randn(n, PS, h_kv, D).astype(np.float32)
    pos = np.array([125, 250], np.int32)
    perm = rng.permutation(np.arange(1, n))
    table = np.zeros((b, P_MAX), np.int32)
    for i, p0 in enumerate(pos):
        need = -(-(p0 + t) // PS)
        table[i, :need] = perm[i * P_MAX:i * P_MAX + need]
    return q, kp, vp, table, pos


_TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _torch(x, dtype=None):
    t = torch.from_numpy(x)
    return t.to(_TDT[dtype]) if dtype else t


@pytest.mark.parametrize('dtype,tol', [('float32', 2e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('t', [1, 7])
def test_twin_matches_pallas_kernel_in_interpret_mode(t, h, h_kv, dtype, tol):
    q, kp, vp, table, pos = _case(t, h, h_kv)
    jdt = jnp.dtype(dtype)
    fa.set_interpret(True)
    try:
        want = jpa.paged_flash_decode(
            jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(table), jnp.asarray(pos))
    finally:
        fa.set_interpret(False)
    got = tpa.paged_decode_reference(
        _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
        _torch(table), _torch(pos))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2), (4, 1)])
@pytest.mark.parametrize('t', [1, 7])
def test_fallback_matches_reference_fallback(t, h, h_kv):
    q, kp, vp, table, pos = _case(t, h, h_kv, seed=1)
    want = jpa.paged_attention_fallback(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), jnp.float32)
    got = tpa.paged_attention_fallback(
        _torch(q), _torch(kp), _torch(vp), _torch(table), _torch(pos),
        torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('t', [1, 7, 200])
def test_twin_matches_fallback_across_page_sizes(t):
    # any T (the kernel tiles q rows; the TPU gate stopped at 128) and a
    # page size that is not a multiple of 128
    rng = np.random.RandomState(t)
    b, h, h_kv, ps, p_max = 2, 4, 2, 16, 16
    n = b * p_max + 1
    q = torch.from_numpy(rng.randn(b, t, h, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n, ps, h_kv, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n, ps, h_kv, D).astype(np.float32))
    table = torch.from_numpy(
        rng.permutation(np.arange(1, n)).reshape(b, p_max).astype(np.int32))
    pos = torch.tensor([0, max(0, ps * p_max - t - 3)], dtype=torch.int32)
    got = tpa.paged_decode_reference(q, kp, vp, table, pos)
    want = tpa.paged_attention_fallback(q, kp, vp, table, pos, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_dispatch_cpu_runs_the_twin_and_never_the_kernel():
    q, kp, vp, table, pos = _case(1, 2, 2)
    before = tpa.paged_flash_decode.launches
    got = tpa.paged_attention(_torch(q), _torch(kp), _torch(vp),
                              _torch(table), _torch(pos))
    want = tpa.paged_decode_reference(_torch(q), _torch(kp), _torch(vp),
                                      _torch(table), _torch(pos))
    assert torch.equal(got, want)
    assert tpa.paged_flash_decode.launches == before


def test_kernel_wrapper_refuses_cpu_tensors_and_int8_banks():
    # the kernel wrappers take CUDA tensors only; on the CPU an int8 bank
    # dispatches to kernel 7's twin, never to kernel 6's
    q, kp, vp, table, pos = _case(1, 2, 2)
    args = [_torch(x) for x in (q, kp, vp, table, pos)]
    with pytest.raises(ValueError, match='CUDA'):
        tpa.paged_flash_decode(*args)
    bank = _bank(kp)
    with pytest.raises(ValueError, match='CUDA'):
        tpa.paged_flash_decode_int8(args[0], bank, bank, args[3], args[4])
    before = (tpa.paged_flash_decode.launches,
              tpa.paged_flash_decode_int8.launches)
    got = tpa.paged_attention(args[0], bank, bank, args[3], args[4])
    want = tpa.paged_decode_int8_reference(args[0], bank, bank, args[3],
                                           args[4])
    assert torch.equal(got, want)
    assert (tpa.paged_flash_decode.launches,
            tpa.paged_flash_decode_int8.launches) == before
    meta = [a.to('meta') for a in args]
    with pytest.raises(ValueError, match='cuda or cpu'):
        tpa.paged_attention(*meta)


# ---------------------------------------------------------------------------
# kernel 7: paged decode over int8 pages
# ---------------------------------------------------------------------------

jwo = importlib.import_module('paddle_tpu.ops.weight_only')


def _bank(pages):
    """An int8 bank of the pages, quantized by the reference."""
    qv, sc = jwo.quantize_kv(jnp.asarray(pages))
    return {'int8': torch.from_numpy(np.array(qv)),
            'scale': torch.from_numpy(np.array(sc))}


def _jbank(bank):
    return {k: jnp.asarray(v.numpy()) for k, v in bank.items()}


@pytest.mark.parametrize('dtype,tol', [('float32', 5e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('t', [1, 7])
def test_int8_twin_matches_pallas_kernel_in_interpret_mode(t, h, h_kv, dtype,
                                                           tol):
    # 5e-5: the reference's own bound for its int8 kernels
    q, kp, vp, table, pos = _case(t, h, h_kv, seed=5)
    kb, vb = _bank(kp * 3), _bank(vp)
    jdt = jnp.dtype(dtype)
    fa.set_interpret(True)
    try:
        want = jpa.paged_flash_decode_int8(
            jnp.asarray(q, jdt), _jbank(kb), _jbank(vb), jnp.asarray(table),
            jnp.asarray(pos))
    finally:
        fa.set_interpret(False)
    got = tpa.paged_attention(_torch(q, dtype), kb, vb, _torch(table),
                              _torch(pos))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('t', [1, 7])
def test_int8_fallback_matches_reference_fallback(t):
    q, kp, vp, table, pos = _case(t, 4, 2, seed=6)
    kb, vb = _bank(kp), _bank(vp)
    want = jpa.paged_attention_fallback(
        jnp.asarray(q), _jbank(kb), _jbank(vb), jnp.asarray(table),
        jnp.asarray(pos), jnp.float32)
    got = tpa.paged_attention_fallback(_torch(q), kb, vb, _torch(table),
                                       _torch(pos), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the twin (scales applied around the dots) agrees with the gather path
    # (scales applied to the values) to f32 rounding
    twin = tpa.paged_decode_int8_reference(_torch(q), kb, vb, _torch(table),
                                           _torch(pos))
    np.testing.assert_allclose(twin.numpy(), got.numpy(), rtol=5e-5,
                               atol=5e-5)
