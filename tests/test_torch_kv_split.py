"""Kernels 5 and 6 on kernel 7's templates, on the CPU: the plain twins of
their new instances, the instance rule, the CUDA-core kernel's chunked
softmax and the prefill padding, against the port's own twins and,
through the same numpy-seeded inputs, the JAX package's Pallas kernels in
interpret mode.

- Kernel 6's split-K decode over bf16/f32 pages: its twin
  ``paged_decode_split_reference`` against ``paged_decode_reference`` in
  float32 at 2e-6 (the same per-page arithmetic; only the merge reorders
  the rescaling, a few f32 roundings) and against the Pallas
  ``paged_flash_decode`` at 2e-5 (the repo's interpret-mode bound for this
  kernel); in bfloat16 at 2^-6 of each row's largest value (p is rounded
  to bf16 against a split's running max instead of the whole row's).
- Kernel 5's split-K decode over the dense int8 cache read as 128-row
  pages: ``flash_decode_int8_split_reference`` against
  ``flash_decode_int8_reference`` and the Pallas ``flash_decode_int8`` at
  5e-5 (the reference's bound for its int8 kernels).
- The CUDA-core kernel's softmax, updated once per 64-key chunk of a page
  (``chunk=64``), against the once-per-page twin at a 512-row page: 2e-5
  in float32 (the repo's kernel-vs-twin bound), 2^-6 per row in bfloat16.
- ``valid``: rows below it exactly as without it, rows past it zero.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import weight_only as two

fa = importlib.import_module('paddle_tpu.ops.flash_attention')
jpa = importlib.import_module('paddle_tpu.ops.paged_attention')
jwo = importlib.import_module('paddle_tpu.ops.weight_only')

BF, FP = torch.bfloat16, torch.float32


def _row_err(got, want):
    return ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _pages(b, t, h, h_kv, pos, p_max, d=64, ps=128, seed=0):
    """q and bf16/f32-able pages (numpy f32), a shuffled table whose unused
    entries point at the trash page 0, and pos [B], as torch tensors."""
    rng = np.random.RandomState(seed)
    n = b * p_max + 1
    q = rng.randn(b, t, h, d).astype(np.float32)
    kp = rng.randn(n, ps, h_kv, d).astype(np.float32) * 2
    vp = rng.randn(n, ps, h_kv, d).astype(np.float32)
    perm = rng.permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    for i, p0 in enumerate(pos):
        need = min(-(-(p0 + t) // ps), p_max)
        table[i, :need] = perm[i * p_max:i * p_max + need]
    return (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.tensor(pos, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the instance rule and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype,t,d,ps,page_dtype,want', [
    (BF, 1, 64, 128, BF, 'split-k'),         # the bf16 engine's decode
    (FP, 1, 256, 128, FP, 'split-k'),
    (BF, 16, 128, 512, BF, 'split-k'),
    (BF, 1024, 64, 128, BF, 'tensor-core'),  # the bf16 engine's prefill
    (BF, 17, 128, 64, BF, 'tensor-core'),
    (BF, 1024, 64, 1024, BF, 'tensor-core'),
    (BF, 1024, 256, 128, BF, 'cuda-core'),
    (FP, 1024, 64, 128, FP, 'cuda-core'),
    (FP, 300, 128, 512, FP, 'cuda-core'),    # the Q3.2 page sizes
    (FP, 300, 64, 1024, FP, 'cuda-core'),
    (BF, 64, 64, 16, BF, 'cuda-core'),       # pages under 64 rows
])
def test_kernel_6_instance_by_dtype_t_head_dim_and_page(dtype, t, d, ps,
                                                       page_dtype, want):
    assert tpa.paged_instance(dtype, t, d, ps, page_dtype) == want


@pytest.mark.parametrize('dtype,t,d,s_max,want', [
    (BF, 1, 64, 1024, 'split-k'),            # generate()'s decode step
    (FP, 2, 64, 512, 'split-k'),
    (BF, 128, 64, 1024, 'tensor-core'),      # generate()'s prefill
    (BF, 300, 128, 512, 'tensor-core'),
    (BF, 128, 64, 1000, 'cuda-core'),        # S_max not a multiple of 64
    (FP, 128, 64, 1024, 'cuda-core'),
    (BF, 300, 256, 512, 'cuda-core'),
])
def test_kernel_5_takes_the_rule_over_its_implicit_pages(dtype, t, d, s_max,
                                                         want):
    assert tpa.paged_instance(dtype, t, d, s_max, torch.int8) == want


def test_the_generate_decode_plan():
    # generate()'s decode at the bench shape: 8 rows x 16 kv heads over
    # S_max 1024 = 8 implicit pages of 128 rows, on a card of 132 SMs: a
    # split a page
    assert tfa.DENSE_PS == 128
    plan = tpa.split_plan(8, 1, 16, 16, 64, 1024 // tfa.DENSE_PS, 132)
    assert (plan['n_split'], plan['pages_per_split']) == (8, 1)


def test_every_new_instance_has_its_counters():
    for kern in (tpa.paged_flash_decode, tpa.paged_flash_decode_int8,
                 tfa.flash_decode_int8):
        for attr in ('launches', 'split_launches', 'tc_launches'):
            assert getattr(kern, attr) >= 0, (kern, attr)


# ---------------------------------------------------------------------------
# kernel 6: the split twin over bf16/f32 pages
# ---------------------------------------------------------------------------

# (b, t, h, h_kv, pos, p_max): pos at page edges (0, 127, 128 and past
# 1000), GQA groups of 4 and 2, T up to the split instance's 16
SPLIT_CASES = [
    (4, 1, 4, 4, [0, 127, 128, 1023], 8),
    (3, 2, 4, 1, [126, 255, 640], 8),
    (2, 16, 8, 2, [0, 500], 5),
    (2, 7, 4, 2, [1, 130], 3),
]


@pytest.mark.parametrize('pps', [1, 2, 3, 8])
@pytest.mark.parametrize('b,t,h,h_kv,pos,p_max', SPLIT_CASES)
def test_split_twin_over_float_pages_matches_the_twin(b, t, h, h_kv, pos,
                                                      p_max, pps):
    q, kp, vp, table, pos_t = _pages(b, t, h, h_kv, pos, p_max)
    got = tpa.paged_decode_split_reference(q, kp, vp, table, pos_t,
                                           -(-p_max // pps), pps)
    want = tpa.paged_decode_reference(q, kp, vp, table, pos_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize('b,t,h,h_kv,pos,p_max', SPLIT_CASES[:3])
def test_split_twin_over_bf16_pages_within_two_ulps(b, t, h, h_kv, pos,
                                                    p_max):
    q, kp, vp, table, pos_t = (x.to(BF) if x.is_floating_point() else x
                               for x in _pages(b, t, h, h_kv, pos, p_max,
                                               seed=3))
    got = tpa.paged_decode_split_reference(q, kp, vp, table, pos_t, p_max, 1)
    want = tpa.paged_decode_reference(q, kp, vp, table, pos_t)
    assert got.dtype == BF
    assert _row_err(got, want) <= 2.0 ** -6


@pytest.mark.parametrize('pps', [1, 2])
@pytest.mark.parametrize('h,h_kv,t', [(2, 2, 1), (4, 2, 1), (4, 2, 7)])
def test_split_twin_over_float_pages_matches_pallas_kernel_6(h, h_kv, t,
                                                             pps):
    p_max = 3
    q, kp, vp, table, pos_t = _pages(2, t, h, h_kv, [125, 250], p_max,
                                     seed=5)
    fa.set_interpret(True)
    try:
        want = jpa.paged_flash_decode(
            *(jnp.asarray(x.numpy()) for x in (q, kp, vp, table, pos_t)))
    finally:
        fa.set_interpret(False)
    got = tpa.paged_decode_split_reference(q, kp, vp, table, pos_t,
                                           -(-p_max // pps), pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# kernel 5: the split twin over the dense int8 cache's implicit pages
# ---------------------------------------------------------------------------

def _dense(b, t, h, h_kv, s_max, d=64, seed=0):
    """q and int8 banks of a dense cache, quantized by the reference."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)

    def bank():
        x = rng.randn(b, s_max, h_kv, d).astype(np.float32)
        qv, sc = jwo.quantize_kv(jnp.asarray(x))
        return {'int8': torch.from_numpy(np.array(qv)),
                'scale': torch.from_numpy(np.array(sc))}

    return torch.from_numpy(q), bank(), bank()


# (b, t, h, h_kv, s_max, pos): pos 0 and at a page edge, S_max not a
# multiple of 64 (a short last page), GQA, T up to 16
DENSE_CASES = [
    (2, 1, 4, 4, 256, 0),
    (2, 1, 4, 2, 256, 130),
    (3, 4, 4, 2, 200, 60),
    (2, 16, 8, 2, 384, 300),
    (2, 3, 4, 4, 200, 196),
]


@pytest.mark.parametrize('pps', [1, 2, 5])
@pytest.mark.parametrize('b,t,h,h_kv,s_max,pos', DENSE_CASES)
def test_dense_split_twin_matches_the_int8_twin(b, t, h, h_kv, s_max, pos,
                                                pps):
    q, kb, vb = _dense(b, t, h, h_kv, s_max, seed=pos + t)
    p_max = -(-s_max // tfa.DENSE_PS)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    got = tfa.flash_decode_int8_split_reference(q, kb, vb, pos_t,
                                                -(-p_max // pps), pps)
    want = tfa.flash_decode_int8_reference(q, kb, vb, pos_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize('pps', [1, 3])
@pytest.mark.parametrize('b,t,h,h_kv,s_max,pos', DENSE_CASES[:3])
def test_dense_split_twin_matches_pallas_kernel_5(b, t, h, h_kv, s_max, pos,
                                                  pps):
    q, kb, vb = _dense(b, t, h, h_kv, s_max, seed=11 + pos)
    jbank = lambda x: {k: jnp.asarray(v.numpy()) for k, v in x.items()}  # noqa: E731
    fa.set_interpret(True)
    try:
        want = fa.flash_decode_int8(jnp.asarray(q.numpy()), jbank(kb),
                                    jbank(vb), jnp.int32(pos))
    finally:
        fa.set_interpret(False)
    p_max = -(-s_max // tfa.DENSE_PS)
    got = tfa.flash_decode_int8_split_reference(
        q, kb, vb, torch.tensor([pos], dtype=torch.int32), -(-p_max // pps),
        pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_dense_split_twin_in_bfloat16_within_two_ulps():
    q, kb, vb = _dense(2, 1, 4, 2, 1024, seed=4)
    q = q.to(BF)
    pos = torch.tensor([700], dtype=torch.int32)
    got = tfa.flash_decode_int8_split_reference(q, kb, vb, pos, 8, 2)
    want = tfa.flash_decode_int8_reference(q, kb, vb, pos)
    assert got.dtype == BF
    assert _row_err(got, want) <= 2.0 ** -6


# ---------------------------------------------------------------------------
# Q3.2: the CUDA-core kernel's chunked softmax at large pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [FP, BF])
@pytest.mark.parametrize('ps,d,t,pos', [
    (512, 128, 70, [0, 470]),       # a tile that crosses a page edge
    (512, 64, 3, [510, 1023]),
    (1024, 64, 40, [0, 1000]),
])
def test_chunked_twin_matches_the_per_page_twin(ps, d, t, pos, dtype):
    q, kp, vp, table, pos_t = _pages(2, t, 4, 2, pos, 2, d=d, ps=ps,
                                     seed=ps + t)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = tpa.paged_decode_reference(q, kp, vp, table, pos_t,
                                     chunk=tpa.CHUNK)
    want = tpa.paged_decode_reference(q, kp, vp, table, pos_t)
    assert got.dtype == dtype
    assert _row_err(got, want) <= (2e-5 if dtype == FP else 2.0 ** -6)


def test_chunked_twin_over_int8_pages():
    q, kp, vp, table, pos_t = _pages(2, 20, 4, 4, [5, 900], 2, d=64, ps=512,
                                     seed=9)
    kb = dict(zip(('int8', 'scale'), two.quantize_kv(kp)))
    vb = dict(zip(('int8', 'scale'), two.quantize_kv(vp)))
    args = (q, kb['int8'], vb['int8'], table, pos_t, kb['scale'],
            vb['scale'])
    got = tpa.paged_decode_reference(*args, chunk=tpa.CHUNK)
    want = tpa.paged_decode_reference(*args)
    assert _row_err(got, want) <= 2e-5


# ---------------------------------------------------------------------------
# prefill padding: valid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('int8', [False, True])
def test_valid_zeroes_the_rows_past_it_and_keeps_the_rest(int8):
    q, kp, vp, table, pos_t = _pages(3, 200, 4, 2, [0, 0, 100], 3, seed=2)
    k, v = kp, vp
    if int8:
        k = dict(zip(('int8', 'scale'), two.quantize_kv(kp)))
        v = dict(zip(('int8', 'scale'), two.quantize_kv(vp)))
    valid = torch.tensor([5, 200, 130], dtype=torch.int32)
    twin = (tpa.paged_decode_int8_reference if int8
            else tpa.paged_decode_reference)
    full = twin(q, k, v, table, pos_t)
    got = twin(q, k, v, table, pos_t, valid=valid)
    # the CPU dispatch passes valid on
    assert torch.equal(tpa.paged_attention(q, k, v, table, pos_t, valid),
                       got)
    for i, n in enumerate(valid.tolist()):
        assert torch.equal(got[i, :n], full[i, :n])
        assert not got[i, n:].any()
    split = tpa.paged_decode_split_reference(q[:, :16], k, v, table, pos_t,
                                             3, 1, valid=valid)
    for i, n in enumerate(valid.tolist()):
        assert not split[i, n:].any()
        np.testing.assert_allclose(split[i, :n].numpy(),
                                   full[i, :min(n, 16)].numpy(), rtol=2e-6,
                                   atol=2e-6)
