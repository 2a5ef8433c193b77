"""Kernel 4 (flash decode over a bf16/f32 dense cache) on the split-K and
tensor-core templates of kernels 5-7, on the CPU: the plain twin of its
split-K instance, the instance rule, its counters and the ctypes binding of
its C entry point.

- ``flash_decode_split_reference`` (the dense cache read as ``DENSE_PS``-row
  pages through the implicit table, split, merged by log-sum-exp) against
  ``flash_decode_reference`` in float32 at 2e-6 (the same per-page
  arithmetic; only the merge reorders the rescaling, a few f32 roundings)
  and against the Pallas ``_decode_kernel`` in interpret mode at 5e-5; in
  bfloat16 at 2^-6 of each row's largest value (p is rounded to bf16
  against a split's running max instead of the whole row's).
- The instance: kernel 6's rule with S_max for the page size.
- The C entry point ``flash_decode`` takes the argument list of
  ``flash_decode_int8`` (the split-K partials, tickets, split plan and the
  instance it ran), and the ctypes binding matches it.
"""
import importlib
import pathlib
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa

fa = importlib.import_module('paddle_tpu.ops.flash_attention')

BF, FP = torch.bfloat16, torch.float32
CSRC = pathlib.Path(tfa.__file__).resolve().parent.parent / 'csrc'


def _row_err(got, want):
    return ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _cache(b, t, h, h_kv, s_max, d=64, seed=0):
    """q and a dense cache [B, S_max, H_kv, D] (numpy f32 -> torch)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kc = rng.randn(b, s_max, h_kv, d).astype(np.float32) * 2
    vc = rng.randn(b, s_max, h_kv, d).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc)


def _plan(b, t, h, h_kv, d, s_max, sms=132):
    p = tpa.split_plan(b, t, h, h_kv, d, -(-s_max // tfa.DENSE_PS), sms)
    return p['n_split'], p['pages_per_split']


# ---------------------------------------------------------------------------
# the instance rule, the plan and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype,t,d,s_max,want', [
    (BF, 1, 64, 1024, 'split-k'),            # generate()'s decode step
    (FP, 1, 256, 1000, 'split-k'),
    (BF, 16, 128, 1024, 'split-k'),
    (BF, 128, 64, 1024, 'tensor-core'),      # generate()'s prefill
    (BF, 1000, 64, 1024, 'tensor-core'),     # the prefill past the window
    (BF, 300, 128, 512, 'tensor-core'),
    (BF, 17, 64, 64, 'tensor-core'),
    (BF, 128, 64, 1000, 'cuda-core'),        # S_max not a multiple of 64
    (BF, 128, 256, 1024, 'cuda-core'),       # D 256
    (FP, 128, 64, 1024, 'cuda-core'),        # f32 at T > 16
])
def test_kernel_4_takes_kernel_6s_rule_over_its_implicit_pages(dtype, t, d,
                                                               s_max, want):
    assert tpa.paged_instance(dtype, t, d, s_max, dtype) == want


def test_the_generate_decode_plan_gives_a_split_a_page():
    # 8 rows x 16 kv heads over S_max 1024 (8 implicit pages of 128 rows)
    # on 132 SMs
    assert _plan(8, 1, 16, 16, 64, 1024) == (8, 1)


def test_kernel_4_counts_its_instances():
    for attr in ('launches', 'split_launches', 'tc_launches'):
        assert getattr(tfa.flash_decode, attr) >= 0, attr


def test_the_wrapper_refuses_cpu_tensors():
    q, kc, vc = _cache(1, 1, 2, 2, 128)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_decode(q, kc, vc, 0)


# ---------------------------------------------------------------------------
# the split-K twin
# ---------------------------------------------------------------------------

# (b, t, h, h_kv, d, s_max, pos): pos at page edges (0, 127, 128, 255) and
# near the end, GQA groups of 2 and 4, head dims 64/128/256, S_max 1000 (a
# short last page) and 1024, T up to the split instance's 16
SPLIT_CASES = [
    (2, 1, 4, 4, 64, 1024, 0),
    (2, 1, 4, 2, 64, 1024, 127),
    (2, 2, 8, 2, 128, 1024, 128),
    (3, 1, 4, 1, 256, 1000, 255),
    (2, 16, 8, 4, 64, 1000, 984),
    (2, 3, 4, 2, 128, 1000, 996),
    (1, 1, 2, 2, 256, 1024, 1023),
]


@pytest.mark.parametrize('pps', [1, 3, 8])
@pytest.mark.parametrize('b,t,h,h_kv,d,s_max,pos', SPLIT_CASES)
def test_split_twin_matches_the_twin(b, t, h, h_kv, d, s_max, pos, pps):
    q, kc, vc = _cache(b, t, h, h_kv, s_max, d, seed=pos + t)
    p_max = -(-s_max // tfa.DENSE_PS)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    got = tfa.flash_decode_split_reference(q, kc, vc, pos_t,
                                           -(-p_max // pps), pps)
    want = tfa.flash_decode_reference(q, kc, vc, pos_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize('b,t,h,h_kv,d,s_max,pos', [
    (2, 1, 4, 4, 64, 1024, 0),
    (2, 1, 4, 2, 64, 1024, 127),
    (2, 2, 8, 2, 128, 1024, 128),
    (3, 1, 4, 1, 256, 1024, 700),
    (2, 16, 8, 4, 64, 1024, 1000),
    # S_max 1000: the Pallas kernel walks whole 128-key blocks (7 of them,
    # 896 keys), so its rows stay inside them
    (2, 4, 4, 2, 64, 1000, 300),
    (2, 1, 8, 4, 128, 1000, 895),
])
def test_split_twin_matches_pallas_kernel_4(b, t, h, h_kv, d, s_max, pos):
    q, kc, vc = _cache(b, t, h, h_kv, s_max, d, seed=7 + pos)
    fa.set_interpret(True)
    try:
        want = fa.flash_decode(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                               jnp.asarray(vc.numpy()), jnp.int32(pos))
    finally:
        fa.set_interpret(False)
    n_split, pps = _plan(b, t, h, h_kv, d, s_max)
    got = tfa.flash_decode_split_reference(
        q, kc, vc, torch.tensor([pos], dtype=torch.int32), n_split, pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize('s_max,pos,pps', [(1024, 191, 1), (1024, 700, 2),
                                           (1000, 999, 3)])
def test_split_twin_in_bfloat16_within_two_ulps(s_max, pos, pps):
    q, kc, vc = _cache(2, 1, 4, 2, s_max, seed=pos)
    q, kc, vc = q.to(BF), kc.to(BF), vc.to(BF)
    p_max = -(-s_max // tfa.DENSE_PS)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    got = tfa.flash_decode_split_reference(q, kc, vc, pos_t,
                                           -(-p_max // pps), pps)
    want = tfa.flash_decode_reference(q, kc, vc, pos_t)
    assert got.dtype == BF
    assert _row_err(got, want) <= 2.0 ** -6


def test_one_split_over_one_page_is_the_twin_exactly():
    """A split of one page and one split: the merge only divides acc by
    l, as the twin does, so the two agree to the bit."""
    q, kc, vc = _cache(2, 1, 4, 4, 128, seed=5)
    pos = torch.tensor([77], dtype=torch.int32)
    got = tfa.flash_decode_split_reference(q, kc, vc, pos, 1, 1)
    # the twin's block over S_max 128 is the whole cache, one page
    want = tfa.flash_decode_reference(q, kc, vc, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the C entry point and its ctypes binding
# ---------------------------------------------------------------------------

def _kind(param):
    return ('ptr' if '*' in param else 'i64' if 'long long' in param
            else 'int')


def test_flash_decode_binding_matches_the_c_entry_point(monkeypatch):
    """Kernel 4's entry point takes the split-K tail kernel 5's does: every
    pointer bound as a pointer (a pointer bound as c_int would be cut to 32
    bits) and the counts agree with ``FLASH_DECODE_ARGS``."""
    import ctypes
    src = (CSRC / 'flash_decode.cu').read_text()
    macro = src.partition('#define FLASH_DECODE_ARGS')[2].partition(
        '\n\n')[0].replace('\\', '')
    want = [_kind(p) for p in macro.split(',')]
    assert want[-7:] == ['ptr'] * 4 + ['int'] * 2 + ['ptr']

    def fake(name):
        return types.SimpleNamespace(**{f: types.SimpleNamespace() for f in (
            'flash_decode', 'flash_decode_int8', 'attn_error_string')})

    monkeypatch.setattr(_build, 'load', fake)
    monkeypatch.setattr(tfa, '_libs', {})
    lib = tfa._kernel_lib('flash_decode')
    for entry in ('flash_decode', 'flash_decode_int8'):
        assert f'int {entry}(FLASH_DECODE_ARGS)' in src, entry
        bound = ['int' if t in (ctypes.c_int, ctypes.c_uint32) else
                 'i64' if t is ctypes.c_longlong else 'ptr'
                 for t in getattr(lib, entry).argtypes]
        assert bound == want, entry


def test_flash_decode_source_holds_every_instance():
    src = (CSRC / 'flash_decode.cu').read_text()
    for call in ('launch_split<T, KV, false>',
                 'launch_prefill_tc<KV, false>', 'launch_tile_d<T, KV>',
                 'dense_instances<__nv_bfloat16, __nv_bfloat16>',
                 'dense_instances<float, float>'):
        assert call in src, call
