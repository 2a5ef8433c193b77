"""Kernel 7's split-K decode and its instance choice, on the CPU.

The split-K instance of ``paged_flash_decode_int8`` cuts each slot's pages
into runs, computes one online-softmax state (m, l, acc) per run and merges
them by log-sum-exp. Its plan (split count and partial-buffer shapes)
comes from shapes and the SM count alone, so it is plain Python held here;
its plain twin ``paged_decode_split_reference`` is held against
``paged_decode_int8_reference`` and, through the same inputs, against the
JAX package's Pallas kernel 7 in interpret mode.

Tolerances: split twin vs the int8 twin in float32 2e-6 (the same per-page
arithmetic; only the merge reorders the rescaling, a few f32 roundings);
vs the Pallas kernel 5e-5 (the reference's own bound for its int8
kernels); bfloat16 2^-6 of each row's largest value (p x vs is rounded to
bf16 relative to a split's running max instead of the whole row's)."""
import importlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import weight_only as two

fa = importlib.import_module('paddle_tpu.ops.flash_attention')
jpa = importlib.import_module('paddle_tpu.ops.paged_attention')


# ---------------------------------------------------------------------------
# the plan and the instance rule
# ---------------------------------------------------------------------------

def test_the_engines_decode_plan_gives_a_split_a_page():
    # the bench engine's decode: 8 slots, 16 kv heads, 8 pages a slot, on a
    # card of 132 SMs -> 128 (slot, kv head) pairs x 8 splits of one page
    plan = tpa.split_plan(8, 1, 16, 16, 64, 8, 132)
    assert plan == {'n_split': 8, 'pages_per_split': 1, 'm': (128, 8),
                    'l': (128, 8), 'acc': (128, 8, 64)}


@pytest.mark.parametrize('b,t,h,h_kv,d,p_max,sms', [
    (8, 1, 16, 16, 64, 8, 132),
    (8, 1, 16, 4, 64, 8, 132),
    (1, 1, 4, 4, 128, 64, 132),
    (64, 1, 16, 16, 64, 8, 132),     # enough pairs: one split
    (2, 16, 8, 2, 256, 3, 132),
    (3, 2, 4, 4, 64, 100, 8),
    (1, 1, 2, 1, 64, 1, 132),
])
def test_split_plan_covers_every_page_once(b, t, h, h_kv, d, p_max, sms):
    plan = tpa.split_plan(b, t, h, h_kv, d, p_max, sms)
    n, pps = plan['n_split'], plan['pages_per_split']
    assert 1 <= n <= p_max and pps >= 1
    # the runs [i pps, (i + 1) pps) cover 0 .. P_max - 1, none of them empty
    assert (n - 1) * pps < p_max <= n * pps
    rows = b * t * h
    assert plan['m'] == plan['l'] == (rows, n)
    assert plan['acc'] == (rows, n, d)
    # about SPLIT_BLOCKS_PER_SM blocks an SM, unless pages run out first
    want = tpa.SPLIT_BLOCKS_PER_SM * sms
    assert b * h_kv * n >= min(want, b * h_kv * p_max) // 2 or n == p_max


def test_split_plan_ignores_positions():
    # the plan takes no pos at all: shapes and the SM count only, so a
    # captured launch stays valid as the slots' positions move
    import inspect
    assert 'pos' not in inspect.signature(tpa.split_plan).parameters


@pytest.mark.parametrize('dtype,t,d,ps,want', [
    (torch.bfloat16, 1, 64, 128, 'split-k'),
    (torch.float32, 1, 64, 128, 'split-k'),
    (torch.bfloat16, 16, 256, 128, 'split-k'),
    (torch.float32, 16, 128, 16, 'split-k'),
    (torch.bfloat16, 17, 64, 128, 'tensor-core'),
    (torch.bfloat16, 1024, 64, 128, 'tensor-core'),
    (torch.bfloat16, 300, 128, 64, 'tensor-core'),
    (torch.bfloat16, 1024, 256, 128, 'cuda-core'),
    (torch.float32, 1024, 64, 128, 'cuda-core'),
    (torch.float32, 65, 128, 128, 'cuda-core'),
    (torch.bfloat16, 64, 64, 16, 'cuda-core'),     # pages under 64 rows
])
def test_int8_instance_by_dtype_t_and_head_dim(dtype, t, d, ps, want):
    assert tpa.paged_instance(dtype, t, d, ps, torch.int8) == want


# ---------------------------------------------------------------------------
# the split twin against kernel 7's twin and the Pallas kernel
# ---------------------------------------------------------------------------

PS = 128


def _case(b, t, h, h_kv, pos, p_max, d=64, seed=0, ps=PS):
    """int8 banks quantized by the port, a shuffled table whose unused
    entries point at the trash page 0, and pos [B]."""
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
    kb = dict(zip(('int8', 'scale'), two.quantize_kv(torch.from_numpy(kp))))
    vb = dict(zip(('int8', 'scale'), two.quantize_kv(torch.from_numpy(vp))))
    return (torch.from_numpy(q), kb, vb, torch.from_numpy(table),
            torch.tensor(pos, dtype=torch.int32))


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
def test_split_twin_matches_the_int8_twin(b, t, h, h_kv, pos, p_max, pps):
    # splits of 1..8 pages end inside a slot's needed pages and past them;
    # a split that starts past the last needed page takes no part
    q, kb, vb, table, pos_t = _case(b, t, h, h_kv, pos, p_max)
    n_split = -(-p_max // pps)
    got = tpa.paged_decode_split_reference(q, kb, vb, table, pos_t, n_split,
                                           pps)
    want = tpa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize('b,t,h,h_kv,pos,p_max', SPLIT_CASES[:2])
def test_one_split_is_the_int8_twin_exactly(b, t, h, h_kv, pos, p_max):
    q, kb, vb, table, pos_t = _case(b, t, h, h_kv, pos, p_max, seed=2)
    got = tpa.paged_decode_split_reference(q, kb, vb, table, pos_t, 1,
                                           p_max)
    want = tpa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
    assert torch.equal(got, want)


@pytest.mark.parametrize('pps', [1, 2])
@pytest.mark.parametrize('h,h_kv,t', [(2, 2, 1), (4, 2, 1), (4, 2, 7)])
def test_split_twin_matches_pallas_kernel_7_in_interpret_mode(h, h_kv, t,
                                                             pps):
    p_max = 3
    q, kb, vb, table, pos_t = _case(2, t, h, h_kv, [125, 250], p_max,
                                    seed=5)
    jbank = lambda x: {k: jnp.asarray(v.numpy()) for k, v in x.items()}  # noqa: E731
    fa.set_interpret(True)
    try:
        want = jpa.paged_flash_decode_int8(
            jnp.asarray(q.numpy()), jbank(kb), jbank(vb),
            jnp.asarray(table.numpy()), jnp.asarray(pos_t.numpy()))
    finally:
        fa.set_interpret(False)
    got = tpa.paged_decode_split_reference(q, kb, vb, table, pos_t,
                                           -(-p_max // pps), pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize('b,t,h,h_kv,pos,p_max', SPLIT_CASES[:3])
def test_split_twin_in_bfloat16_within_two_ulps(b, t, h, h_kv, pos, p_max):
    q, kb, vb, table, pos_t = _case(b, t, h, h_kv, pos, p_max, seed=3)
    q = q.to(torch.bfloat16)
    got = tpa.paged_decode_split_reference(q, kb, vb, table, pos_t, p_max, 1)
    want = tpa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
    assert got.dtype == torch.bfloat16
    err = ((got.float() - want.float()).abs().amax(-1)
           / want.float().abs().amax(-1)).max().item()
    assert err <= 2.0 ** -6, err


def test_split_twin_merges_by_log_sum_exp():
    # two splits by hand: the merge weights each split by exp(m_i - max m)
    q, kb, vb, table, pos_t = _case(1, 1, 2, 2, [200], 2, seed=4)
    parts = [tpa._paged_partial(q, kb['int8'], vb['int8'], table, pos_t,
                                kb['scale'], vb['scale'], i, i + 1)
             for i in range(2)]
    (m0, l0, a0, _), (m1, l1, a1, _) = parts
    mx = torch.maximum(m0, m1)
    w0, w1 = torch.exp(m0 - mx), torch.exp(m1 - mx)
    want = ((w0 * a0 + w1 * a1) / (w0 * l0 + w1 * l1)).permute(0, 2, 1, 3)
    got = tpa.paged_decode_split_reference(q, kb, vb, table, pos_t, 2, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-7,
                               atol=1e-7)
    assert math.isfinite(float(got.abs().max()))


# ---------------------------------------------------------------------------
# the C entry points and their ctypes bindings
# ---------------------------------------------------------------------------

CSRC = __import__('pathlib').Path(tpa.__file__).resolve().parent.parent / 'csrc'


def _kind(param):
    """'ptr', 'i64' or 'int' for one C parameter declaration."""
    return ('ptr' if '*' in param else 'i64' if 'long long' in param
            else 'int')


def _c_params(src, entry):
    """The kind of each parameter of ``int entry(...)`` in src."""
    _, _, rest = src.partition(f'int {entry}(')
    return [_kind(p) for p in rest.split(')')[0].split(',')]


def _bound_params(argtypes):
    import ctypes
    return ['int' if t in (ctypes.c_int, ctypes.c_uint32) else
            'i64' if t is ctypes.c_longlong else 'ptr' for t in argtypes]


def test_paged_bindings_match_the_c_entry_points(monkeypatch):
    """Every pointer of the C signatures is bound as a pointer (a pointer
    bound as c_int would be cut to 32 bits) and the counts agree, for the
    entries of kernels 6 and 7 with their partial buffers, tickets,
    instance and SM-sized split arguments, and for kernels 4 and 5's."""
    import types
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as tfa

    def fake(name):
        fns = ('paged_decode', 'paged_decode_int8',
               'paged_decode_error_string', 'flash_decode',
               'flash_decode_int8', 'attn_error_string')
        return types.SimpleNamespace(
            **{f: types.SimpleNamespace() for f in fns})

    monkeypatch.setattr(_build, 'load', fake)
    monkeypatch.setattr(tpa, '_lib', None)
    monkeypatch.setattr(tfa, '_libs', {})
    lib = tpa._kernel_lib()
    src = (CSRC / 'paged_decode.cu').read_text()
    for entry in ('paged_decode', 'paged_decode_int8'):
        assert _bound_params(getattr(lib, entry).argtypes) == _c_params(
            src, entry), entry
    # kernels 4 and 5: the FLASH_DECODE_ARGS macro, the split-K
    # arguments included
    dense = tfa._kernel_lib('flash_decode')
    fsrc = (CSRC / 'flash_decode.cu').read_text()
    macro = fsrc.partition('#define FLASH_DECODE_ARGS')[2].partition(
        '\n\n')[0].replace('\\', '')
    base = [_kind(p) for p in macro.split(',')]
    for entry in ('flash_decode', 'flash_decode_int8'):
        assert f'int {entry}(FLASH_DECODE_ARGS)' in fsrc, entry
        assert _bound_params(getattr(dense, entry).argtypes) == base, entry


@pytest.mark.parametrize('src,names', [
    ('kv_attention.cuh', ('split_kernel', 'prefill_tc_kernel')),
    ('paged_decode.cu', ('paged_decode_kernel',)),
    ('flash_bwd.cu', ('flash_bwd_dq_tc_kernel', 'flash_bwd_dq_kernel',
                      'flash_bwd_dkv_tc_kernel')),
])
def test_kernel_sources_hold_every_instance(src, names):
    text = (CSRC / src).read_text()
    for name in names:
        assert f'{name}(' in text, name
