"""The port's Hopper kernels against their plain PyTorch twins, on the
card. Needs a CUDA device (marker ``gpu``; skips elsewhere) and imports
neither JAX nor the JAX package, so on a machine with only PyTorch it runs
as ``python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py``.

Tolerances, on each output row's largest error over its largest value:
bfloat16 2**-6 (two ulps), float32 2e-5 — the kernel repeats the twin's
arithmetic; only summation order differs."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import GenerationEngine

TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _case(b, t, h, h_kv, d, pos, dtype, ps=128, p_max=8, seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    n = b * p_max + 1
    q = torch.randn((b, t, h, d), generator=g, device='cuda').to(dtype)
    kp = torch.randn((n, ps, h_kv, d), generator=g, device='cuda').to(dtype)
    vp = torch.randn((n, ps, h_kv, d), generator=g, device='cuda').to(dtype)
    perm = np.random.RandomState(seed).permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    for i, p0 in enumerate(pos):
        need = min(-(-(p0 + t) // ps), p_max)
        table[i, :need] = perm[i * p_max:i * p_max + need]
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.tensor(pos, dtype=torch.int32, device='cuda'))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,t,h,h_kv,d,pos', [
    (8, 1, 16, 16, 64, [0, 1023, 5, 127, 128, 300, 640, 900]),
    (1, 1024, 16, 16, 64, [0]),
    (3, 70, 8, 2, 128, [0, 129, 900]),
    (2, 5, 4, 4, 256, [250, 1000]),
])
def test_kernel_matches_twin(cuda, b, t, h, h_kv, d, pos, dtype):
    args = _case(b, t, h, h_kv, d, pos, dtype)
    before = pa.paged_flash_decode.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == before + 1
    want = pa.paged_decode_reference(*args)
    err = ((got.float() - want.float()).abs().amax(-1)
           / want.float().abs().amax(-1)).max().item()
    assert err <= TOL[dtype], err


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, table, pos = _case(2, 1, 4, 4, 64, [3, 9], torch.bfloat16)
    with pytest.raises(ValueError, match='head_dim'):
        pa.paged_flash_decode(q[..., :32].contiguous(), kp[..., :32]
                              .contiguous(), vp[..., :32].contiguous(),
                              table, pos)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_flash_decode(q, kp.float(), vp.float(), table, pos)
    with pytest.raises(ValueError, match='int32'):
        pa.paged_flash_decode(q, kp, vp, table.long(), pos)
    strided = torch.cat([q, q], dim=-1)[..., :64]     # row stride 128
    with pytest.raises(ValueError, match='contiguous'):
        pa.paged_flash_decode(strided, kp, vp, table, pos)


@pytest.mark.gpu
def test_engine_on_card_streams_equal_cpu(cuda):
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype='float32')
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        params['blocks'][k] = params['blocks'][k] * 10
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (5, 130, 64)]
    streams = {}
    for dev in ('cuda', 'cpu'):
        with GenerationEngine(params, cfg, device=dev, num_slots=2,
                              page_size=128, prefill_width=160) as eng:
            futs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            streams[dev] = [f.result(timeout=300) for f in futs]
    assert streams['cuda'] == streams['cpu']


# ---------------------------------------------------------------------------
# kernels 4, 5 (dense flash decode, bf16/f32 and int8 cache) and 1 (the
# flash-attention forward)
# ---------------------------------------------------------------------------

def _row_err(got, want):
    return ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _dense_case(b, t, h, h_kv, d, s_max, dtype, seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device='cuda').to(dtype)
    kc = torch.randn((b, s_max, h_kv, d), generator=g, device='cuda')
    vc = torch.randn((b, s_max, h_kv, d), generator=g, device='cuda')
    return q, kc, vc


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('b,t,h,h_kv,d,s_max,pos', [
    (8, 1, 16, 16, 64, 1024, 200),
    (8, 128, 16, 16, 64, 1024, 0),
    (2, 300, 4, 2, 128, 512, 100),
    (3, 2, 4, 4, 256, 384, 381),
])
def test_dense_decode_matches_twin(cuda, b, t, h, h_kv, d, s_max, pos, int8,
                                   dtype):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import weight_only as wo
    q, kc, vc = _dense_case(b, t, h, h_kv, d, s_max, dtype)
    pos_t = torch.tensor([pos], dtype=torch.int32, device='cuda')
    if int8:
        kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kc)))
        vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vc)))
        kern, twin = fa.flash_decode_int8, fa.flash_decode_int8_reference
    else:
        kb, vb = kc.to(dtype), vc.to(dtype)
        kern, twin = fa.flash_decode, fa.flash_decode_reference
    before = kern.launches
    got = fa.decode_attention(q, kb, vb, pos_t)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = twin(q, kb, vb, pos_t)
    assert _row_err(got, want) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,s_q,s_k,h,h_kv,d,causal,masked', [
    (2, 1024, 1024, 16, 16, 64, True, False),
    (2, 200, 200, 4, 2, 128, True, False),
    (2, 256, 300, 4, 4, 64, False, True),
    (1, 100, 357, 2, 2, 256, True, False),
])
def test_flash_fwd_matches_twin(cuda, b, s_q, s_k, h, h_kv, d, causal,
                                masked, dtype):
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device='cuda').manual_seed(1)
    # q, k, v as strided views of one packed projection, as _block_qkv
    # returns them
    qkv = torch.randn((b, max(s_q, s_k), h + 2 * h_kv, d), generator=g,
                      device='cuda').to(dtype)
    q, k, v = (qkv[:, :s_q, :h], qkv[:, :s_k, h:h + h_kv],
               qkv[:, :s_k, h + h_kv:])
    kmask = None
    if masked:
        valid = torch.tensor([s_k, s_k - 77], device='cuda')[:, None]
        kmask = torch.where(torch.arange(s_k, device='cuda')[None] < valid,
                            0.0, -1e30)
    q_off = (s_k - s_q) if causal else 0
    before = fa.flash_fwd.launches
    out, lse = fa._flash_fwd(q, k, v, causal, q_off=q_off, kmask=kmask)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_o, want_l = fa.flash_fwd_reference(q, k, v, causal, q_off=q_off,
                                            kmask=kmask)
    assert _row_err(out, want_o) <= TOL[dtype]
    assert (lse - want_l).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, kc, vc = _dense_case(2, 1, 4, 4, 64, 256, torch.bfloat16)
    kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    pos = torch.tensor([3], dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_decode(q[..., :32].contiguous(), kc[..., :32].contiguous(),
                        vc[..., :32].contiguous(), pos)
    with pytest.raises(ValueError, match='caches must be'):
        fa.flash_decode(q, kc.float(), vc.float(), pos)
    with pytest.raises(ValueError, match='int32'):
        fa.flash_decode(q, kc, vc, pos.long())
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_fwd(q[..., :48].contiguous(), kc[..., :48].contiguous(),
                     vc[..., :48].contiguous(), True)


# ---------------------------------------------------------------------------
# kernel 1's dropout, kernels 2 and 3 (the flash backward) and kernel 7
# (paged decode over int8 pages)
# ---------------------------------------------------------------------------

def _grad_err(got, want):
    """``_row_err`` with each row's scale floored at 1% of the tensor's
    largest value: a gradient row can be pure cancellation (causal dq row
    0: ds = p * (dp - delta) with p = 1 and dp = delta), rounding noise on
    both sides, and noise over noise says nothing."""
    w = want.float()
    scale = w.abs().amax(-1).clamp_min(0.01 * w.abs().max().item() + 1e-30)
    return ((got.float() - w).abs().amax(-1) / scale).max().item()


def _qkv(b, s_q, s_k, h, h_kv, d, dtype, seed=1):
    """q, k, v as strided views of one packed projection, and dO."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    qkv = torch.randn((b, max(s_q, s_k), h + 2 * h_kv, d), generator=g,
                      device='cuda').to(dtype)
    do = torch.randn((b, s_q, h, d), generator=g, device='cuda').to(dtype)
    return (qkv[:, :s_q, :h], qkv[:, :s_k, h:h + h_kv],
            qkv[:, :s_k, h + h_kv:], do)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,s_q,s_k,h,h_kv,d,causal,masked,drop', [
    (2, 1024, 1024, 16, 16, 64, True, False, 0.0),
    (2, 1024, 1024, 16, 16, 64, True, False, 0.1),
    (2, 200, 200, 4, 2, 128, True, False, 0.0),
    (2, 256, 300, 4, 4, 64, False, True, 0.25),
    (1, 100, 357, 2, 2, 256, True, False, 0.0),
])
def test_flash_backward_and_dropout_match_twins(cuda, b, s_q, s_k, h, h_kv,
                                                d, causal, masked, drop,
                                                dtype):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(b, s_q, s_k, h, h_kv, d, dtype)
    kmask = None
    if masked:
        valid = torch.tensor([s_k, s_k - 77], device='cuda')[:, None]
        kmask = torch.where(torch.arange(s_k, device='cuda')[None] < valid,
                            0.0, -1e30)
    q_off = (s_k - s_q) if causal else 0
    args = (causal, q_off, None, kmask, drop, 2 ** 31 + 12345)
    out, lse = fa._flash_fwd(q, k, v, *args)
    want_o, want_l = fa.flash_fwd_reference(q, k, v, *args)
    assert _row_err(out, want_o) <= TOL[dtype]
    assert (lse - want_l).abs().max().item() <= 1e-4
    # the backward kernels and their twin on the same out and lse
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq, dk, dv = fa._flash_bwd(q, k, v, do, out, lse, *args)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    delta = fa.bwd_delta(out, do)
    want = fa.flash_bwd_reference(q, k, v, do, lse, delta, *args)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _grad_err(got, ref) <= TOL[dtype]


@pytest.mark.gpu
def test_flash_attention_autograd_runs_the_kernels(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(2, 256, 256, 4, 2, 64, torch.float32)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(*leaves, causal=True, dropout_rate=0.1,
                             dropout_seed=7)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    ref = fa.flash_attention(*cpu, causal=True, dropout_rate=0.1,
                             dropout_seed=7)
    ref.backward(do.cpu())
    assert _row_err(out.detach().cpu(), ref.detach()) <= 2e-5
    for a, c in zip(leaves, cpu):
        assert _grad_err(a.grad.cpu(), c.grad) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,t,h,h_kv,d,pos', [
    (8, 1, 16, 16, 64, [0, 1023, 5, 127, 128, 300, 640, 900]),
    (1, 1024, 16, 16, 64, [0]),
    (3, 70, 8, 2, 128, [0, 129, 900]),
    (2, 5, 4, 4, 256, [250, 1000]),
])
def test_int8_paged_kernel_matches_twin(cuda, b, t, h, h_kv, d, pos, dtype):
    from paddle_tpu_torch.ops import weight_only as wo
    q, kp, vp, table, pos_t = _case(b, t, h, h_kv, d, pos, torch.float32)
    kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kp)))
    vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vp)))
    q = q.to(dtype)
    before = pa.paged_flash_decode_int8.launches
    got = pa.paged_attention(q, kb, vb, table, pos_t)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_int8.launches == before + 1
    want = pa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
    assert _row_err(got, want) <= TOL[dtype]


@pytest.mark.gpu
def test_new_training_kernels_refuse_what_they_do_not_take(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(2, 128, 128, 4, 4, 64, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(out, do)
    with pytest.raises(ValueError, match='dO'):
        fa.flash_bwd_dq(q, k, v, do.float(), lse, delta, True)
    with pytest.raises(ValueError, match='lse'):
        fa.flash_bwd_dkv(q, k, v, do, lse.transpose(1, 2), delta, True)
    kp = torch.zeros((3, 128, 4, 64), dtype=torch.int8, device='cuda')
    bank = {'int8': kp, 'scale': torch.zeros((3, 128, 4), device='cuda')}
    table = torch.ones((2, 1), dtype=torch.int32, device='cuda')
    pos = torch.zeros(2, dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='scale'):
        pa.paged_flash_decode_int8(q[:, :1].contiguous(), bank,
                                   dict(bank, scale=bank['scale'].double()),
                                   table, pos)


# ---------------------------------------------------------------------------
# the bf16 tensor-core instances of kernels 1 (forward) and 3 (dK/dV): the
# cases a wrong fragment layout, swizzle, ring phase or mask breaks
# ---------------------------------------------------------------------------

TC_SEED = 2 ** 31 + 99991          # a u32 past the int32 range


@pytest.mark.gpu
@pytest.mark.parametrize('b,s_q,s_k,h,h_kv,d,causal,masked,kv_valid,drop', [
    (2, 130, 130, 4, 4, 64, True, False, None, 0.0),     # S past 128-row tiles
    (2, 300, 300, 4, 4, 64, True, False, None, 0.0),
    (2, 100, 357, 4, 4, 64, True, False, None, 0.0),     # S_q < S_k, q_off 257
    (2, 256, 300, 4, 4, 64, False, True, 250, 0.0),      # kv_valid, key mask
    (2, 200, 200, 4, 2, 64, True, False, None, 0.0),     # GQA groups of 2
    (1, 256, 256, 8, 2, 128, True, False, None, 0.0),    # groups of 4, D 128
    (1, 300, 300, 2, 2, 128, False, False, None, 0.0),
    (1, 200, 200, 2, 2, 256, True, False, None, 0.0),    # D 256
    (2, 1024, 1024, 4, 4, 64, True, False, None, 0.1),   # dropout 0.1
    (2, 300, 300, 4, 2, 128, True, True, None, 0.25),    # dropout 0.25
], ids=['s130', 's300', 'q_off257', 'kv_valid_mask_noncausal', 'gqa2',
        'gqa4_d128', 'noncausal_d128', 'd256', 'drop0.1', 'drop0.25_d128'])
def test_tensor_core_kernels_match_twins(cuda, b, s_q, s_k, h, h_kv, d,
                                         causal, masked, kv_valid, drop):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(b, s_q, s_k, h, h_kv, d, torch.bfloat16, seed=3)
    kmask = None
    if masked:
        valid = torch.tensor([s_k, s_k - 77], device='cuda')[:b, None]
        kmask = torch.where(torch.arange(s_k, device='cuda')[None] < valid,
                            0.0, -1e30)
    q_off = (s_k - s_q) if causal else 0
    args = (causal, q_off, kv_valid, kmask, drop, TC_SEED if drop else None)
    before = fa.flash_fwd.tc_launches
    out, lse = fa.flash_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert fa.flash_fwd.tc_launches == before + 1
    want_o, want_l = fa.flash_fwd_reference(q, k, v, *args)
    assert _row_err(out, want_o) <= TOL[torch.bfloat16]
    assert (lse - want_l).abs().max().item() <= 1e-4
    # kernels 2 and 3 on kernel 1's own out and lse; D = 256 keeps their
    # CUDA-core instances (kernel 3's f32 dK and dV would not fit the
    # registers, kernel 2's q and dO tile and ring not shared memory)
    delta = fa.bwd_delta(out, do)
    before = (fa.flash_bwd_dq.tc_launches, fa.flash_bwd_dkv.tc_launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    tc = int(d in (64, 128))
    assert (fa.flash_bwd_dq.tc_launches, fa.flash_bwd_dkv.tc_launches) == (
        before[0] + tc, before[1] + tc)
    want_dq, want_dk, want_dv = fa.flash_bwd_reference(q, k, v, do, lse,
                                                       delta, *args)
    for got, ref in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _grad_err(got, ref) <= TOL[torch.bfloat16]


@pytest.mark.gpu
def test_float32_keeps_the_cuda_core_instances(cuda):
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(1, 130, 130, 2, 2, 64, torch.float32)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [(f.launches, f.tc_launches) for f in kernels]
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(out, do)
    fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert [(f.launches, f.tc_launches) for f in kernels] == [
        (n + 1, tc) for n, tc in before]


@pytest.mark.gpu
def test_a_batch_broadcast_gradient_reaches_the_tensor_core_backward(cuda):
    """out.sum(0).backward(g) hands the backward dO = g expanded over the
    batch (a zero stride), which kernel 3's TMA maps do not describe: the
    backward copies it out first, and the gradients match the twin's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkv(2, 130, 130, 2, 2, 64, torch.bfloat16)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = fa.flash_bwd_dkv.tc_launches
    fa.flash_attention(*leaves, causal=True).sum(0).backward(do[0])
    torch.cuda.synchronize()
    assert fa.flash_bwd_dkv.tc_launches == before + 1
    out, lse = fa.flash_fwd(q, k, v, True)
    g = do[0].expand_as(out).contiguous()
    want = fa.flash_bwd_reference(q, k, v, g, lse, fa.bwd_delta(out, g),
                                  True)
    for leaf, ref in zip(leaves, want):
        assert _grad_err(leaf.grad, ref) <= TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# kernel 7's instances over int8 pages: split-K decode (T <= 16), the
# tensor-core prefill (bf16, D 64/128) and the CUDA-core kernel (f32 at
# large T, D 256)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('b,t,h,h_kv,d,pos,dtype,instance', [
    (4, 1, 16, 16, 64, [0, 127, 128, 1023], torch.bfloat16, 'split-k'),
    (4, 1, 16, 4, 64, [0, 127, 128, 1023], torch.bfloat16, 'split-k'),
    (4, 2, 8, 2, 128, [0, 127, 128, 1000], torch.bfloat16, 'split-k'),
    (2, 16, 8, 2, 256, [127, 900], torch.bfloat16, 'split-k'),
    (4, 1, 16, 16, 64, [0, 127, 128, 1023], torch.float32, 'split-k'),
    (2, 16, 4, 4, 128, [128, 1000], torch.float32, 'split-k'),
    (2, 17, 16, 4, 64, [0, 127], torch.bfloat16, 'tensor-core'),
    (2, 64, 8, 2, 128, [128, 900], torch.bfloat16, 'tensor-core'),
    (2, 65, 8, 8, 64, [127, 300], torch.bfloat16, 'tensor-core'),
    (2, 300, 16, 4, 64, [0, 517], torch.bfloat16, 'tensor-core'),
    (1, 1024, 16, 16, 64, [0], torch.bfloat16, 'tensor-core'),
    (1, 1024, 4, 2, 128, [0], torch.bfloat16, 'tensor-core'),
    (2, 300, 4, 2, 256, [0, 517], torch.bfloat16, 'cuda-core'),
    (2, 65, 8, 2, 64, [127, 128], torch.float32, 'cuda-core'),
    (1, 1024, 4, 4, 64, [0], torch.float32, 'cuda-core'),
], ids=['T1', 'T1_gqa4', 'T2_gqa4_d128', 'T16_gqa4_d256', 'T1_f32',
        'T16_f32_d128', 'T17_gqa4', 'T64_gqa4_d128', 'T65', 'T300_gqa4',
        'T1024', 'T1024_gqa2_d128', 'T300_d256', 'T65_f32', 'T1024_f32'])
def test_int8_paged_instances_match_twin(cuda, b, t, h, h_kv, d, pos, dtype,
                                         instance):
    """Each instance against kernel 7's twin: pos at page edges, a shuffled
    table whose unused entries point at the trash page, GQA groups of 4
    and 2."""
    from paddle_tpu_torch.ops import weight_only as wo
    q, kp, vp, table, pos_t = _case(b, t, h, h_kv, d, pos, torch.float32)
    kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kp)))
    vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vp)))
    q = q.to(dtype)
    assert pa.paged_instance(dtype, t, d, kp.shape[1], torch.int8) == instance
    k7 = pa.paged_flash_decode_int8
    before = (k7.launches, k7.split_launches, k7.tc_launches)
    got = pa.paged_attention(q, kb, vb, table, pos_t)
    torch.cuda.synchronize()
    assert (k7.launches, k7.split_launches, k7.tc_launches) == (
        before[0] + 1, before[1] + (instance == 'split-k'),
        before[2] + (instance == 'tensor-core'))
    want = pa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
    assert got.dtype == dtype and got.shape == want.shape
    assert _row_err(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# kernel 6's instances over bf16/f32 pages (split-K decode, tensor-core
# prefill, the CUDA-core kernel at any page size), the prefill padding
# (valid) on kernels 6 and 7, and kernel 5's instances over the dense int8
# cache
# ---------------------------------------------------------------------------

def _counts(kern):
    return (kern.launches, kern.split_launches, kern.tc_launches)


def _expect(kern, before, instance):
    assert _counts(kern) == (before[0] + 1,
                             before[1] + (instance == 'split-k'),
                             before[2] + (instance == 'tensor-core'))


@pytest.mark.gpu
@pytest.mark.parametrize('b,t,h,h_kv,d,pos,dtype,ps,instance', [
    (8, 1, 16, 16, 64, [0, 1023, 5, 127, 128, 300, 640, 900],
     torch.bfloat16, 128, 'split-k'),
    (4, 1, 16, 4, 64, [0, 127, 128, 1023], torch.bfloat16, 128, 'split-k'),
    (4, 2, 8, 2, 128, [0, 127, 128, 1000], torch.bfloat16, 128, 'split-k'),
    (2, 16, 8, 2, 256, [127, 900], torch.bfloat16, 128, 'split-k'),
    (4, 1, 16, 16, 64, [0, 127, 128, 1023], torch.float32, 128, 'split-k'),
    (2, 16, 4, 4, 256, [128, 1000], torch.float32, 128, 'split-k'),
    (2, 3, 4, 2, 128, [0, 1020], torch.bfloat16, 512, 'split-k'),
    (2, 17, 16, 4, 64, [0, 127], torch.bfloat16, 128, 'tensor-core'),
    (2, 64, 8, 2, 128, [128, 900], torch.bfloat16, 128, 'tensor-core'),
    (2, 300, 16, 4, 64, [0, 517], torch.bfloat16, 128, 'tensor-core'),
    (1, 1024, 16, 16, 64, [0], torch.bfloat16, 128, 'tensor-core'),
    (1, 1024, 4, 2, 128, [0], torch.bfloat16, 128, 'tensor-core'),
    (2, 200, 4, 2, 128, [0, 700], torch.bfloat16, 512, 'tensor-core'),
    (2, 300, 4, 2, 256, [0, 517], torch.bfloat16, 128, 'cuda-core'),
    (2, 65, 8, 2, 64, [127, 128], torch.float32, 128, 'cuda-core'),
    (2, 70, 4, 4, 64, [0, 300], torch.bfloat16, 16, 'cuda-core'),
], ids=['T1', 'T1_gqa4', 'T2_gqa4_d128', 'T16_gqa4_d256', 'T1_f32',
        'T16_f32_d256', 'T3_ps512', 'T17_gqa4', 'T64_gqa4_d128', 'T300_gqa4',
        'T1024', 'T1024_gqa2_d128', 'T200_ps512_d128', 'T300_d256',
        'T65_f32', 'T70_ps16'])
def test_kernel_6_instances_match_twin(cuda, b, t, h, h_kv, d, pos, dtype,
                                       ps, instance):
    p_max = -(-1024 // ps)
    args = _case(b, t, h, h_kv, d, pos, dtype, ps=ps, p_max=p_max)
    assert pa.paged_instance(dtype, t, d, ps, dtype) == instance
    before = _counts(pa.paged_flash_decode)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    _expect(pa.paged_flash_decode, before, instance)
    want = pa.paged_decode_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert _row_err(got, want) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ps,d,t,pos', [
    (512, 128, 300, [0, 600]),
    (1024, 64, 300, [0, 700]),
    (512, 128, 100, [1, 1023]),
], ids=['ps512_d128', 'ps1024_d64', 'ps512_d128_late'])
def test_large_pages_launch_on_every_instance(cuda, ps, d, t, pos, dtype):
    """Q3.2: the CUDA-core kernel (f32 at T > 16) streams each page in
    64-key chunks, so its shared memory no longer grows with the page
    size; bf16 takes the tensor-core prefill at the same pages."""
    args = _case(2, t, 4, 2, d, pos, dtype, ps=ps, p_max=-(-1024 // ps) + 1)
    want_inst = 'cuda-core' if dtype == torch.float32 else 'tensor-core'
    before = _counts(pa.paged_flash_decode)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    _expect(pa.paged_flash_decode, before, want_inst)
    assert _row_err(got, pa.paged_decode_reference(*args)) <= TOL[dtype]
    # kernel 7's CUDA-core instance at the same pages (f32 q)
    if dtype == torch.float32:
        from paddle_tpu_torch.ops import weight_only as wo
        q, kp, vp, table, pos_t = args
        kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kp)))
        vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vp)))
        got = pa.paged_attention(q, kb, vb, table, pos_t)
        want = pa.paged_decode_int8_reference(q, kb, vb, table, pos_t)
        assert _row_err(got, want) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('t,d,dtype,valid', [
    (1024, 64, torch.bfloat16, [5, 129, 1024]),     # tensor-core
    (300, 128, torch.bfloat16, [1, 200, 64]),
    (300, 64, torch.float32, [70, 1, 300]),         # CUDA-core
    (200, 256, torch.bfloat16, [3, 150, 64]),
    (12, 64, torch.bfloat16, [4, 12, 0]),           # split-K
], ids=['T1024_tc', 'T300_tc_d128', 'T300_f32_cuda_core',
        'T200_d256_cuda_core', 'T12_split'])
def test_valid_skips_the_padding_and_zeroes_it(cuda, t, d, dtype, valid,
                                               int8):
    """Rows below valid[b] as without it, within tolerance of the twin;
    rows at or past it exactly zero, on every instance of kernels 6 and
    7."""
    from paddle_tpu_torch.ops import weight_only as wo
    q, kp, vp, table, pos = _case(3, t, 4, 2, d, [0, 0, 0], torch.float32)
    q = q.to(dtype)
    if int8:
        kp = dict(zip(('int8', 'scale'), wo.quantize_kv(kp)))
        vp = dict(zip(('int8', 'scale'), wo.quantize_kv(vp)))
        twin = pa.paged_decode_int8_reference
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
        twin = pa.paged_decode_reference
    v = torch.tensor(valid, dtype=torch.int32, device='cuda')
    got = pa.paged_attention(q, kp, vp, table, pos, v)
    torch.cuda.synchronize()
    want = twin(q, kp, vp, table, pos, valid=v)
    full = pa.paged_attention(q, kp, vp, table, pos)
    for i, n in enumerate(valid):
        assert not got[i, n:].any()
        assert torch.equal(got[i, :n], full[i, :n])
    assert _row_err(got[:, :max(valid)], want[:, :max(valid)]) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('int8', [False, True])
def test_split_merge_leaves_its_tickets_zero(cuda, int8):
    """The last split of each (slot, kv head) to finish merges; every launch
    finds the tickets zero and leaves them so."""
    from paddle_tpu_torch.ops import weight_only as wo
    q, kp, vp, table, pos = _case(8, 1, 16, 4, 64,
                                  [0, 1023, 5, 127, 128, 300, 640, 900],
                                  torch.float32)
    q = q.to(torch.bfloat16)
    if int8:
        kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kp)))
        vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vp)))
        kern, twin = pa.paged_flash_decode_int8, pa.paged_decode_int8_reference
    else:
        kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        kern, twin = pa.paged_flash_decode, pa.paged_decode_reference
    want = twin(q, kb, vb, table, pos)
    for _ in range(3):
        got = kern(q, kb, vb, table, pos)
        torch.cuda.synchronize()
        assert _row_err(got, want) <= TOL[torch.bfloat16]
        assert not pa._tickets(q.device, 8 * 4).any()


def _packed_q(b, t, h, d, dtype, seed=2):
    """q as generate() hands it over: a strided view of the packed qkv
    projection [B, T, H_kv, g + 2, D] (MHA: a view, no copy)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((b, t, h, 3, d), generator=g, device='cuda').to(dtype)
    return x[..., 0, :]


@pytest.mark.gpu
@pytest.mark.parametrize('b,t,h,h_kv,d,s_max,pos,dtype,instance', [
    (8, 1, 16, 16, 64, 1024, 191, torch.bfloat16, 'split-k'),
    (8, 1, 16, 16, 64, 1024, 1023, torch.bfloat16, 'split-k'),
    (4, 2, 8, 2, 128, 512, 400, torch.float32, 'split-k'),
    (2, 16, 8, 2, 256, 200, 150, torch.bfloat16, 'split-k'),
    (8, 128, 16, 16, 64, 1024, 0, torch.bfloat16, 'tensor-core'),
    (2, 300, 8, 2, 128, 512, 100, torch.bfloat16, 'tensor-core'),
    (2, 128, 4, 4, 64, 1000, 0, torch.bfloat16, 'cuda-core'),
    (2, 128, 4, 4, 64, 1024, 0, torch.float32, 'cuda-core'),
], ids=['T1_pos191', 'T1_pos1023', 'T2_f32_gqa_d128', 'T16_d256_smax200',
        'T128_tc', 'T300_tc_d128', 'T128_smax1000', 'T128_f32'])
def test_kernel_5_instances_match_twin(cuda, b, t, h, h_kv, d, s_max, pos,
                                       dtype, instance):
    """Kernel 5 over the dense int8 cache (split-K: 128-row pages), q a
    strided view of the packed projection (MHA) or contiguous (GQA),
    against its twin per row."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import weight_only as wo
    _, kc, vc = _dense_case(b, t, h, h_kv, d, s_max, dtype)
    q = (_packed_q(b, t, h, d, dtype) if h == h_kv else
         torch.randn((b, t, h, d), device='cuda').to(dtype))
    kb = dict(zip(('int8', 'scale'), wo.quantize_kv(kc)))
    vb = dict(zip(('int8', 'scale'), wo.quantize_kv(vc)))
    pos_t = torch.tensor([pos], dtype=torch.int32, device='cuda')
    assert pa.paged_instance(dtype, t, d, s_max, torch.int8) == instance
    before = _counts(fa.flash_decode_int8)
    got = fa.flash_decode_int8(q, kb, vb, pos_t)
    torch.cuda.synchronize()
    _expect(fa.flash_decode_int8, before, instance)
    want = fa.flash_decode_int8_reference(q, kb, vb, pos_t)
    assert got.dtype == dtype and got.shape == want.shape
    assert _row_err(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# kernel 4 on the split-K and tensor-core templates; captured CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('b,t,h,h_kv,d,s_max,pos,dtype,instance', [
    (8, 1, 16, 16, 64, 1024, 191, torch.bfloat16, 'split-k'),
    (8, 1, 16, 16, 64, 1024, 1023, torch.bfloat16, 'split-k'),
    (4, 2, 8, 2, 128, 1024, 127, torch.bfloat16, 'split-k'),
    (2, 16, 8, 4, 256, 1000, 984, torch.bfloat16, 'split-k'),
    (4, 1, 8, 2, 64, 1000, 128, torch.float32, 'split-k'),
    (2, 16, 4, 4, 256, 512, 300, torch.float32, 'split-k'),
    (8, 128, 16, 16, 64, 1024, 0, torch.bfloat16, 'tensor-core'),
    (2, 300, 8, 2, 128, 512, 100, torch.bfloat16, 'tensor-core'),
    (2, 1000, 16, 16, 64, 1024, 0, torch.bfloat16, 'tensor-core'),
    (2, 128, 4, 4, 64, 1000, 0, torch.bfloat16, 'cuda-core'),
    (2, 70, 4, 2, 256, 512, 30, torch.bfloat16, 'cuda-core'),
    (2, 128, 4, 4, 64, 1024, 0, torch.float32, 'cuda-core'),
], ids=['T1_pos191', 'T1_pos1023', 'T2_gqa_d128', 'T16_d256_smax1000',
        'T1_f32_smax1000', 'T16_f32_d256', 'T128_tc', 'T300_tc_gqa_d128',
        'T1000_tc', 'T128_smax1000', 'T70_d256', 'T128_f32'])
def test_kernel_4_instances_match_twin(cuda, b, t, h, h_kv, d, s_max, pos,
                                       dtype, instance):
    """Kernel 4 over the dense bf16/f32 cache, q a strided view of the
    packed projection (MHA) or contiguous (GQA), against its twin per row
    on every instance, and the split-K instance against its split twin at
    the wrapper's plan."""
    from paddle_tpu_torch.ops import flash_attention as fa
    _, kc, vc = _dense_case(b, t, h, h_kv, d, s_max, dtype)
    kc, vc = kc.to(dtype), vc.to(dtype)
    q = (_packed_q(b, t, h, d, dtype) if h == h_kv else
         torch.randn((b, t, h, d), device='cuda').to(dtype))
    pos_t = torch.tensor([pos], dtype=torch.int32, device='cuda')
    assert pa.paged_instance(dtype, t, d, s_max, dtype) == instance
    before = _counts(fa.flash_decode)
    got = fa.flash_decode(q, kc, vc, pos_t)
    torch.cuda.synchronize()
    _expect(fa.flash_decode, before, instance)
    want = fa.flash_decode_reference(q, kc, vc, pos_t)
    assert got.dtype == dtype and got.shape == want.shape
    assert _row_err(got, want) <= TOL[dtype]
    if instance == 'split-k':
        plan = pa.split_plan(b, t, h, h_kv, d, -(-s_max // fa.DENSE_PS),
                             pa._sm_count(q.device))
        split = fa.flash_decode_split_reference(
            q, kc, vc, pos_t, plan['n_split'], plan['pages_per_split'])
        assert _row_err(got, split) <= TOL[dtype]


def _small_gpt(int8=False, dtype='bfloat16'):
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=dtype,
                        kv_cache_int8=int8)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        params['blocks'][k] = params['blocks'][k] * 10
    return cfg, params


def _serve(cfg, params, capture, prompts, new=10):
    eng = GenerationEngine(params, cfg, device='cuda', num_slots=2,
                           page_size=128, autostart=False)
    eng._capture = capture
    rep = eng.warmup()
    traces = eng._trace_count
    with eng:
        futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        out = [f.result(timeout=300) for f in futs]
    st = eng.stats()
    return out, rep, traces, eng._trace_count, st


@pytest.mark.gpu
@pytest.mark.parametrize('int8', [False, True])
def test_captured_engine_equals_eager_token_for_token(cuda, int8):
    cfg, params = _small_gpt(int8)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (5, 130, 64)]
    eager = _serve(cfg, params, False, prompts)
    graphs = _serve(cfg, params, True, prompts)
    assert graphs[0] == eager[0]
    # two captures at warmup, none from live traffic
    assert graphs[1]['prebuilt'] == 2 and graphs[2] == graphs[3] == 2


@pytest.mark.gpu
def test_replays_count_the_launches_they_hold(cuda):
    """Each replay adds the launches its graph holds: after warmup, the
    engine's kernel 6 counts 2 layers x (prefills + steps), the prefills
    on the tensor-core instance, the steps on the split-K one."""
    cfg, params = _small_gpt()
    eng = GenerationEngine(params, cfg, device='cuda', num_slots=2,
                           page_size=128, autostart=False)
    eng.warmup()
    k6 = pa.paged_flash_decode
    k6.launches = k6.split_launches = k6.tc_launches = 0
    rng = np.random.RandomState(2)
    with eng:
        for f in [eng.submit(rng.randint(0, 512, size=n).astype(np.int32),
                             max_new_tokens=6) for n in (7, 40)]:
            f.result(timeout=300)
    torch.cuda.synchronize()
    st = eng.stats()
    assert eng._fns['step'].captured and eng._fns['prefill'].captured
    assert (k6.launches, k6.tc_launches, k6.split_launches) == (
        2 * (st['prefills'] + st['steps']), 2 * st['prefills'],
        2 * st['steps'])


@pytest.mark.gpu
@pytest.mark.parametrize('int8', [False, True])
def test_captured_generate_equals_eager_token_for_token(cuda, int8):
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg, params = _small_gpt(int8)
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (3, 40)).astype(np.int32))
    outs = {}
    for capture in (False, True):
        m = gpt.GPTForCausalLM(cfg, params, device='cuda')
        m._capture = capture
        m.generate(prompt, max_new_tokens=2, temperature=0)   # captures
        kern = fa.flash_decode_int8 if int8 else fa.flash_decode
        kern.launches = kern.split_launches = kern.tc_launches = 0
        outs[capture] = m.generate(prompt, max_new_tokens=20,
                                   temperature=0).cpu()
        torch.cuda.synchronize()
        # the prefill (T 40, bf16) on the tensor-core instance, 19 steps on
        # the split-K one, 2 layers each
        assert (kern.launches, kern.tc_launches, kern.split_launches) == (
            2 * 20, 2, 2 * 19)
        # sampled: the same draws with or without graphs
        outs[capture, 'sampled'] = m.generate(
            prompt, max_new_tokens=12, temperature=0.8, top_k=40,
            seed=5).cpu()
    assert torch.equal(outs[True], outs[False])
    assert torch.equal(outs[True, 'sampled'], outs[False, 'sampled'])


@pytest.mark.gpu
def test_captured_engine_serves_again_after_a_device_failure(cuda):
    """A failed call zeroes the pool in place; the graphs, which hold its
    addresses, serve the same streams again without a new capture."""
    from paddle_tpu_torch import fault
    cfg, params = _small_gpt()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (9, 70)]
    base = _serve(cfg, params, True, prompts)[0]
    eng = GenerationEngine(params, cfg, device='cuda', num_slots=2,
                           page_size=128)
    eng.warmup()
    eng.submit(prompts[0], max_new_tokens=10).result(timeout=300)
    fault.configure('gen.step:1.0', seed=0, max_faults=1)
    try:
        bad = eng.submit(prompts[1], max_new_tokens=10)
        assert isinstance(bad.exception(timeout=300), fault.InjectedFault)
    finally:
        fault.configure(None)
    assert not any(bool(t.any()) for t in (eng._pool['k'], eng._pool['v']))
    futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    assert [f.result(timeout=300) for f in futs] == base
    eng.shutdown()
    assert eng._trace_count == 2
