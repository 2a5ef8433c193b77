"""The Hopper paged-decode kernel against its plain PyTorch twin, on the
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
