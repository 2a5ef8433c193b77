"""The port's MoE GPT served by ``GenerationEngine`` (paddle_tpu_torch/
serving/generation.py over models/moe_gpt.py) against the JAX package's
engine on the same ``(params, MoEConfig)``, on the CPU at 2 layers in
float32: greedy streams equal token for token.

Capacity couples the rows of a call. A prefill pads its prompt to
``prefill_width`` rows, and in the reference a padding row's first choice
takes expert capacity that decides which real rows keep their second
choice; the port's padding rows are not the reference's (its attention
writes zeros for them), so the two engines are held equal where the
padding cannot matter: (a) at the default capacity factor with prompts
that fill the prefill width, and (b) with ragged prompts at capacity
factor 8 (no token dropped). Decode steps route all slots together, idle
slots included (token 0 at position 0), on both sides."""
import dataclasses

import numpy as np
import pytest

import jax
import torch

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import moe_gpt as jmoe
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import moe_gpt as tmoe
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.parallel import moe as tpm
from paddle_tpu_torch.serving import GenerationEngine

V, PS, WIDTH = 128, 8, 16
_BASE = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4,
             n_experts=4, max_seq_len=48, dtype='float32', remat=False,
             use_flash=False, xent_chunk=0)


def _model(**over):
    cfg = jmoe.MoEConfig(**dict(_BASE, **over))
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.init_params(cfg, jax.random.PRNGKey(1)))
    # x4 on the block matrices so streams depend on their context
    for k in ('qkv_w', 'proj_w', 'gate_w', 'w_in', 'w_out'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(4)
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(cfg))
    return cfg, jp, tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu')


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=t).astype(np.int32) for t in lens]


def _run(engine, prompts, n_new):
    """Every request queued before the scheduler starts: a MoE step routes
    its slots together, so which requests share a step must not depend on
    thread timing (both engines then admit and step in the same order)."""
    futs = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    with engine.start() as eng:
        return [f.result(timeout=120) for f in futs], eng.stats()


def _kw(**over):
    return dict(dict(num_slots=2, page_size=PS, prefill_width=WIDTH,
                     autostart=False), **over)


CASES = {
    # (a) the default capacity, every prompt fills the prefill width
    'full_width_cf1.25': (dict(), [WIDTH] * 4, 2),
    # idle slots (token 0 at position 0, all writing the trash page's row
    # 0) compete with the real ones for capacity
    'full_width_cf1.25_idle_slots': (dict(), [WIDTH] * 2, 4),
    # (b) ragged prompts with no token dropped
    'ragged_cf8': (dict(capacity_factor=8.0), [9, 3, 14, 6], 2),
    'ragged_cf8_int8_pool': (dict(capacity_factor=8.0, kv_cache_int8=True),
                             [9, 3, 14, 6], 2),
    'full_width_gqa_int8_pool': (dict(num_kv_heads=2, kv_cache_int8=True),
                                 [WIDTH] * 3, 2),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_engine_greedy_streams_equal_reference(case):
    over, lens, slots = CASES[case]
    cfg, jp, tcfg, tp = _model(**over)
    prompts = _prompts(lens, seed=len(case))
    want, _ = _run(JEngine(jp, cfg, **_kw(num_slots=slots)), prompts, 12)
    got, st = _run(GenerationEngine(tp, tcfg, device='cpu',
                                    **_kw(num_slots=slots)), prompts, 12)
    assert got == want
    assert st['completed'] == len(prompts) and st['traces'] == 2
    assert st['free_pages'] == st['num_pages'] - 1
    assert len({tuple(s) for s in got}) == len(got)


@pytest.mark.parametrize('case', ['full_width_cf1.25', 'ragged_cf8'])
def test_int8_wo_engine_streams_equal_reference(case):
    over, lens, _ = CASES[case]
    cfg, jp, tcfg, tp = _model(**over)
    prompts = _prompts(lens, seed=7)
    want, _ = _run(JEngine(jp, cfg, precision='int8_wo', **_kw()), prompts,
                   12)
    eng = GenerationEngine(tp, tcfg, device='cpu', precision='int8_wo',
                           **_kw())
    blocks = eng._params['blocks']
    assert all(set(blocks[k]) == {'int8', 'scale'}
               for k in ('qkv_w', 'proj_w', 'w_in', 'w_out'))
    assert tuple(blocks['w_out']['scale'].shape) == (
        cfg.num_layers, cfg.n_experts, cfg.hidden_size)
    got, st = _run(eng, prompts, 12)
    assert got == want and st['precision'] == 'int8_wo'


def test_paged_prefill_and_steps_match_reference_logits():
    cfg, jp, tcfg, tp = _model(capacity_factor=8.0)
    jt = jax.tree_util.tree_map(jax.numpy.asarray, jp)
    prompts = _prompts([5, 11], seed=3)
    b, w = 2, 12
    table = np.zeros((b, tkv.pages_for(cfg.max_seq_len, PS)), np.int32)
    table[0, :3], table[1, :3] = [4, 9, 2], [7, 1, 12]
    toks = np.zeros((b, w), np.int32)
    valid = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jcache = dict(jgpt.init_paged_kv_cache(cfg, 13, PS),
                  page_table=jax.numpy.asarray(table),
                  valid=jax.numpy.asarray(valid))
    tcache = dict(tgpt.init_paged_kv_cache(tcfg, 13, PS, 'cpu'),
                  page_table=torch.from_numpy(table),
                  valid=torch.from_numpy(valid))
    jprefill = jax.jit(lambda p, x, c, s: jmoe.forward_with_cache(
        p, x, c, s, cfg, last_only=True))
    jstep = jax.jit(lambda p, x, c, s: jmoe.forward_with_cache(p, x, c, s,
                                                               cfg))
    jlg, jc = jprefill(jt, jax.numpy.asarray(toks), jcache,
                       jax.numpy.zeros((b,), 'int32'))
    tlg, tc = tmoe.forward_with_cache(tp, torch.from_numpy(toks), tcache,
                                      torch.zeros(b, dtype=torch.int32), tcfg,
                                      last_only=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)
    pos = valid.copy()
    tok = np.asarray(jlg[:, 0].argmax(-1)).astype(np.int32)
    jc = {'k': jc['k'], 'v': jc['v'], 'page_table': jcache['page_table']}
    tc = {'k': tc['k'], 'v': tc['v'], 'page_table': tcache['page_table']}
    for _ in range(4):
        jlg, jc = jstep(jt, jax.numpy.asarray(tok[:, None]), jc,
                        jax.numpy.asarray(pos))
        tlg, tc = tmoe.forward_with_cache(tp, torch.from_numpy(tok[:, None]),
                                          tc, torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4)
        tok = tlg[:, 0].argmax(-1).numpy().astype(np.int32)
        pos += 1


def test_padding_rows_take_capacity_from_real_rows():
    """The known difference's mechanism: in one call at the default
    capacity, what the padding rows hold decides which real rows keep
    their second choice; at capacity factor 8 it cannot."""
    rng = np.random.RandomState(0)
    h, e, real = 16, 4, 6
    gw = torch.from_numpy(rng.randn(h, e).astype(np.float32))
    wi = torch.from_numpy((0.3 * rng.randn(e, h, 32)).astype(np.float32))
    wo = torch.from_numpy((0.3 * rng.randn(e, 32, h)).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, real, h).astype(np.float32))
    # padding rows that all prefer real row 0's second choice (b), or an
    # expert row 0 does not choose (a)
    top = torch.topk(x[0, 0] @ gw, e).indices.tolist()

    def pad(expert):
        g = gw[:, expert]
        return (g / g.norm() * 8.0).expand(1, 26, h)

    pad_a, pad_b = pad(top[2]), pad(top[1])
    out = {}
    for cf in (1.25, 8.0):
        ya, _ = tpm.moe_ffn(torch.cat([x, pad_a], 1), gw, wi, wo, cf)
        yb, _ = tpm.moe_ffn(torch.cat([x, pad_b], 1), gw, wi, wo, cf)
        out[cf] = (ya[0, :real] - yb[0, :real]).abs().max().item()
    assert out[1.25] > 1e-3 and out[8.0] == 0.0


def test_what_still_raises():
    """A MoE engine over a mesh is ported (step K3): a virtual mesh of
    two shards on the one device serves; a mesh= that is no mesh raises,
    and fp8 under sp raises the reference's own refusal (its step meets
    an unbound 'sp' axis)."""
    from paddle_tpu_torch.parallel import MeshContext
    cfg, jp, tcfg, tp = _model()
    with pytest.raises(TypeError, match='mesh='):
        GenerationEngine(tp, tcfg, device='cpu', mesh=object())
    eng = GenerationEngine(tp, tcfg, autostart=False,
                           mesh=MeshContext.build(2, devices=['cpu'] * 2))
    assert eng.stats()['mesh']['mp'] == 2
    eng.shutdown()
    with pytest.raises(NotImplementedError, match='unbound axis name'):
        tmoe.make_train_step(dataclasses.replace(tcfg, sp=2,
                                                 matmul_precision='fp8'),
                             None)
