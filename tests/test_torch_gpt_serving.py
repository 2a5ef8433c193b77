"""The port's GPT serving path (paddle_tpu_torch/models/gpt.py and
serving/generation.py) against the JAX package's, on the CPU at a small
size: the reference's own parameters (converted through numpy), paged
prefill + decode logits within 1e-4 (float32; the two sum in different
orders and the port's attention is the kernel's per-page twin where the
reference gathers), greedy engine streams equal token for token (bf16/f32
pools and int8 pools), and the engine's admission / deadline / shutdown
behaviour equal to the reference engine's. Sampled streams cannot match jax.random; they are
held to their own contract: a pure function of (seed, position)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu import fault as jfault
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import (DeadlineExceededError as JDeadline,
                                EngineClosedError as JClosed,
                                GenerationEngine as JEngine,
                                QueueFullError as JQueueFull)
from paddle_tpu_torch import fault as tfault
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineClosedError, GenerationEngine,
                                      QueueFullError)

PS = 8
_CFGS = {
    'mha': jgpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=48, dtype='float32',
                          remat=False, use_flash=False),
    'gqa': jgpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=48,
                          dtype='float32', remat=False, use_flash=False),
}


@pytest.fixture(scope='module', params=sorted(_CFGS))
def model(request):
    """(reference params, reference config, port params, port config)."""
    cfg = _CFGS[request.param]
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    # x10 on the block matrices: at the reference's init stds a 2-layer
    # model with a tied head mostly repeats its last token; larger weights
    # make every stream depend on attention over its context
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    tp = tgpt.params_from_numpy(jp, tcfg, 'cpu')
    return jp, cfg, tp, tcfg


def _prompts(lens, seed, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=t).astype(np.int32) for t in lens]


def _kw(**over):
    kw = dict(num_slots=2, page_size=PS, prefill_width=16)
    kw.update(over)
    return kw


def _run(engine, prompts, n_new, **submit):
    with engine as eng:
        futs = [eng.submit(p, max_new_tokens=n_new, **submit)
                for p in prompts]
        out = [f.result(timeout=120) for f in futs]
        return out, eng.stats()


def test_params_from_numpy_keeps_layout_and_values(model):
    jp, cfg, tp, tcfg = model
    assert torch.equal(tp['wte'], torch.from_numpy(np.array(jp['wte'])))
    for k, v in jp['blocks'].items():
        assert torch.equal(tp['blocks'][k], torch.from_numpy(np.array(v)))
    bad = dataclasses.replace(tcfg, hidden_size=32, num_heads=2)
    with pytest.raises(ValueError, match='shape'):
        tgpt.params_from_numpy(jp, bad, 'cpu')


def test_init_params_layout_matches_reference(model):
    jp, cfg, tp, tcfg = model
    mine = tgpt.init_params(tcfg, torch.Generator().manual_seed(0), 'cpu')
    assert tuple(mine['wte'].shape) == jp['wte'].shape
    for k, v in jp['blocks'].items():
        assert tuple(mine['blocks'][k].shape) == v.shape
        assert mine['blocks'][k].dtype == torch.float32
    # same stds as the reference (0.02; residual projections / sqrt(2L))
    assert abs(mine['wte'].std().item() - 0.02) < 2e-3
    want = 0.02 / np.sqrt(2 * tcfg.num_layers)
    assert abs(mine['blocks']['proj_w'].std().item() - want) < 2e-3


def test_paged_prefill_and_decode_logits_match_reference(model):
    jp, cfg, tp, tcfg = model
    prompts = _prompts([5, 11], seed=3)
    b, w = len(prompts), 12
    p_max = tkv.pages_for(cfg.max_seq_len, PS)
    table = np.zeros((b, p_max), np.int32)
    table[0, :3] = [4, 9, 2]
    table[1, :3] = [7, 1, 12]
    toks = np.zeros((b, w), np.int32)
    valid = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jpool = jgpt.init_paged_kv_cache(cfg, 13, PS)
    tpool = tgpt.init_paged_kv_cache(tcfg, 13, PS, 'cpu')
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    # one compiled program each for the reference's prefill and step
    jprefill = jax.jit(lambda p, x, c, s: jgpt.forward_with_cache(
        p, x, c, s, cfg, last_only=True))
    jstep = jax.jit(lambda p, x, c, s: jgpt.forward_with_cache(
        p, x, c, s, cfg))
    jlg, jc = jprefill(jp, jnp.asarray(toks),
                       dict(jpool, page_table=jt, valid=jnp.asarray(valid)),
                       jnp.zeros((b,), jnp.int32))
    tlg, tc = tgpt.forward_with_cache(
        tp, torch.from_numpy(toks), dict(tpool, page_table=tt,
                                         valid=torch.from_numpy(valid)),
        torch.zeros(b, dtype=torch.int32), tcfg, last_only=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    jtok = np.asarray(jnp.argmax(jlg[:, 0], -1))
    ttok = tgpt._sample(tlg[:, 0], 0.0, None).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    pos = valid.copy()
    jcache = {'k': jc['k'], 'v': jc['v'], 'page_table': jt}
    tcache = {'k': tc['k'], 'v': tc['v'], 'page_table': tt}
    for _ in range(6):
        jlg, jcache = jstep(jp, jnp.asarray(jtok[:, None]), jcache,
                            jnp.asarray(pos))
        tlg, tcache = tgpt.forward_with_cache(
            tp, torch.from_numpy(ttok[:, None]), tcache,
            torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)
        jtok = np.asarray(jnp.argmax(jlg[:, 0], -1)).astype(np.int32)
        ttok = tgpt._sample(tlg[:, 0], 0.0, None).numpy()
        np.testing.assert_array_equal(ttok, jtok)
        pos += 1
    # every page but the trash page 0 holds the same rows: the prefill's
    # padding rows land there, and past layer 0 they follow the port's
    # attention output for padding, which is zero (the kernel skips those
    # q rows), not the reference's
    np.testing.assert_allclose(tcache['k'][:, 1:].numpy(),
                               np.asarray(jcache['k'])[:, 1:], atol=1e-5,
                               rtol=1e-5)


def test_bf16_prefill_logits_close_to_reference(model):
    # the serving dtype: XLA and PyTorch round bf16 at different places
    # (fusion vs per-op), so this holds the dtype plumbing (LayerNorm's f32
    # promotion, casts before each product) to bf16's 2e-2, not bit parity
    jp, cfg, tp, tcfg = model
    cfg = dataclasses.replace(cfg, dtype='bfloat16')
    tcfg = dataclasses.replace(tcfg, dtype='bfloat16')
    toks = np.stack([np.resize(p, 12) for p in _prompts([7, 12], seed=4)])
    valid = np.array([7, 12], np.int32)
    table = np.zeros((2, tkv.pages_for(cfg.max_seq_len, PS)), np.int32)
    table[:, :2] = [[3, 5], [8, 1]]
    jprefill = jax.jit(lambda p, x, c, s: jgpt.forward_with_cache(
        p, x, c, s, cfg, last_only=True))
    jlg, _ = jprefill(
        jp, jnp.asarray(toks),
        dict(jgpt.init_paged_kv_cache(cfg, 9, PS), page_table=jnp.asarray(
            table), valid=jnp.asarray(valid)),
        jnp.zeros((2,), jnp.int32))
    tlg, _ = tgpt.forward_with_cache(
        tp, torch.from_numpy(toks),
        dict(tgpt.init_paged_kv_cache(tcfg, 9, PS, 'cpu'),
             page_table=torch.from_numpy(table),
             valid=torch.from_numpy(valid)),
        torch.zeros(2, dtype=torch.int32), tcfg, last_only=True)
    assert tlg.dtype == torch.bfloat16
    np.testing.assert_allclose(tlg.float().numpy(),
                               np.asarray(jlg.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize('num_pages', [None, 6])
def test_engine_greedy_streams_equal_reference(model, num_pages):
    # num_pages=6 starves the pool: both engines must evict, requeue and
    # still stream the unconstrained tokens
    jp, cfg, tp, tcfg = model
    prompts = _prompts([9, 9, 3, 14], seed=23)
    n_new = 16
    want, jst = _run(JEngine(jp, cfg, **_kw(num_pages=num_pages)), prompts,
                     n_new)
    got, st = _run(GenerationEngine(tp, tcfg, device='cpu',
                                    **_kw(num_pages=num_pages)), prompts,
                   n_new)
    assert got == want
    assert all(len(s) == n_new for s in got)
    if num_pages is not None:
        assert st['evictions'] >= 1 and jst['evictions'] >= 1
    assert st['completed'] == len(prompts) and st['active_slots'] == 0
    assert st['free_pages'] == st['num_pages'] - 1


def test_engine_serves_a_model_object_like_the_pair(model):
    # the reference takes a Layer with .config (_resolve_generation_model);
    # the port's GPTForCausalLM, on its own device, streams as the
    # (params, config) engine and the JAX engine do
    jp, cfg, tp, tcfg = model
    prompts = _prompts([9, 3, 14, 6], seed=41)
    want, _ = _run(JEngine(jp, cfg, **_kw()), prompts, 12)
    pair, _ = _run(GenerationEngine(tp, tcfg, device='cpu', **_kw()),
                   prompts, 12)
    net = tgpt.GPTForCausalLM(tcfg, tp, device='cpu')
    eng = GenerationEngine(net, **_kw())
    assert eng.device == torch.device('cpu') and eng.config is net.config
    got, st = _run(eng, prompts, 12)
    assert got == pair == want
    assert st['completed'] == len(prompts)


def test_engine_forward_fn_and_what_it_refuses(model):
    _, _, tp, tcfg = model
    calls = []

    def forward_fn(*args, **kw):
        calls.append(kw.get('last_only', False))
        return tgpt.forward_with_cache(*args, **kw)

    prompts = _prompts([5, 11], seed=43)
    base, _ = _run(GenerationEngine(tp, tcfg, device='cpu', **_kw()),
                   prompts, 6)
    got, _ = _run(GenerationEngine(tp, tcfg, device='cpu',
                                   forward_fn=forward_fn, **_kw()),
                  prompts, 6)
    assert got == base
    # both device calls, the prefills (last_only) and the steps, go through it
    assert True in calls and False in calls
    with pytest.raises(TypeError, match='config'):
        GenerationEngine(object(), device='cpu')

    class MoEGPTConfig:                 # a MoE family's config
        pass

    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1: step H'):
        GenerationEngine(tp, MoEGPTConfig(), device='cpu')


def test_engine_eos_truncates_like_reference(model):
    jp, cfg, tp, tcfg = model
    prompts = _prompts([5, 9], seed=17)
    base, _ = _run(GenerationEngine(tp, tcfg, device='cpu', **_kw()),
                   prompts, 8)
    eos = base[0][2]          # learned from the greedy stream
    want, _ = _run(JEngine(jp, cfg, eos_id=eos, **_kw()), prompts, 8)
    got, _ = _run(GenerationEngine(tp, tcfg, device='cpu', eos_id=eos,
                                   **_kw()), prompts, 8)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3


def _engines(model, **kw):
    jp, cfg, tp, tcfg = model
    return [(JEngine(jp, cfg, **_kw(**kw)), JDeadline, JQueueFull, JClosed),
            (GenerationEngine(tp, tcfg, device='cpu', **_kw(**kw)),
             DeadlineExceededError, QueueFullError, EngineClosedError)]


def test_deadline_fast_fail_like_reference(model):
    for eng, deadline_exc, _, _ in _engines(model, autostart=False):
        with pytest.raises(deadline_exc):
            eng.submit(_prompts([4], 0)[0], deadline_ms=0)
        st = eng.stats()
        assert (st['expired'], st['submitted'], st['queue_depth']) == (1, 0, 0)
        eng.shutdown()


def test_deadline_expires_in_queue_like_reference(model):
    now = [0.0]
    for eng, deadline_exc, _, _ in _engines(model, autostart=False,
                                            clock=lambda: now[0]):
        fut = eng.submit(_prompts([4], 0)[0], deadline_ms=50)
        now[0] += 1.0          # the request waits past its deadline
        eng.shutdown(drain=True)
        assert isinstance(fut.exception(timeout=30), deadline_exc)
        assert eng.stats()['expired'] == 1
        now[0] = 0.0


def test_queue_full_backpressure_like_reference(model):
    for eng, _, full_exc, _ in _engines(model, autostart=False,
                                        queue_capacity=2):
        p = _prompts([3], 1)[0]
        eng.submit(p)
        eng.submit(p)
        with pytest.raises(full_exc) as ei:
            eng.submit(p)
        assert ei.value.capacity == 2 and ei.value.depth == 2
        st = eng.stats()
        assert (st['rejected'], st['submitted']) == (1, 2)
        eng.shutdown(drain=False)


def test_shutdown_like_reference(model):
    for eng, _, _, closed_exc in _engines(model, autostart=False):
        fut = eng.submit(_prompts([3], 2)[0])
        eng.shutdown(drain=False)
        assert isinstance(fut.exception(timeout=30), closed_exc)
        with pytest.raises(closed_exc):
            eng.submit(_prompts([3], 2)[0])
        assert eng.stats()['failed'] == 1


def test_shutdown_drains_inline_without_a_thread(model):
    _, _, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **_kw())
    futs = [eng.submit(p, max_new_tokens=4) for p in _prompts([3, 6, 2], 5)]
    eng.shutdown(drain=True)
    assert all(len(f.result(timeout=1)) == 4 for f in futs)


def test_sampled_streams_depend_only_on_seed_and_position(model):
    _, _, tp, tcfg = model
    prompts = _prompts([5, 9, 7], seed=19)
    kw = _kw(temperature=0.8, top_k=20)
    with GenerationEngine(tp, tcfg, device='cpu', **kw) as eng:
        futs = [eng.submit(p, max_new_tokens=6, seed=i)
                for i, p in enumerate(prompts)]
        batched = [f.result(timeout=120) for f in futs]
    for i, p in enumerate(prompts):       # alone, in a wider engine
        with GenerationEngine(tp, tcfg, device='cpu',
                              **dict(kw, num_slots=3)) as eng:
            alone = eng.submit(p, max_new_tokens=6, seed=i).result(
                timeout=120)
        assert alone == batched[i], f'sequence {i} depends on its batch'
    with GenerationEngine(tp, tcfg, device='cpu', **kw) as eng:
        other = eng.submit(prompts[0], max_new_tokens=6,
                           seed=1234).result(timeout=120)
    assert other != batched[0]            # the seed does steer the draw


def test_gumbel_sampler_follows_the_softmax():
    # Gumbel-max over the (seed, position) hash draws softmax(logits / T):
    # 4000 draws of a 4-way distribution land within 3% of its masses
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0]]).repeat(4000, 1)
    seeds = torch.arange(4000)
    pos = torch.full((4000,), 7)
    draws = tgpt._sample(logits, 1.0, None, seeds=seeds, positions=pos)
    freq = torch.bincount(draws.long(), minlength=4).float() / 4000
    want = torch.softmax(logits[0], -1)
    assert (freq - want).abs().max().item() < 0.03
    again = tgpt._sample(logits, 1.0, None, seeds=seeds, positions=pos)
    assert torch.equal(draws, again)
    top1 = tgpt._sample(logits, 1.0, 1, seeds=seeds, positions=pos)
    assert (top1 == 0).all()
    nucleus = tgpt._sample(logits, 1.0, None, top_p=0.5, seeds=seeds,
                           positions=pos)
    assert set(nucleus.tolist()) <= {0, 1}


def test_injected_fault_fails_the_request_and_the_engine_recovers(model):
    _, _, tp, tcfg = model
    tfault.configure('gen.step:1.0', seed=0, max_faults=1)
    try:
        with GenerationEngine(tp, tcfg, device='cpu', **_kw()) as eng:
            bad = eng.submit(_prompts([4], 7)[0], max_new_tokens=3)
            assert isinstance(bad.exception(timeout=60),
                              tfault.InjectedFault)
            ok = eng.submit(_prompts([4], 7)[0], max_new_tokens=3)
            assert len(ok.result(timeout=60)) == 3
            st = eng.stats()
        assert st['failed'] == 1 and st['completed'] == 1
    finally:
        tfault.configure(None)
        jfault.configure(None)


def test_unported_options_raise_naming_the_roadmap(model):
    _, _, tp, tcfg = model
    for kw in (dict(precision='int8_wo'), dict(prefix_cache=True),
               dict(prefix_cache_pages=4), dict(mp=2), dict(mesh=object()),
               dict(telemetry_port=0)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            GenerationEngine(tp, tcfg, device='cpu', **_kw(**kw))
    # the int8 page pool is ported: kv_cache_int8 builds an engine
    eng = GenerationEngine(tp, dataclasses.replace(tcfg, kv_cache_int8=True),
                           device='cpu', autostart=False, **_kw())
    eng.shutdown()


def test_metrics_and_readiness(model):
    _, _, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', **_kw())
    name = eng._probe_name
    assert tobs.readiness()['checks'][name]['ready'] is False
    rep = eng.warmup()
    assert rep['prebuilt'] == 2
    assert tobs.readiness()['checks'][name]['ready'] is True
    with eng:
        eng.submit(_prompts([6], 8)[0], max_new_tokens=4).result(timeout=60)
    labels = eng.labels
    assert tobs.find('gen.tokens', labels).value == 4
    assert tobs.find('gen.requests_completed', labels).value == 1
    assert tobs.find('gen.ttft_ms', labels).count == 1
    assert name not in tobs.readiness()['checks']
    recs = tobs.recorder().requests(outcome='ok')
    assert any(e['ev'] == 'first_emit' for e in recs[0]['timeline'])
    spans = [e for e in tobs.trace_events()
             if e['name'] == 'gen.prefill'
             and e['args']['req_id'] == recs[0]['id']]
    assert len(spans) == 1 and spans[0]['dur'] > 0


# ---------------------------------------------------------------------------
# the int8 page pool (kv_cache_int8): kernel 7's twin on the CPU
# ---------------------------------------------------------------------------

def _int8(model):
    jp, cfg, tp, tcfg = model
    return (jp, dataclasses.replace(cfg, kv_cache_int8=True), tp,
            dataclasses.replace(tcfg, kv_cache_int8=True))


def test_int8_paged_prefill_and_decode_match_reference(model):
    # the reference's CPU path dequantizes the gathered cache; the port's
    # twin applies the scales around the dots: f32 rounding apart (1e-4)
    jp, cfg, tp, tcfg = _int8(model)
    prompts = _prompts([6, 10], seed=31)
    b, w = 2, 12
    table = np.zeros((b, tkv.pages_for(cfg.max_seq_len, PS)), np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :3] = [1, 11, 4]
    toks = np.zeros((b, w), np.int32)
    valid = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jpool = jgpt.init_paged_kv_cache(cfg, 13, PS)
    tpool = tgpt.init_paged_kv_cache(tcfg, 13, PS, 'cpu')
    assert tpool['k']['int8'].dtype == torch.int8
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jlg, jc = jax.jit(lambda p, x, c, s: jgpt.forward_with_cache(
        p, x, c, s, cfg, last_only=True))(
            jp, jnp.asarray(toks),
            dict(jpool, page_table=jt, valid=jnp.asarray(valid)),
            jnp.zeros((b,), jnp.int32))
    tlg, tc = tgpt.forward_with_cache(
        tp, torch.from_numpy(toks),
        dict(tpool, page_table=tt, valid=torch.from_numpy(valid)),
        torch.zeros(b, dtype=torch.int32), tcfg, last_only=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    # the pools hold the same quantized rows, but for the trash page 0,
    # where the padding rows land (past layer 0 they follow the port's zero
    # attention output for padding rows, not the reference's)
    for plane in ('k', 'v'):
        np.testing.assert_array_equal(tc[plane]['int8'][:, 1:].numpy(),
                                      np.asarray(jc[plane]['int8'])[:, 1:])
    tok = np.asarray(jnp.argmax(jlg[:, 0], -1)).astype(np.int32)
    jstep = jax.jit(lambda p, x, c, s: jgpt.forward_with_cache(
        p, x, c, s, cfg))
    jcache = {'k': jc['k'], 'v': jc['v'], 'page_table': jt}
    tcache = {'k': tc['k'], 'v': tc['v'], 'page_table': tt}
    pos = valid.copy()
    for _ in range(4):
        jlg, jcache = jstep(jp, jnp.asarray(tok[:, None]), jcache,
                            jnp.asarray(pos))
        tlg, tcache = tgpt.forward_with_cache(
            tp, torch.from_numpy(tok[:, None]), tcache,
            torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jlg[:, 0], -1)).astype(np.int32)
        pos += 1


@pytest.mark.parametrize('num_pages', [None, 6])
def test_int8_engine_greedy_streams_equal_reference(model, num_pages):
    jp, cfg, tp, tcfg = _int8(model)
    prompts = _prompts([9, 9, 3, 14], seed=23)
    want, _ = _run(JEngine(jp, cfg, **_kw(num_pages=num_pages)), prompts, 16)
    got, st = _run(GenerationEngine(tp, tcfg, device='cpu',
                                    **_kw(num_pages=num_pages)), prompts, 16)
    assert got == want
    assert st['completed'] == len(prompts)
    assert st['free_pages'] == st['num_pages'] - 1
