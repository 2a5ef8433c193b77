"""The port's compiled decode step (paddle_tpu_torch/models/decode_cache.py,
and its use by serving/generation.py and models/gpt.py) against the
reference's contract, on the CPU.

- ``DecodeFnCache`` and ``clear_decode_caches``: the LRU, eviction and
  maxsize rules of the reference's own test
  (``tests/test_generation.py::test_decode_fn_cache_bounds_and_clear``).
- The engine captures its prefill and step once each: two at ``warmup()``,
  none from live traffic (the reference's "two traces at warmup, none from
  live traffic"); a device failure zeroes the pool in place and the engine
  serves again without a new capture.
- ``generate()`` keeps its prefill, loop and cache in the model's
  ``DecodeFnCache``: a second call reuses them, and its greedy streams stay
  equal to the JAX package's at float32 (bf16/f32 and int8 caches), as do
  the engine's. On the CPU a ``CapturedFn`` runs its function eagerly from
  the same static buffers the card's graph would read.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu import fault as jfault
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu_torch import fault as tfault
from paddle_tpu_torch.models import decode_cache as dc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.decode_cache import (CapturedFn, DecodeFnCache,
                                                  clear_decode_caches)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.serving import GenerationEngine

_CFGS = {
    'f32': dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=48),
    'int8kv': dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                   num_kv_heads=2, max_seq_len=48, kv_cache_int8=True),
}


@pytest.fixture(scope='module', params=sorted(_CFGS))
def model(request):
    """(reference params, reference config, port params, port config), the
    block matrices x10 so streams depend on their context."""
    cfg = jgpt.GPTConfig(dtype='float32', remat=False, use_flash=False,
                         **_CFGS[request.param])
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    return jp, cfg, tgpt.params_from_numpy(jp, tcfg, 'cpu'), tcfg


def _prompts(lens, seed, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=t).astype(np.int32) for t in lens]


def _kw(**over):
    kw = dict(num_slots=2, page_size=8, prefill_width=16)
    kw.update(over)
    return kw


def _run(eng, prompts, n_new):
    with eng:
        futs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        return [f.result(timeout=120) for f in futs]


# ---------------------------------------------------------------------------
# the LRU
# ---------------------------------------------------------------------------

def test_decode_fn_cache_bounds_and_clear():
    built = []
    c = DecodeFnCache(maxsize=2, name='t')
    for key in ('a', 'b', 'a', 'c'):       # 'c' evicts LRU 'b'
        c.get(key, lambda k=key: built.append(k) or k)
    assert built == ['a', 'b', 'c']
    assert 'a' in c and 'c' in c and 'b' not in c
    assert len(c) == 2
    clear_decode_caches()
    assert len(c) == 0
    assert DecodeFnCache(maxsize=0).maxsize > 0   # 0/None -> default size
    with pytest.raises(ValueError):
        DecodeFnCache(maxsize=-1)


@pytest.mark.parametrize('env,want', [(None, 8), ('3', 3), ('0', 8),
                                      ('x', 8)])
def test_maxsize_from_the_environment(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv('PADDLE_TPU_DECODE_CACHE_SIZE', raising=False)
    else:
        monkeypatch.setenv('PADDLE_TPU_DECODE_CACHE_SIZE', env)
    assert DecodeFnCache().maxsize == want


def test_the_registry_is_weak():
    import gc
    c = DecodeFnCache(name='weak-registry-probe')
    assert c in dc._REGISTRY
    del c
    gc.collect()
    assert all(x.name != 'weak-registry-probe' for x in dc._REGISTRY)


# ---------------------------------------------------------------------------
# CapturedFn on the CPU
# ---------------------------------------------------------------------------

def test_captured_fn_runs_eagerly_from_its_buffers_on_the_cpu():
    bufs = {'x': torch.zeros(3, dtype=torch.int32),
            'n': torch.zeros(1, dtype=torch.int64)}

    def fn(x, n):
        n.add_(1)
        return x * 2 + n

    cap = CapturedFn(fn, bufs, 'cpu')
    assert not cap.captured
    before = tfa.flash_decode.launches
    out = cap.replay(x=np.array([1, 2, 3], np.int32))
    assert out.tolist() == [3, 5, 7]
    # unnamed buffers keep what they hold, and fn may write them
    assert cap.replay().tolist() == [4, 6, 8]
    assert bufs['x'].tolist() == [1, 2, 3] and int(bufs['n']) == 2
    assert tfa.flash_decode.launches == before


def test_tensor_key_follows_where_tensors_live():
    a = {'k': torch.zeros(4), 'v': {'int8': torch.zeros(2, 2)}}
    assert dc.tensor_key(a) == dc.tensor_key(dict(a))
    b = {'k': torch.zeros(4), 'v': a['v']}
    assert dc.tensor_key(a) != dc.tensor_key(b)
    with pytest.raises(TypeError):
        dc.tensor_key({'k': 3})


def test_every_kernel_wrapper_has_its_counters():
    for k in dc.kernel_wrappers():
        assert k.launches >= 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_warmup_two_captures_and_none_from_live_traffic(model):
    _, _, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **_kw())
    report = eng.warmup()
    assert report['prebuilt'] == 2 and report['already_cached'] == 0
    assert eng._trace_count == 2
    assert set(eng._fns) == {'prefill', 'step'}
    # a second warmup finds both already built
    assert eng.warmup()['already_cached'] == 2
    _run(eng, _prompts([5, 9], seed=31), 4)
    assert eng._trace_count == 2        # live traffic captured nothing
    assert eng.stats()['traces'] == 2


def test_without_warmup_the_first_calls_capture(model):
    _, _, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', **_kw())
    _run(eng, _prompts([5, 9, 3], seed=32), 3)
    assert eng._trace_count == 2


def test_engine_greedy_streams_equal_reference(model):
    jp, cfg, tp, tcfg = model
    prompts = _prompts([9, 9, 3, 14], seed=23)
    want = _run(JEngine(jp, cfg, **_kw()), prompts, 12)
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **_kw())
    eng.warmup()
    assert _run(eng, prompts, 12) == want


def test_a_device_failure_zeroes_the_pool_and_serves_again(model):
    _, _, tp, tcfg = model
    prompts = _prompts([6, 11], seed=5)
    base = _run(GenerationEngine(tp, tcfg, device='cpu', **_kw()), prompts, 5)
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **_kw())
    eng.warmup()
    planes = [t for p in (eng._pool['k'], eng._pool['v'])
              for t in (p.values() if isinstance(p, dict) else (p,))]
    ptrs = [t.data_ptr() for t in planes]
    # a request runs, leaving rows in the pool, then the next prefill fails
    eng.start()
    eng.submit(prompts[0], max_new_tokens=5).result(timeout=60)
    assert any(bool(t.any()) for t in planes)
    tfault.configure('gen.step:1.0', seed=0, max_faults=1)
    try:
        bad = eng.submit(prompts[0], max_new_tokens=3)
        assert isinstance(bad.exception(timeout=60), tfault.InjectedFault)
    finally:
        tfault.configure(None)
        jfault.configure(None)
    # the pool was zeroed in place: the graphs' addresses still hold it
    assert [t.data_ptr() for t in planes] == ptrs
    assert not any(bool(t.any()) for t in planes)
    futs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    assert [f.result(timeout=60) for f in futs] == base
    eng.shutdown()
    assert eng._trace_count == 2
    assert eng.stats()['failed'] == 1


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

def _models(jp, cfg, tcfg):
    jm = jgpt.GPTForCausalLM(cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jp)):
        jm._parameters[f'p{i}'].set_value(jnp.asarray(leaf))
    tm = tgpt.GPTForCausalLM(tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu'),
                             device='cpu')
    return jm, tm


def test_generate_reuses_its_entry_and_equals_reference(model):
    jp, cfg, _, tcfg = model
    jm, tm = _models(jp, cfg, tcfg)
    prompt = np.random.RandomState(3).randint(0, 128, (2, 6)).astype(
        np.int32)
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=10,
                                  temperature=0)._value)
    first = tm.generate(torch.from_numpy(prompt), max_new_tokens=10,
                        temperature=0)
    np.testing.assert_array_equal(first.numpy(), want)
    assert len(tm._decode_fns) == 1
    entry = next(iter(tm._decode_fns._data.values()))
    cache = entry['cache']
    # a second call: the same entry, its cache zeroed and refilled in place
    again = tm.generate(torch.from_numpy(prompt), max_new_tokens=10,
                        temperature=0)
    assert torch.equal(again, first)
    assert len(tm._decode_fns) == 1
    assert next(iter(tm._decode_fns._data.values()))['cache'] is cache
    # a shorter run with the same knobs and shapes: same entry, a prefix
    short = tm.generate(torch.from_numpy(prompt), max_new_tokens=4,
                        temperature=0)
    assert torch.equal(short, first[:, :10])
    assert len(tm._decode_fns) == 1
    # another prompt length is another entry; clearing drops them all
    tm.generate(torch.from_numpy(prompt[:, :5]), max_new_tokens=3,
                temperature=0)
    assert len(tm._decode_fns) == 2
    clear_decode_caches()
    assert len(tm._decode_fns) == 0
    assert torch.equal(tm.generate(torch.from_numpy(prompt),
                                   max_new_tokens=10, temperature=0), first)


def test_generate_sees_weights_changed_in_place(model):
    jp, cfg, _, tcfg = model
    _, tm = _models(jp, cfg, tcfg)
    prompt = torch.from_numpy(np.random.RandomState(4).randint(
        0, 128, (2, 5)).astype(np.int32))
    tm.generate(prompt, max_new_tokens=6, temperature=0)
    with torch.no_grad():
        for p in tm.blocks.parameters():
            p.mul_(0.5)
    got = tm.generate(prompt, max_new_tokens=6, temperature=0)
    fresh = tgpt.GPTForCausalLM(tcfg, tm.param_dict(), device='cpu')
    assert torch.equal(got, fresh.generate(prompt, max_new_tokens=6,
                                           temperature=0))


def test_sampled_generate_keeps_its_draws_across_reuse(model):
    jp, cfg, _, tcfg = model
    _, tm = _models(jp, cfg, tcfg)
    prompt = torch.from_numpy(np.random.RandomState(6).randint(
        0, 128, (3, 4)).astype(np.int32))
    kw = dict(max_new_tokens=9, temperature=0.9, top_k=20)
    a = tm.generate(prompt, seed=7, **kw)
    assert torch.equal(a, tm.generate(prompt, seed=7, **kw))
    assert not torch.equal(a, tm.generate(prompt, seed=8, **kw))
    # greedy and sampled runs keep entries of their own
    tm.generate(prompt, max_new_tokens=3, temperature=0)
    assert len(tm._decode_fns) == 2


def test_generate_loop_captures_once_per_cache(model):
    _, _, tp, tcfg = model
    params = tgpt.serving_params(tp, tcfg)
    prefill, _ = tgpt.make_decode_fns(tcfg)
    loop = tgpt.make_generate_loop(tcfg)
    prompt = torch.from_numpy(_prompts([6], seed=9)[0][None])
    pos0 = torch.tensor([6], dtype=torch.int32)
    runs = []
    for _ in range(2):
        cache = tgpt.init_kv_cache(tcfg, 1, 'cpu')
        lg, cache = prefill(params, prompt, cache)
        first = torch.argmax(lg, -1).to(torch.int32)
        runs.append(loop(params, first, pos0, cache, None, 7)[0])
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (1, 7)
    empty, _ = loop(params, first, pos0, cache, None, 0)
    assert empty.shape == (1, 0)
