"""The port's prefix cache (paddle_tpu_torch/serving/prefix_cache.py and
the engine's reuse path in serving/generation.py) against the JAX
package's, on the CPU at a small size, in float32: the same numpy-seeded
weights and requests through both engines with the cache on. Greedy
streams are equal token for token (float and int8 pools, cold, warm,
partial and copy-on-write hits); the trie and the refcounted allocator
behave as the reference's; warm repeats capture nothing new (two captures
for the engine's life); tenants never share a page; the cache yields
pages under pool pressure, honours its capacity and gives every page back
on drain + clear; it is off by default and by ``PADDLE_TPU_GEN_PREFIX``."""
import dataclasses
import sys
import threading

import numpy as np
import pytest

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import PrefixCache as JPrefixCache
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.serving import GenerationEngine, PrefixCache
from paddle_tpu_torch.serving.generation import GenerationFuture

PS = 8
_CFG = jgpt.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                      num_heads=2, max_seq_len=32, dtype='float32',
                      remat=False, use_flash=False)


@pytest.fixture(scope='module', params=['f32', 'int8'])
def model(request):
    """(reference params, reference config, port params, port config),
    float or int8 pools; block matrices x10 so streams depend on their
    context."""
    cfg = dataclasses.replace(_CFG, kv_cache_int8=request.param == 'int8')
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    return jp, cfg, tgpt.params_from_numpy(jp, tcfg, 'cpu'), tcfg


def _kw(**over):
    kw = dict(num_slots=2, page_size=PS, prefill_width=16, prefix_cache=True)
    kw.update(over)
    return kw


def _engines(model, **over):
    """(reference engine, port engine), both with the cache on."""
    jp, cfg, tp, tcfg = model
    return (JEngine(jp, cfg, **_kw(**over)),
            GenerationEngine(tp, tcfg, device='cpu', **_kw(**over)))


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(
        1, _CFG.vocab_size, size=n).astype(np.int32)


def _one_at_a_time(eng, reqs, n_new=6):
    """Submit each (prompt, seed) after the previous one finished, as a
    chat client would. -> the streams."""
    return [eng.submit(p, max_new_tokens=n_new, seed=s).result(timeout=120)
            for p, s in reqs]


# ---------------------------------------------------------------------------
# the trie and the refcounted allocator (no engine)
# ---------------------------------------------------------------------------

def test_allocator_refcounts_shared_pages():
    alloc = tkv.PageAllocator(8)
    (p,) = alloc.alloc(1)
    alloc.retain([p])                            # refs: 2
    before = alloc.free_pages
    alloc.free([p])                              # refs: 1, still owned
    assert alloc.free_pages == before and alloc.refcount(p) == 1
    alloc.free([p])                              # refs: 0, free again
    assert alloc.free_pages == before + 1
    with pytest.raises(ValueError, match='double free'):
        alloc.free([p])
    with pytest.raises(ValueError):
        alloc.retain([p])                        # a freed page
    for bad in (0, -1, 8):
        with pytest.raises(ValueError):
            alloc.retain([bad])
    assert alloc.free_pages == 7


def _trie_ops(cache_cls, alloc):
    """One scripted life of a cache: publish a donor with a prompt
    boundary mid-page, acquire full, partial and miss prefixes, pressure
    it, cap it, clear it. -> every observable result, in order."""
    cache = cache_cls(alloc, PS)
    out = []
    toks = list(range(1, 2 * PS + 5))            # 2 full pages + partial
    table = np.array(list(alloc.alloc(3)) + [0], np.int32)
    cache.publish('t', toks, table, len(toks), prompt_len=PS + 3, seed=7,
                  first_tok=42)
    alloc.free([int(p) for p in table[:3]])      # the donor retires
    out.append(cache.stats())
    for tenant, prompt, seed in (
            ('t', toks, 0),                      # whole prompt, no first tok
            ('t', toks[:PS + 3], 7),             # the donor's prompt: full
            ('t', toks[:PS + 3], 8),             # same prompt, other seed
            ('t', toks[:PS] + [99, 98], 0),      # diverges mid-page
            ('u', toks, 0),                      # another tenant: miss
            ('t', [5, 6, 7], 0)):                # miss
        hit = cache.acquire(tenant, np.array(prompt, np.int32), seed)
        out.append(hit)
        if hit:
            alloc.free(hit['pages'])
    out.append(cache.debug_pages())
    out.append((cache.release_lru(1), cache.cached_pages, alloc.free_pages))
    cache.set_capacity(1)
    out.append((cache.cached_pages, cache.capacity_pages, alloc.free_pages))
    out.append((cache.clear(), cache.cached_pages, alloc.free_pages))
    out.append(cache.stats())
    return out


def test_trie_matches_reference_op_for_op():
    want = _trie_ops(JPrefixCache, jkv.PageAllocator(16))
    got = _trie_ops(PrefixCache, tkv.PageAllocator(16))
    assert got == want
    assert got[2]['next_tok'] == 42 and got[1]['next_tok'] is None
    assert got[5] is None and got[6] is None     # tenant 'u', the miss
    assert got[-2][2] == 15                      # every page free again


def test_full_hit_check_agrees_with_acquire_and_touches_nothing():
    """``acquire(..., full_only=True)`` takes the prefix only when the
    whole prompt is cached with its first token for the seed, and then
    agrees with ``acquire``; on anything less it returns None and changes
    no count, LRU tick or reference."""
    alloc = tkv.PageAllocator(16)
    cache = PrefixCache(alloc, PS)
    toks = list(range(1, 2 * PS + 5))
    table = np.array(list(alloc.alloc(3)) + [0], np.int32)
    cache.publish('t', toks, table, len(toks), prompt_len=PS + 3, seed=7,
                  first_tok=42)
    alloc.free([int(p) for p in table[:3]])
    cases = [('t', toks[:PS + 3], 7), ('t', toks[:PS + 3], 7 + 2 ** 32),
             ('t', toks[:PS + 3], 8), ('t', toks, 0),
             ('t', toks[:PS] + [99, 98], 0), ('u', toks[:PS + 3], 7),
             ('t', [5, 6, 7], 0)]
    got = []
    for t, p, s in cases:
        before = (cache.stats(), cache._tick, alloc.free_pages)
        full = cache.acquire(t, np.array(p, np.int32), s, full_only=True)
        got.append(full is not None)
        if full is None:
            assert (cache.stats(), cache._tick, alloc.free_pages) == before
            continue
        alloc.free(full['pages'])
        assert full['next_tok'] == 42 and full['match'] == PS + 3
    assert got == [True, True, False, False, False, False, False]
    for (t, p, s), full in zip(cases, got):
        hit = cache.acquire(t, np.array(p, np.int32), s)
        assert full == (hit is not None and hit['next_tok'] is not None)
        if hit:
            alloc.free(hit['pages'])


# ---------------------------------------------------------------------------
# the engine's reuse path
# ---------------------------------------------------------------------------

def test_streams_equal_reference_cold_warm_partial_and_cow(model):
    """Cold misses, a shared full page (partial hits), a divergence inside
    a cached page (copy-on-write), and warm repeats of every (prompt,
    seed) pair (full hits): the two engines stream the same tokens and
    count the same hits; the port stays at its two captures."""
    shared = _prompt(7, PS)
    head = _prompt(11, 12)
    reqs = [(np.concatenate([shared, _prompt(8, 4)]), 1),
            (np.concatenate([shared, _prompt(9, 5)]), 2),
            (np.concatenate([head, _prompt(12, 4)]), 4),
            (np.concatenate([head, _prompt(13, 4)]), 4),
            (_prompt(14, 3), 5)]
    # a pool that keeps every donor resident (the default one would
    # evict them under this traffic: the pressure test's case)
    jeng, teng = _engines(model, num_pages=40)
    out = {}
    for name, eng in (('ref', jeng), ('port', teng)):
        with eng:
            out[name] = (_one_at_a_time(eng, reqs)
                         + _one_at_a_time(eng, reqs), eng.stats())
            if name == 'port':
                traces = eng._trace_count
    (want, jst), (got, st) = out['ref'], out['port']
    assert got == want
    assert got[:len(reqs)] == got[len(reqs):]          # warm == cold
    for k in ('prefix_hits', 'prefix_misses', 'prefix_full_hits',
              'prefix_tokens_saved', 'prefills'):
        assert st[k] == jst[k], k
    assert st['prefix_full_hits'] >= len(reqs)
    assert st['prefills'] == len(reqs)     # full hits run no device call
    assert traces == 2
    # and the cache changed nothing: a cache-off engine streams the same
    jp, cfg, tp, tcfg = model
    with GenerationEngine(tp, tcfg, device='cpu',
                          **_kw(prefix_cache=False, num_pages=40)) as off:
        assert _one_at_a_time(off, reqs) == got[:len(reqs)]


def test_multi_turn_tail_starts_mid_page_like_reference(model):
    """Turn 2 = turn 1's prompt + its generated tokens + a new user turn:
    the cached rows end mid-page (copy-on-write) and the tail prefill
    starts there, at a start that is not a multiple of the page."""
    jeng, teng = _engines(model, prefill_width=24)
    t1 = [(_prompt(30 + i, n), i) for i, n in enumerate((5, 9, 11))]
    out = {}
    for name, eng in (('ref', jeng), ('port', teng)):
        with eng:
            first = _one_at_a_time(eng, t1, n_new=4)
            t2 = [(np.concatenate([p, np.asarray(g, np.int32),
                                   _prompt(40 + s, 3)]), s)
                  for (p, s), g in zip(t1, first)]
            second = _one_at_a_time(eng, t2, n_new=4)
            out[name] = (first, second, eng.stats())
    assert out['port'][:2] == out['ref'][:2]
    st = out['port'][2]
    # turn 1's written rows (prompt + 3 of its 4 tokens) were reused
    assert st['prefix_tokens_saved'] == sum(len(p) + 3 for p, _ in t1)
    assert st['prefix_tokens_saved'] == out['ref'][2]['prefix_tokens_saved']


def test_warm_repeat_captures_nothing_and_skips_the_prefill(model):
    jp, cfg, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', **_kw())
    eng.warmup()
    with eng:
        prompt = _prompt(3, 12)
        cold = eng.submit(prompt, max_new_tokens=6, seed=5).result(
            timeout=120)
        before = eng.stats()
        warm = eng.submit(prompt, max_new_tokens=6, seed=5).result(
            timeout=120)
        after = eng.stats()
    assert warm == cold
    assert eng._trace_count == 2 and after['traces'] == 2
    assert after['prefills'] == before['prefills']
    assert after['prefix_full_hits'] == before['prefix_full_hits'] + 1
    assert after['prefix']['full_hits'] >= 1
    labels = eng.labels
    assert tobs.find('gen.prefix.full_hits', labels).value == 1
    assert tobs.find('gen.prefix.tokens_saved', labels).value == 12
    evs = [e['ev'] for r in tobs.recorder().requests(outcome='ok')
           if r.get('engine') == labels['engine'] for e in r['timeline']]
    assert 'prefix_hit' in evs and 'prefill_skip' in evs


def test_full_hit_is_admitted_by_submit(model):
    """With the scheduler running and nobody queued, a full hit's first
    token is there when ``submit`` returns; its copy-on-write page (the
    prompt ends mid-page) is copied before the slot's first step, or
    before a one-token request that retires inside ``submit`` publishes
    it, so later repeats stream the same and no page is left behind."""
    jp, cfg, tp, tcfg = model
    prompt = _prompt(5, 12)                      # ends mid-page: COW
    with GenerationEngine(tp, tcfg, device='cpu', **_kw()) as eng:
        cold = eng.submit(prompt, max_new_tokens=6, seed=3).result(
            timeout=120)
        fut = eng.submit(prompt, max_new_tokens=6, seed=3)
        assert fut._count() >= 1
        assert fut.result(timeout=120) == cold
        one = eng.submit(prompt, max_new_tokens=1, seed=3)
        assert one.done() and one.result() == cold[:1]
        again = eng.submit(prompt, max_new_tokens=6, seed=3).result(
            timeout=120)
        st = eng.stats()
        eng.clear_prefix_cache()
        free = eng._alloc.free_pages
    assert again == cold
    assert st['prefix_full_hits'] == 3 and st['prefills'] == 1
    assert free == eng.num_pages - 1


def test_copy_on_write_source_is_held_until_the_copy(model):
    """A full hit admitted with its copy-on-write still pending keeps the
    source page allocated after the cache lets it go (cleared here), so
    no later allocation can take and overwrite it first; the copy then
    runs at the slot's first step, the stream equals the cold one, and
    the hold is given back."""
    jp, cfg, tp, tcfg = model
    prompt = _prompt(7, 12)                      # ends mid-page: COW
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **_kw())
    first = eng.submit(prompt, max_new_tokens=6, seed=2)
    eng._drain_inline()                          # on this thread
    cold = first.result(timeout=120)
    fut = eng.submit(prompt, max_new_tokens=6, seed=2)
    with eng._cv:
        (idx,) = eng._admit_locked()
        src, dst = eng._slots[idx].cow
        assert eng._alloc.refcount(src) >= 2     # the cache's + the hold
        eng._prefix.clear()
        assert eng._alloc.refcount(src) == 1     # held, not free
        eng._skip_prefill_locked(idx)
        assert eng._slots[idx].cow == (src, dst)   # not copied yet
    eng._drain_inline()
    assert fut.result(timeout=120) == cold
    eng.shutdown()                               # and clears the cache
    assert eng._alloc.free_pages == eng.num_pages - 1


def test_concurrent_submits_admit_full_hits_without_losing_pages(model):
    """12 client threads (more than the cores) submit warm repeats and
    fresh prompts at once, the interpreter switching threads every 10 us:
    submits admitting full hits race the scheduler admitting the rest.
    Every request completes with its length, every warm one opens with
    its donor's first token, and drain + clear gives every page back."""
    jp, cfg, tp, tcfg = model
    warm = [(_prompt(60 + i, 9 + i), i) for i in range(4)]
    out, errors = {}, []
    with GenerationEngine(tp, tcfg, device='cpu',
                          **_kw(num_pages=40)) as eng:
        first = {s: eng.submit(p, max_new_tokens=4, seed=s).result(
            timeout=120)[0] for p, s in warm}

        def client(k):
            try:
                reqs = warm + [(_prompt(80 + k, 6), 100 + k)]
                futs = [(s, eng.submit(p, max_new_tokens=4, seed=s))
                        for p, s in reqs]
                out[k] = [(s, f.result(timeout=120)) for s, f in futs]
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
        eng.clear_prefix_cache()
        free = eng._alloc.free_pages
    assert not errors and len(out) == 12
    for streams in out.values():
        for s, toks in streams:
            assert len(toks) == 4
            if s in first:
                assert toks[0] == first[s]
    assert st['completed'] == len(warm) + 12 * (len(warm) + 1)
    assert st['prefix_full_hits'] >= 12 * len(warm)
    assert free == eng.num_pages - 1


def test_cross_tenant_never_shares_pages(model):
    jp, cfg, tp, tcfg = model
    prompt = _prompt(21, 12)
    with GenerationEngine(tp, tcfg, device='cpu', **_kw()) as eng:
        a = eng.submit(prompt, max_new_tokens=5, seed=0,
                       tenant='alpha').result(timeout=120)
        st = eng.stats()['prefix']
        b = eng.submit(prompt, max_new_tokens=5, seed=0,
                       tenant='beta').result(timeout=120)
        st2 = eng.stats()['prefix']
        pages = eng.prefix_cache.debug_pages()
    assert st2['misses'] == st['misses'] + 1 and st2['hits'] == st['hits']
    assert set(pages['alpha']) & set(pages['beta']) == set()
    assert a == b


def test_cache_yields_pages_under_pool_pressure_like_reference(model):
    """Distinct prompts through a pool the cache would fill: it evicts
    LRU residency instead of starving live traffic, and with a pool so
    small that slots evict each other the streams still match."""
    reqs = [(_prompt(100 + i, 12), i) for i in range(8)]
    for num_pages in (None, 6):
        jeng, teng = _engines(model, num_pages=num_pages)
        with jeng:
            want = _one_at_a_time(jeng, reqs)
        with teng:
            futs = [teng.submit(p, max_new_tokens=10, seed=s)
                    for p, s in reqs[:3]]
            got = _one_at_a_time(teng, reqs)
            crowd = [f.result(timeout=120) for f in futs]
            st = teng.stats()
        assert got == want
        assert all(len(c) == 10 for c in crowd)
        assert st['prefix']['evictions'] > 0
        assert st['prefix_evictions'] == st['prefix']['evictions']


def test_capacity_knob_bounds_residency(model):
    jp, cfg, tp, tcfg = model
    with GenerationEngine(tp, tcfg, device='cpu',
                          **_kw(prefix_cache_pages=2)) as eng:
        for i in range(4):
            eng.submit(_prompt(200 + i, 12), max_new_tokens=4,
                       seed=i).result(timeout=120)
        assert eng.prefix_cache.capacity_pages == 2
        assert eng.prefix_cache.cached_pages <= 2
        eng.set_prefix_capacity(0)
        assert eng.prefix_cache.cached_pages == 0
        assert tobs.find('gen.prefix.cached_pages', eng.labels).value == 0


def test_drain_plus_clear_restores_every_page(model):
    jp, cfg, tp, tcfg = model
    eng = GenerationEngine(tp, tcfg, device='cpu', **_kw())
    with eng:
        futs = [eng.submit(_prompt(300 + i, 13), max_new_tokens=4, seed=i)
                for i in range(4)]
        [f.result(timeout=120) for f in futs]
        assert eng.prefix_cache.cached_pages > 0
        assert eng.clear_prefix_cache() > 0
        assert eng.prefix_cache.cached_pages == 0
        assert eng._alloc.free_pages == eng.num_pages - 1
    # shutdown clears what later traffic cached
    eng2 = GenerationEngine(tp, tcfg, device='cpu', **_kw())
    with eng2:
        eng2.submit(_prompt(310, 13), max_new_tokens=4).result(timeout=120)
        assert eng2._alloc.free_pages < eng2.num_pages - 1
    assert eng2._alloc.free_pages == eng2.num_pages - 1


def test_off_by_default_and_by_the_env_knob(model, monkeypatch):
    jp, cfg, tp, tcfg = model
    monkeypatch.delenv('PADDLE_TPU_GEN_PREFIX', raising=False)
    kw = _kw(prefix_cache=None)
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **kw)
    assert eng.prefix_cache is None and eng.stats()['prefix'] is None
    assert eng.clear_prefix_cache() == 0
    eng.set_prefix_capacity(3)                   # a no-op without a cache
    eng.shutdown()
    monkeypatch.setenv('PADDLE_TPU_GEN_PREFIX', '1')
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **kw)
    assert isinstance(eng.prefix_cache, PrefixCache)
    eng.shutdown()
    monkeypatch.setenv('PADDLE_TPU_GEN_PREFIX', '0')
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False, **kw)
    assert eng.prefix_cache is None
    eng.shutdown()
    # a residency bound turns it on; an explicit False keeps it off
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False,
                           **_kw(prefix_cache=None, prefix_cache_pages=4))
    assert eng.prefix_cache.capacity_pages == 4
    eng.shutdown()
    monkeypatch.setenv('PADDLE_TPU_GEN_PREFIX', '1')
    eng = GenerationEngine(tp, tcfg, device='cpu', autostart=False,
                           **_kw(prefix_cache=False))
    assert eng.prefix_cache is None
    eng.shutdown()


def test_future_snapshot_and_subscribe():
    fut = GenerationFuture()
    fut._append(3)
    fut._append(5)
    assert fut._snapshot(1) == [3] and fut._snapshot(9) == [3, 5]
    seen = []
    fut._subscribe(lambda kind, *a: seen.append((kind,) + a))
    fut._append(8)
    fut._finish()
    fut._append(9)                               # after finish: ignored
    assert seen == [('token', 0, 3), ('token', 1, 5), ('token', 2, 8),
                    ('finish', None)]
    late = []
    fut._subscribe(lambda kind, *a: late.append((kind,) + a))
    assert late == seen
