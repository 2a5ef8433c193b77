"""The multi-tenant model host of paddle_tpu_torch (serving/host.py) against
the JAX package's, on the CPU.

The reference's tiny GPT (vocab 97, hidden 32, 2 layers, 2 heads, f32;
block matrices x10) carried over with ``gpt.params_from_numpy``: every
stream a hosted model serves, before and after an eviction and behind a
``model@host`` fleet target, equals the reference engine's for the same
prompt and seed. The behaviour ``tests/test_host.py`` asserts of the
reference is held of the port: admission under the watermark and its
refusal without stripping the host, LRU eviction and swap-in, pinned and
in-flight models kept, batch-lane caps and SLO shedding with
``retry_after_ms``, tenant quotas, the per-tenant flight recorder, and the
``host.admit`` / ``host.evict`` chaos points. Known differences (ROADMAP
Queue 3): a swapped-in engine captures its graphs again before the submit
goes on (its first request adds no capture; ``traces`` reads the
count of its graphs, not the reference's 0), and the footprint is read
from the engine: its tensors' bytes, and on the card its graphs' pools.
"""
import dataclasses
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationEngine as JEngine
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import fault, nn
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import server as _server
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import (FleetRouter, GenerationEngine,
                                      HBMAdmissionError, InferenceEngine,
                                      ModelHost, QueueFullError, ReplicaSet,
                                      get_host, resolve_target)
from paddle_tpu_torch.serving import host as host_mod

MB = 1 << 20

CFG = jgpt.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                     num_heads=2, max_seq_len=32, dtype='float32',
                     remat=False, use_flash=False)

# (prompt, new tokens, seed): every stream this file checks
HETERO = (np.array([3, 1, 4, 1, 5]), 8, 7)
LRU = (np.array([2, 7, 1, 8]), 6, 3)
TARGET = (np.array([5, 2, 9]), 6, 11)


@pytest.fixture(scope='module')
def params():
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(CFG, jax.random.PRNGKey(0)))
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(CFG))
    return jp, tgpt.params_from_numpy(jp, tcfg, 'cpu'), tcfg


@pytest.fixture(scope='module')
def ref_streams(params):
    """The reference engine's stream for each (prompt, new, seed)."""
    eng = JEngine(params[0], CFG, num_slots=2, page_size=8,
                  prefill_width=16)
    try:
        return {id(case): eng.submit(case[0], max_new_tokens=case[1],
                                     seed=case[2]).result(timeout=120)
                for case in (HETERO, LRU, TARGET)}
    finally:
        eng.shutdown()


@pytest.fixture(autouse=True)
def _clean():
    prev = port_device._current
    port.set_device('cpu')
    obs.set_enabled(True)
    obs.reset()
    with _server._probes_lock:
        probes0 = dict(_server._probes)
    yield
    fault.configure(None)
    obs.shutdown_telemetry()
    with _server._probes_lock:
        _server._probes.clear()
        _server._probes.update(probes0)
    obs.reset()
    port_device._current = prev


def _gen_factory(params, **kw):
    _, tp, tcfg = params

    def factory():
        kw.setdefault('num_slots', 2)
        kw.setdefault('page_size', 8)
        kw.setdefault('prefill_width', 16)
        kw.setdefault('queue_capacity', 16)
        return GenerationEngine(tp, tcfg, device='cpu', **kw)
    return factory


def _net():
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _infer_factory(net=None, **kw):
    def factory():
        kw.setdefault('max_batch_size', 8)
        kw.setdefault('max_delay_ms', 0.5)
        kw.setdefault('queue_capacity', 16)
        return InferenceEngine(net if net is not None else _net(), **kw)
    return factory


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _submit(host, model, case, **kw):
    prompt, new, seed = case
    return host.submit(model, prompt, max_new_tokens=new, seed=seed, **kw)


# ---------------------------------------------------------------------------
# deploy / submit / registry
# ---------------------------------------------------------------------------

def test_host_serves_heterogeneous_models(params, ref_streams):
    with ModelHost(hbm_watermark_bytes=256 * MB, name='hetero') as host:
        host.deploy('chat', _gen_factory(params))
        host.deploy('vision', _infer_factory(),
                    input_spec=[((8,), 'float32')])
        got = _submit(host, 'chat', HETERO, tenant='acme').result(
            timeout=120)
        assert got == ref_streams[id(HETERO)]
        out = host.submit('vision', np.zeros((8,), np.float32),
                          tenant='acme').result(timeout=120)
        assert np.asarray(out).shape == (4,)
        models = host.models()
        assert models['chat']['kind'] == 'gen'
        assert models['vision']['kind'] == 'infer'
        assert all(d['state'] == 'live' for d in models.values())
        # measured footprints are real and accounted against the watermark
        st = host.stats()
        assert 0 < st['hbm_used_bytes'] <= host.watermark_bytes
        # the registry resolves model@host targets
        assert get_host('hetero') is host
        h, m = resolve_target('chat@hetero')
        assert h is host and m == 'chat'
    with pytest.raises(ValueError):
        resolve_target('no-at-sign')
    with pytest.raises(KeyError):
        resolve_target('chat@hetero')           # closed: unregistered


def test_cpu_footprint_is_the_engines_tensor_bytes(params):
    with ModelHost(hbm_watermark_bytes=256 * MB, name='fp') as host:
        host.deploy('chat', _gen_factory(params))
        host.deploy('vision', _infer_factory())
        for name in ('chat', 'vision'):
            eng = host._models[name].engine
            tensors = [t for a in ('_params', '_buffers', '_pool')
                       for t in _leaves(getattr(eng, a, None))]
            tensors += [t for f in host_mod._captured_fns(eng)
                        for t in f.buffers.values()]
            # each storage once: the graphs' static inputs and the pool
            # are the engine's own, the weights its serving copy
            want = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in tensors}
            assert len(want) > 2
            assert host.models()[name]['footprint_bytes'] == \
                sum(want.values())
        assert host.stats()['hbm_used_bytes'] == sum(
            d['footprint_bytes'] for d in host.models().values())
    # the default watermark is the card's free memory: none on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='CUDA'):
            ModelHost(name='nocard')
    # deploy(mp=N) is ported (step K3): the factory is called with mp=N,
    # and a virtual mesh's footprint is every shard's bytes on its device
    from paddle_tpu_torch.parallel import MeshContext

    def mesh_factory(mp):
        return GenerationEngine(
            params[1], params[2],
            mesh=MeshContext.build(mp, devices=['cpu'] * mp), num_slots=2,
            page_size=8, prefill_width=16, queue_capacity=16)
    with ModelHost(hbm_watermark_bytes=256 * MB, name='mp') as host:
        m = host.deploy('x', mesh_factory, mp=2)
        eng = host._models['x'].engine
        assert eng.stats()['mesh']['mp'] == 2
        assert m.footprint_bytes == sum(host_mod._storages(
            eng._params, eng._pool,
            [f.buffers for f in host_mod._captured_fns(eng)]).values())


def test_admission_refused_over_watermark_without_stripping(params):
    with ModelHost(hbm_watermark_bytes=11 * MB, name='tight') as host:
        host.deploy('a', _gen_factory(params), footprint_bytes=4 * MB)
        host.deploy('b', _gen_factory(params), footprint_bytes=4 * MB)
        # 40 MB can never fit, even after evicting every cold model:
        # the host must refuse up front and evict NOTHING
        with pytest.raises(HBMAdmissionError) as ei:
            host.deploy('huge', _gen_factory(params),
                        footprint_bytes=40 * MB)
        assert ei.value.needed_bytes == 40 * MB
        assert ei.value.watermark_bytes == 11 * MB
        states = {n: d['state'] for n, d in host.models().items()}
        assert states == {'a': 'live', 'b': 'live'}
        assert host.stats()['rejected'] == 1
        assert host.stats()['evictions'] == 0


def test_lru_eviction_and_swap_in_adds_no_capture(params, ref_streams):
    with ModelHost(hbm_watermark_bytes=9 * MB, name='lru') as host:
        host.deploy('a', _gen_factory(params), footprint_bytes=4 * MB)
        host.deploy('b', _gen_factory(params), footprint_bytes=4 * MB)
        # touch 'b' so 'a' is the LRU victim
        host.submit('b', LRU[0], max_new_tokens=2).result(timeout=120)
        host.deploy('c', _gen_factory(params), footprint_bytes=4 * MB)
        states = {n: d['state'] for n, d in host.models().items()}
        assert states == {'a': 'evicted', 'b': 'live', 'c': 'live'}
        desc = host.models()['a']
        # a generation model keeps no manifest: its swap-in warms up
        assert desc['warm_retained'] and not desc['has_manifest']
        assert host._models['a'].engine is None
        assert host.stats()['hbm_used_bytes'] <= 9 * MB
        # submitting to the evicted model swaps it back in transparently
        # (cascading the LRU eviction onto 'b'), its graphs captured
        # before the submit goes on, and streams the reference's tokens
        loads = _build.loads
        host.admit('a')
        eng = host._models['a'].engine
        assert eng._warmed and eng.stats()['traces'] == 2
        got = _submit(host, 'a', LRU).result(timeout=120)
        assert got == ref_streams[id(LRU)]
        assert host.models()['a']['state'] == 'live'
        assert eng.stats()['traces'] == 2            # no capture added
        assert _build.loads == loads                  # no kernel built
        assert host.stats()['swap_ins'] == 1
        assert host.stats()['hbm_used_bytes'] <= 9 * MB


def test_transparent_swap_in_on_submit_restores_infer_buckets():
    with ModelHost(hbm_watermark_bytes=64 * MB, name='swapi') as host:
        # the factory's closure holds the weights across the eviction
        host.deploy('m', _infer_factory(_net()),
                    input_spec=[((8,), 'float32')])
        x = np.random.RandomState(0).rand(3, 8).astype('float32')
        before = np.asarray(host.submit('m', x).result(timeout=60))
        traces = host._models['m'].engine.stats()['traces']
        host.evict('m')
        assert host.models()['m']['state'] == 'evicted'
        after = np.asarray(host.submit('m', x).result(timeout=60))
        eng = host._models['m'].engine
        np.testing.assert_array_equal(after, before)
        # the ladder captured again at swap-in, nothing at the request
        assert eng.stats()['traces'] == traces == 4
        assert eng.stats()['cache_misses'] == 0
        assert host.stats()['swap_ins'] == 1


def test_infer_swap_in_captures_the_buckets_its_engine_had():
    with ModelHost(hbm_watermark_bytes=64 * MB, name='swapb') as host:
        host.deploy('m', _infer_factory(_net()), warm=False)
        x = np.random.RandomState(1).rand(3, 8).astype('float32')
        before = np.asarray(host.submit('m', x).result(timeout=60))
        assert host._models['m'].engine.stats()['traces'] == 1
        assert not host.models()['m']['has_manifest']
        host.evict('m')
        # the manifest is the one bucket traffic captured (3 rows: 4)
        desc = host.models()['m']
        assert desc['has_manifest'] and desc['warm_retained']
        assert [e['bucket'] for e in host._models['m'].manifest] == [4]
        host.admit('m')
        eng = host._models['m'].engine
        assert eng.stats()['traces'] == 1
        after = np.asarray(host.submit('m', x).result(timeout=60))
        np.testing.assert_array_equal(after, before)
        assert eng.stats()['traces'] == 1 and eng.stats()['cache_misses'] == 0


def test_explicit_evict_refuses_inflight_and_pinned(params):
    with ModelHost(hbm_watermark_bytes=64 * MB, name='pin') as host:
        host.deploy('a', _infer_factory(autostart=False), warm=False,
                    footprint_bytes=MB)
        host.deploy('p', _gen_factory(params), pin=True,
                    footprint_bytes=MB)
        host.submit('a', np.zeros((8,), np.float32))
        with pytest.raises(RuntimeError, match='in flight'):
            host.evict('a')
        # a pinned model is never an eviction candidate: 64 MB would fit
        # only by evicting 'p' too, so admission must refuse up front
        with pytest.raises(HBMAdmissionError):
            host.deploy('big', _gen_factory(params),
                        footprint_bytes=64 * MB)
        assert host.models()['p']['state'] == 'live'
        assert host.models()['a']['state'] == 'live'
        host.close(drain=False)


# ---------------------------------------------------------------------------
# lanes / quotas / shedding
# ---------------------------------------------------------------------------

def test_batch_lane_capped_with_retry_hint():
    with ModelHost(hbm_watermark_bytes=64 * MB, name='lanes',
                   batch_share=0.25) as host:
        # stalled engine: submissions queue but never complete, so lane
        # accounting is fully deterministic
        host.deploy('m', _infer_factory(autostart=False), warm=False)
        x = np.zeros((8,), np.float32)
        cap = max(1, int(16 * 0.25))
        for _ in range(cap):
            host.submit('m', x, lane='batch', tenant='bulk')
        with pytest.raises(QueueFullError) as ei:
            host.submit('m', x, lane='batch', tenant='bulk')
        assert ei.value.retry_after_ms is not None
        assert ei.value.retry_after_ms > 0
        # the interactive lane is NOT subject to the batch cap
        host.submit('m', x, lane='interactive', tenant='acme')
        assert host.stats()['shed'] == 1
        with pytest.raises(ValueError):
            host.submit('m', x, lane='bulk')
        host.close(drain=False)


def test_slo_breach_sheds_batch_lane_only(params):
    with ModelHost(hbm_watermark_bytes=64 * MB, name='slo',
                   interactive_p99_ms=1e-6, slo_interval=0.02,
                   slo_debounce=1) as host:
        host.deploy('chat', _gen_factory(params))
        # any real queue wait breaches a ~0 p99 budget; generate samples
        # until the host's watcher flips the model into batch shedding
        deadline = time.time() + 30
        while not host.models()['chat']['shed_batch']:
            host.submit('chat', np.array([3, 1, 4]),
                        max_new_tokens=2).result(timeout=120)
            assert time.time() < deadline, 'SLO rule never fired'
            time.sleep(0.02)
        with pytest.raises(QueueFullError) as ei:
            host.submit('chat', np.array([3, 1, 4]), lane='batch',
                        max_new_tokens=2)
        assert ei.value.retry_after_ms is not None
        # interactive traffic still flows while batch is shed
        got = host.submit('chat', np.array([3, 1, 4]), lane='interactive',
                          max_new_tokens=2).result(timeout=120)
        assert len(got) == 2
        shed = obs.find('host.shed', {'host': 'slo', 'model': 'chat',
                                      'tenant': 'default', 'lane': 'batch',
                                      'reason': 'slo'})
        assert shed is not None and shed.value >= 1


def test_tenant_quota_and_accounting():
    with ModelHost(hbm_watermark_bytes=64 * MB, name='quota') as host:
        host.deploy('m', _infer_factory(autostart=False), warm=False)
        host.set_quota('acme', 1)
        x = np.zeros((8,), np.float32)
        host.submit('m', x, tenant='acme')
        with pytest.raises(QueueFullError):
            host.submit('m', x, tenant='acme')
        # another tenant is unaffected by acme's quota
        host.submit('m', x, tenant='other')
        t = host.tenants()
        assert t['acme'] == {'inflight': 1, 'quota': 1}
        assert t['other'] == {'inflight': 1, 'quota': None}
        host.close(drain=False)


def test_per_tenant_flight_recorder_and_debug_endpoint():
    with ModelHost(hbm_watermark_bytes=64 * MB, name='trace') as host:
        host.deploy('m', _infer_factory())
        x = np.zeros((8,), np.float32)
        host.submit('m', x, tenant='acme').result(timeout=120)
        host.submit('m', x, tenant='acme', lane='batch').result(timeout=120)
        host.submit('m', x, tenant='bulk').result(timeout=120)
        recs = obs.recorder().requests(tenant='acme')
        assert len(recs) == 2
        assert all(r['attrs']['tenant'] == 'acme' for r in recs)
        assert {r['attrs']['lane'] for r in recs} == \
            {'interactive', 'batch'}
        assert all(r['attrs']['host'] == 'trace' for r in recs)
        # the tenant filter is live on the telemetry plane too
        srv = obs.serve_telemetry(port=0)
        try:
            with urllib.request.urlopen(
                    f'{srv.url}/debug/requests?tenant=bulk') as resp:
                doc = json.loads(resp.read())
            assert doc['count'] == 1
            assert doc['requests'][0]['attrs']['tenant'] == 'bulk'
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# fleet front door: model@host targeting
# ---------------------------------------------------------------------------

def test_fleet_router_targets_hosted_model(params, ref_streams):
    with ModelHost(hbm_watermark_bytes=64 * MB, name='behind') as host:
        host.deploy('chat', _gen_factory(params))
        rs = ReplicaSet(replicas=[_gen_factory(params, num_slots=1)()])
        router = FleetRouter(rs, tick_s=0.05)
        try:
            prompt, new, seed = TARGET
            got = router.submit(prompt, max_new_tokens=new, seed=seed,
                                target='chat@behind',
                                tenant='acme').result(timeout=120)
            assert got == ref_streams[id(TARGET)]
            routed = obs.find('fleet.host_routed', {'fleet': rs.name})
            assert routed is not None and routed.value == 1
            # host-targeted traffic is attributed to the tenant
            c = obs.find('host.requests',
                         {'host': 'behind', 'model': 'chat',
                          'tenant': 'acme', 'lane': 'interactive'})
            assert c is not None and c.value == 1
            assert rs.snapshot()[0].engine.stats()['submitted'] == 0
        finally:
            router.close(drain=False)


# ---------------------------------------------------------------------------
# chaos points
# ---------------------------------------------------------------------------

def test_chaos_host_admit_aborts_deploy_cleanly(params):
    with ModelHost(hbm_watermark_bytes=64 * MB, name='chaos1') as host:
        host.deploy('a', _gen_factory(params), footprint_bytes=MB)
        used = host.stats()['hbm_used_bytes']
        fault.configure('host.admit:1.0', seed=1, max_faults=1)
        try:
            with pytest.raises(fault.InjectedFault):
                host.deploy('b', _gen_factory(params), footprint_bytes=MB)
        finally:
            fault.configure(None)
        # the aborted deploy left no trace: no model, no reserved bytes
        assert 'b' not in host.models()
        assert host.stats()['hbm_used_bytes'] == used
        # and a retry (fault disarmed) succeeds
        host.deploy('b', _gen_factory(params), footprint_bytes=MB)
        assert host.models()['b']['state'] == 'live'


def test_chaos_host_evict_aborts_leaving_victim_live(params):
    with ModelHost(hbm_watermark_bytes=64 * MB, name='chaos2') as host:
        host.deploy('a', _gen_factory(params), footprint_bytes=MB)
        fault.configure('host.evict:1.0', seed=1, max_faults=1)
        try:
            with pytest.raises(fault.InjectedFault):
                host.evict('a')
        finally:
            fault.configure(None)
        assert host.models()['a']['state'] == 'live'
        assert host.stats()['evictions'] == 0
        # still serving after the aborted eviction
        got = host.submit('a', np.array([3, 1, 4]),
                          max_new_tokens=2).result(timeout=120)
        assert len(got) == 2
