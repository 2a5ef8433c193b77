"""Mesh-sharded serving on the port (parallel/mesh_engine.py,
serving/sharded.py) against the reference's tests/test_mesh_engine.py:
the rules for the paged-KV axes, MeshContext placement and its
fallbacks, the pool split on its heads, streams at mp=2 (greedy equal to
the reference's mp=2 engine token for token, for GPT over f32 and int8
pools and for MoE; greedy and sampled equal to the port's mp=1 engine),
two captures at every mesh size, the mesh gauge beside unchanged labels, a
warm spawn, the int8_wo refusal, the InferenceEngine at mp=2 against the
reference's, MeshReplica, the host's deploy(mp=2) with its swap-in and the
fleet's replica_mesh. The mesh is a virtual one of CPU shards
(``devices=['cpu'] * mp``), the counterpart of the reference's virtual
CPU devices."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import moe_gpt as jmoe
from paddle_tpu.ops.paged_kv import POOL_LOGICAL_AXES as REF_POOL_AXES
from paddle_tpu.parallel import Partitioner as RefPartitioner
from paddle_tpu.parallel import serving_rules as ref_serving_rules
from paddle_tpu.serving import sharded_generation_engine as ref_sharded

from paddle_tpu_torch.models import gpt, moe_gpt
from paddle_tpu_torch.ops.paged_kv import POOL_LOGICAL_AXES
from paddle_tpu_torch.parallel import (MeshContext, Partitioner,
                                       ShardingRuleError, mesh_engine,
                                       serving_rules)
from paddle_tpu_torch.serving import (GenerationEngine, MeshReplica,
                                      ModelHost, ReplicaSet,
                                      sharded_generation_engine,
                                      sharded_inference_engine)

pytestmark = pytest.mark.mesh

ENGINE_KW = dict(num_slots=4, page_size=16, prefill_width=32,
                 queue_capacity=16)
PROMPT = [5, 11, 23, 42]


def cpus(mp):
    return ['cpu'] * mp


def tiny_cfg(**over):
    kw = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
              max_seq_len=64, dtype='float32', remat=False, use_flash=False)
    kw.update(over)
    return kw


@pytest.fixture(scope='module')
def model():
    """The reference's tiny GPT (block matrices x10, so streams depend on
    context) -> (its params, its config, the port's params, config)."""
    jcfg = jgpt.GPTConfig(**tiny_cfg())
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    jp['blocks'] = {k: (v * 10 if k.endswith('_w') else v)
                    for k, v in jp['blocks'].items()}
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = gpt.GPTConfig(**tiny_cfg())
    return jp, jcfg, gpt.params_from_numpy(tree, tcfg, 'cpu'), tcfg


def engine(params, cfg, mp, **over):
    kw = dict(ENGINE_KW, **over)
    if mp > 1:
        return sharded_generation_engine(params, cfg, mp=mp,
                                         devices=cpus(mp), **kw)
    return GenerationEngine(params, cfg, device='cpu', **kw)


def run_stream(eng, prompt=PROMPT, n=12, seed=7):
    try:
        toks = list(eng.submit(prompt, max_new_tokens=n,
                               seed=seed).result(timeout=120))
        return toks, eng.stats()
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# rules: kv_heads / kv_pages at mp 1, 2, 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mp', [1, 2, 4])
def test_serving_rules_resolve_pool_axes(mp):
    assert POOL_LOGICAL_AXES == REF_POOL_AXES
    spec = Partitioner(rules=serving_rules(mp=mp)).spec(POOL_LOGICAL_AXES)
    want = RefPartitioner(rules=ref_serving_rules(mp=mp)).spec(
        REF_POOL_AXES)
    assert tuple(spec) == tuple(want) == (None, None, None, 'mp', None)


@pytest.mark.parametrize('mp', [1, 2, 4])
def test_pool_spec_on_live_mesh(mp):
    ctx = MeshContext.build(mp, devices=cpus(mp))
    assert tuple(ctx.pool_spec())[:4] == (None, None, None, 'mp')
    assert ctx.mesh.size == mp


@pytest.mark.parametrize('mp', [2, 4])
def test_kv_pages_explicitly_replicated(mp):
    assert tuple(Partitioner(rules=serving_rules(mp=mp)).spec(
        ('kv_pages',))) == (None,)


def test_trash_page_count_indivisible_raises_without_none_rule():
    pt = Partitioner(rules=(('kv_pages', 'mp'),),
                     mesh=mesh_engine.build_mesh(2, devices=cpus(2)))
    with pytest.raises(ShardingRuleError):
        pt.spec(('kv_pages',), shape=(9,))   # 4 slots * 2 pages + trash


def test_taken_axis_falls_through_to_replicated():
    pt = Partitioner(rules=serving_rules(mp=2))
    assert tuple(pt.spec(('kv_heads', 'kv_heads'))) == ('mp', None)


def test_model_and_pool_rules_coexist():
    pt = Partitioner(rules=serving_rules(mp=2))
    assert tuple(pt.spec(('layers', 'embed', 'heads'))) == (None, None, 'mp')
    assert tuple(pt.spec(('kv_heads',))) == ('mp',)


# ---------------------------------------------------------------------------
# MeshContext and placement
# ---------------------------------------------------------------------------

def test_mesh_context_build_and_describe():
    d = MeshContext.build(2, devices=cpus(2)).describe()
    assert d['mp'] == 2 and d['devices'] == 2 and d['axes']['mp'] == 2
    assert all(v == 1 for k, v in d['axes'].items() if k != 'mp')


def test_build_mesh_uses_exactly_mp_devices():
    assert mesh_engine.build_mesh(2, devices=cpus(3)).size == 2
    if torch.cuda.device_count() < 2:
        # as the reference: fewer devices than the degree raise
        with pytest.raises(ValueError, match='devices requested'):
            mesh_engine.build_mesh(2)
    with pytest.raises(ValueError):
        mesh_engine.build_mesh(0, devices=cpus(1))


def test_place_pool_shards_heads_axis():
    cfg = gpt.GPTConfig(**tiny_cfg())
    ctx = MeshContext.build(2, devices=cpus(2))
    pool = gpt.init_paged_kv_cache(cfg, num_pages=9, page_size=16,
                                   device='cpu')
    pool['k'].normal_()
    shards = ctx.place_pool(pool)
    for i, sh in enumerate(shards):
        assert tuple(sh['k'].shape) == (2, 9, 16, 1, 16)
        assert torch.equal(sh['k'], pool['k'][:, :, :, i:i + 1])
    # the engine allocates each shard's pool at its block's shape
    k = ctx.pool(dataclass_cfg(kv_cache_int8=True), 9, 16)[1]['k']
    assert tuple(k['int8'].shape) == (2, 9, 16, 1, 16)
    assert tuple(k['scale'].shape) == (2, 9, 16, 1)


def dataclass_cfg(**over):
    return gpt.GPTConfig(**tiny_cfg(**over))


def test_indivisible_param_falls_back_replicated(model):
    # vocab 97 does not divide 2: wte stays whole on every shard and the
    # fallback is recorded (memory, never correctness)
    cfg = gpt.GPTConfig(**tiny_cfg(vocab_size=97))
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    ctx = MeshContext.build(2, devices=cpus(2))
    placed = ctx.place_params(params, cfg)
    assert all(e is None for e in placed['wte'].spec)
    assert all(b.shape == (97, 32) for b in placed['wte'].blocks)
    assert any(f['tensor'] == 'wte' for f in ctx.fallbacks)
    # the split parts are Megatron's: qkv columns, proj rows, fc / out
    assert tuple(placed['blocks']['qkv_w'].spec) == (None, None, 'mp')
    assert placed['blocks']['proj_w'].blocks[1].shape == (2, 16, 32)


def test_resolve_normalizes_engine_mesh_arg():
    assert mesh_engine.resolve(None) is None
    assert mesh_engine.resolve(None, mp=1) is None
    ctx = mesh_engine.resolve(None, mp=2, devices=cpus(2))
    assert isinstance(ctx, MeshContext) and ctx.mp == 2
    assert mesh_engine.resolve(ctx) is ctx
    assert mesh_engine.resolve(ctx.mesh).mp == 2
    with pytest.raises(TypeError, match='mesh='):
        mesh_engine.resolve(object())


def test_sharded_structs_preserve_placement():
    ctx = MeshContext.build(2, devices=cpus(2))
    x = ctx.place_leaf(torch.zeros(4, 8), ('kv_heads', None))
    st = mesh_engine.sharded_structs({'x': x})['x']
    assert st.spec == ('mp', None) and st.shape == (4, 8)
    assert st.devices == ('cpu', 'cpu')
    st2 = mesh_engine.sharded_structs({'y': np.zeros((3,), np.int32)})['y']
    assert st2.spec is None and st2.shape == (3,)


# ---------------------------------------------------------------------------
# streams and captures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('temperature,int8_pool',
                         [(0.0, False), (0.8, False), (0.0, True)],
                         ids=['greedy', 'sampled', 'greedy_int8_pool'])
def test_byte_parity_mp1_vs_mp2(model, temperature, int8_pool):
    """mp=2 equals mp=1 token for token (sampling keys fold (seed,
    position) only), two captures at both sizes; greedy also equals the
    reference's mp=2 engine (sampled streams differ from the reference's
    jax.random draws by design), over the f32 pool and the int8 one (each
    shard's bank and scales on its kv heads)."""
    jp, jcfg, tp, tcfg = model
    if int8_pool:
        jcfg = jgpt.GPTConfig(**tiny_cfg(kv_cache_int8=True))
        tcfg = gpt.GPTConfig(**tiny_cfg(kv_cache_int8=True))
    t1, s1 = run_stream(engine(tp, tcfg, 1, temperature=temperature))
    t2, s2 = run_stream(engine(tp, tcfg, 2, temperature=temperature))
    assert t1 == t2
    assert s1['traces'] == 2 and s2['traces'] == 2
    assert s1['mesh'] is None and s2['mesh']['mp'] == 2
    if temperature == 0.0:
        assert t2 == ref_stream(jp, jcfg, 2)


def ref_stream(jp, jcfg, mp, prompt=PROMPT, n=12, seed=7):
    """The reference's greedy stream from its mp-way engine."""
    ref = ref_sharded(jp, jcfg, mp=mp, **ENGINE_KW)
    try:
        return list(ref.submit(prompt, max_new_tokens=n,
                               seed=seed).result(timeout=120))
    finally:
        ref.shutdown()


def test_moe_engine_at_mp2_equals_mp1():
    """MoE over the mesh (``moe_gpt.mesh_cached_block``: the routing once
    a device, each shard's experts over their FFN columns, the combines
    summed): the greedy stream equals the reference's mp=2 engine's, which
    places the MoE parameters by ``moe_gpt.LOGICAL_AXES``; the sampled
    stream equals the port's mp=1 engine's."""
    jcfg = jmoe.MoEConfig(**tiny_cfg(n_experts=4, capacity_factor=8.0))
    jp = jax.tree_util.tree_map(np.asarray,
                                jmoe.init_params(jcfg, jax.random.PRNGKey(1)))
    for k in ('qkv_w', 'proj_w', 'gate_w', 'w_in', 'w_out'):
        jp['blocks'][k] = jp['blocks'][k] * np.float32(10)
    cfg = moe_gpt.MoEConfig(**tiny_cfg(n_experts=4, capacity_factor=8.0))
    p = gpt.params_from_numpy(jp, cfg, 'cpu')
    t2, s2 = run_stream(engine(p, cfg, 2))
    assert t2 == ref_stream(jp, jcfg, 2) and s2['traces'] == 2
    t1, _ = run_stream(engine(p, cfg, 1, temperature=0.8))
    t2, s2 = run_stream(engine(p, cfg, 2, temperature=0.8))
    assert t1 == t2 and s2['traces'] == 2


def test_mesh_gauge_and_uniform_labels(model):
    from paddle_tpu_torch import observability as obs
    _, _, tp, tcfg = model
    eng = engine(tp, tcfg, 2)
    try:
        assert set(eng.labels) == {'engine'}
        g = obs.find('gen.mesh_devices', {**eng.labels, 'mesh': 'mp2'})
        assert g is not None and g.value == 2
    finally:
        eng.shutdown()


def test_warmup_then_traffic_and_a_warm_spawn_keep_two_traces(model):
    """warmup() makes two captures and traffic adds none; a replica that
    a ReplicaSet spawns from the same factory is warmed (its own two
    captures over its own shards) before it serves, and its first request
    adds none (the port's warmth is a re-capture: ROADMAP known
    differences)."""
    _, _, tp, tcfg = model
    rs = ReplicaSet(lambda: engine(tp, tcfg, 2), initial=1)
    try:
        src = rs.snapshot()[0].engine
        src.warmup()
        assert src._trace_count == 2
        out1 = list(src.submit([3, 1, 4], max_new_tokens=6).result(
            timeout=120))
        assert src._trace_count == 2
        dst = rs.spawn().engine
        assert dst._trace_count == 2
        out2 = list(dst.submit([3, 1, 4], max_new_tokens=6).result(
            timeout=120))
        assert dst._trace_count == 2 and out1 == out2
    finally:
        rs.close()


def test_mesh_engine_rejects_int8_wo(model):
    _, _, tp, tcfg = model
    with pytest.raises(ValueError, match='int8_wo'):
        sharded_generation_engine(tp, tcfg, mp=2, devices=cpus(2),
                                  precision='int8_wo', **ENGINE_KW)


def test_inference_engine_parity_mp2(model):
    """The port's InferenceEngine at mp=2 against the reference's
    ``sharded_inference_engine`` at mp=2, on the same network's weights."""
    import paddle_tpu as ref
    import paddle_tpu_torch as tpaddle
    from paddle_tpu.serving import sharded_inference_engine as ref_inf
    tpaddle.set_device('cpu')

    def mlp(P):
        net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.GELU(),
                              P.nn.Linear(16, 8))
        net.eval()
        return net
    ref.seed(0)
    rnet, net = mlp(ref), mlp(tpaddle)
    net.set_state_dict({k: np.asarray(v.numpy())
                        for k, v in rnet.state_dict().items()})
    x = np.arange(24, dtype=np.float32).reshape(3, 8) / 24
    e1 = ref_inf(rnet, mp=2, max_batch_size=4, max_delay_ms=1)
    try:
        want = np.asarray(e1.submit(x).result(timeout=120))
    finally:
        e1.shutdown()
    e2 = sharded_inference_engine(net, mp=2, devices=cpus(2),
                                  max_batch_size=4, max_delay_ms=1)
    try:
        got = np.asarray(e2.submit(x).result(timeout=120))
        assert e2.stats()['mesh']['mp'] == 2
    finally:
        e2.shutdown()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # a split annotation on a plain layer's parameter now serves: the
    # layer has no sharded forward (meta_parallel's layers do), so the
    # parameter is placed whole, recorded as a fallback, held to mp = 1
    net[0].weight.logical_axes = ('embed', 'mlp')
    e3 = sharded_inference_engine(net, mp=2, devices=cpus(2),
                                  max_batch_size=4, max_delay_ms=1)
    try:
        split = np.asarray(e3.submit(x).result(timeout=120))
        fb = e3.stats()['mesh']['fallbacks']
    finally:
        e3.shutdown()
    np.testing.assert_allclose(split, got, atol=1e-6)
    assert [f['tensor'] for f in fb] == ['0.weight']


def test_mesh_replica_wrapper(model):
    _, _, tp, tcfg = model
    rep = MeshReplica(tp, tcfg, mp=2, devices=cpus(2), **ENGINE_KW)
    try:
        list(rep.submit([9, 9], max_new_tokens=4).result(timeout=120))
        st = rep.stats()
        assert rep.mp == 2 and st['mesh']['mp'] == 2
        assert 'per_chip_tokens_per_sec' in st
    finally:
        rep.shutdown()
    rep = MeshReplica(tp, tcfg, mp=1, device='cpu', **ENGINE_KW)
    try:
        assert rep.mp == 1 and rep.mesh_ctx is None
    finally:
        rep.shutdown()


# ---------------------------------------------------------------------------
# the host's deploy(mp=2) and the fleet's replica_mesh
# ---------------------------------------------------------------------------

def _mesh_factory(params, cfg):
    def factory(mp=2):
        return sharded_generation_engine(params, cfg, mp=mp,
                                         devices=cpus(mp), **ENGINE_KW)
    return factory


def test_host_admits_and_swaps_mp2_models(model):
    """Admission by the bytes of the device holding the most: on a
    virtual mesh every shard's bytes (the reference divides a mesh's
    footprint by its size; on one device that would admit mp times what
    it holds). Room for one model: deploying the second evicts the first,
    and its swap-in rebuilds the mesh (factory(mp=2)) with the same
    stream, two captures, mesh_size 2."""
    _, _, tp, tcfg = model
    with ModelHost(hbm_watermark_bytes=1 << 40, name='mesh-probe') as probe:
        m = probe.deploy('probe', _mesh_factory(tp, tcfg), mp=2)
        per_device = m.footprint_bytes
        eng = probe._models['probe'].engine
        shard0 = sum(t.untyped_storage().nbytes() for t in (
            eng._pool['k'][0], eng._pool['v'][0]))
        assert per_device > 2 * shard0
    with ModelHost(hbm_watermark_bytes=int(per_device * 1.6),
                   name='mesh-swap') as host:
        host.deploy('a', _mesh_factory(tp, tcfg), mp=2)
        out1 = list(host.submit('a', [1, 2],
                                max_new_tokens=4).result(timeout=120))
        host.deploy('b', _mesh_factory(tp, tcfg), mp=2)
        assert host.models()['a']['state'] == 'evicted'
        out2 = list(host.submit('a', [1, 2],
                                max_new_tokens=4).result(timeout=120))
        rec = host.models()['a']
        assert rec['state'] == 'live' and rec['swap_ins'] >= 1
        eng = host._models['a'].engine
        assert eng._trace_count == 2
        assert mesh_engine.mesh_size(eng) == 2
        assert out1 == out2


def test_fleet_reports_each_replicas_mesh(model):
    from paddle_tpu_torch.serving import FleetRouter
    _, _, tp, tcfg = model
    rs = ReplicaSet(replicas=[engine(tp, tcfg, 2), engine(tp, tcfg, 1)])
    router = FleetRouter(rs, tick_s=0.01)
    try:
        assert sorted(router.stats()['replica_mesh'].values()) == [1, 2]
    finally:
        router.close()
