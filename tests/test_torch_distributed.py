"""paddle.distributed on the port (paddle_tpu_torch.distributed) against the
reference and against the collectives' definitions: the topology and its
degree growth, validate_degrees, the one-process identities, every
collective over 4 gloo ranks (one spawn for the module,
tests/torch_parallel_cases.py), the partitioner's rule resolution against
the reference's PartitionSpecs, the quantized all-reduce against the
reference's on its virtual mesh, and the wire-byte accounting."""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as rfleet
from paddle_tpu.distributed import quant_collectives as rqc
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.parallel import partitioner as rpart

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import quant_collectives as tqc
from paddle_tpu_torch.parallel import partitioner as tpart

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_cases as C  # noqa: E402

N = 4


def _quant_inputs():
    rs = np.random.RandomState(3)
    x = rs.randn(N, 1000).astype(np.float32)
    x4 = rs.randn(N, 512).astype(np.float32)
    det = rs.randn(N, 640).astype(np.float32)
    cases = {
        'none_mean': (x, dict(mode='none', mean=True)),
        'bf16': (x, dict(mode='bf16')),
        'fp8': (x, dict(mode='fp8')),
        'int8_det': (det, dict(mode='int8', stochastic=False)),
        'int4_det': (det, dict(mode='int4', stochastic=False)),
        'int8': (x, dict(mode='int8', seed=7)),
        'int4': (x4, dict(mode='int4', seed=11)),
        'zero': (np.zeros((N, 260), np.float32), dict(mode='int8', seed=1)),
    }
    tree = {'w': rs.randn(N, 4096).astype(np.float32),
            'b': rs.randn(N, 16).astype(np.float32)}
    return {'cases': cases, 'tree': tree}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks: the collectives, then the quantized
    all-reduce; -> {name: [rank 0's, ..., rank 3's]}."""
    out = str(tmp_path_factory.mktemp('dist'))
    with open(os.path.join(out, 'inputs.pkl'), 'wb') as f:
        pickle.dump({'quant': _quant_inputs()}, f)
    tdist.spawn(C.distributed, (out,), nprocs=N, backend='gloo')
    res = {}
    for name in ('collectives', 'quant'):
        res[name] = []
        for r in range(N):
            with open(os.path.join(out, f'{name}.rank{r}.pkl'), 'rb') as f:
                res[name].append(pickle.load(f))
    return res


# ---------------------------------------------------------------------------
# one process: the topology, degrees, identities
# ---------------------------------------------------------------------------

def test_one_process_world_and_identities():
    """Without a process group: rank 0 of 1, every collective the identity
    over the full tensor (the reference's test_collectives_eager_identity)."""
    import paddle_tpu_torch as tpaddle
    tpaddle.set_device('cpu')
    x = tpaddle.to_tensor(np.array([1., 2.], 'float32'))
    tdist.all_reduce(x)
    assert np.allclose(x.numpy(), [1., 2.])
    rx = paddle.to_tensor(np.array([1., 2.], 'float32'))
    import paddle_tpu.distributed as rdist
    rdist.all_reduce(rx)
    np.testing.assert_array_equal(x.numpy(), rx.numpy())
    assert tdist.get_world_size() == rdist.get_world_size() == 1
    assert tdist.get_rank() == 0
    t = torch.arange(3.)
    assert torch.equal(tdist.all_gather(None, t), t[None])
    got = []
    tdist.all_gather(got, t)
    assert len(got) == 1 and torch.equal(got[0], t)
    assert torch.equal(tdist.broadcast(t.clone(), src=0), t)
    assert torch.equal(tdist.reduce_scatter(None, [t]), t)
    assert [r.tolist() for r in tdist.alltoall([t])] == [t.tolist()]
    assert tdist.send(t) is t and tdist.recv(t) is t
    tdist.barrier()
    topo = tdist.HybridTopology()
    assert topo.mesh.size == 1 and topo.mesh.axis_index('dp') == 0
    assert topo.mesh.axis_names == rtopo._AXIS_ORDER
    env = tdist.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks) == (0, 1, 1)


def test_spawn_one_process_runs_in_place():
    seen = []
    assert tdist.spawn(seen.append, ('x',), nprocs=1) is None
    assert seen == ['x']
    with pytest.raises(ValueError, match='nprocs'):
        tdist.spawn(seen.append, ('x',), nprocs=0)
    with pytest.raises(ValueError, match='backend'):
        tdist.spawn(seen.append, ('x',), nprocs=2, backend='mpi')


def test_topology_rejects_too_many_ranks():
    with pytest.raises(ValueError, match='need 2'):
        tdist.HybridTopology(mp=2)
    with pytest.raises(ValueError, match='need 2'):
        rtopo.HybridTopology(mp=2, devices=jax.devices()[:1])


@pytest.mark.parametrize('hc,n', [
    ({'dp_degree': 3, 'mp_degree': 2}, 8),
    ({'dp_degree': 0}, 8),
    ({'dp_degree': 2, 'mp_degree': 2}, 4),
    ({'mp_degree': 2, 'pp_degree': 2, 'sp_degree': 2}, 8),
    ({'dp_degree': None, 'mp_degree': 4}, 8),
])
def test_validate_degrees_as_the_reference(hc, n):
    def run(fleet_mod):
        s = fleet_mod.DistributedStrategy()
        s.hybrid_configs = hc
        try:
            return s.validate_degrees(n)
        except ValueError as e:
            return ('ValueError', str(e))
    assert run(tfleet) == run(rfleet)


# ---------------------------------------------------------------------------
# 4 ranks over gloo
# ---------------------------------------------------------------------------

def _base(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


def test_collectives_over_four_ranks(ranks):
    got = ranks['collectives']
    xs = [_base(r) / 10 + 1 for r in range(N)]
    want = {'sum': sum(xs), 'max': np.max(xs, 0), 'min': np.min(xs, 0),
            'prod': np.prod(xs, 0), 'avg': sum(xs) / N}
    for r, out in enumerate(got):
        assert (out['rank'], out['world']) == (r, N)
        for op, w in want.items():
            np.testing.assert_allclose(out[f'all_reduce_{op}'], w,
                                       rtol=1e-6)
        np.testing.assert_array_equal(out['all_gather'],
                                      np.stack([_base(i) for i in range(N)]))
        np.testing.assert_array_equal(out['broadcast'], _base(2))
        np.testing.assert_array_equal(out['scatter'], _base(1) + 100 * r)
        stacked = sum(np.concatenate([_base(i) + j for j in range(N)])
                      for i in range(N))
        np.testing.assert_array_equal(out['reduce_scatter'],
                                      np.split(stacked, N)[r])
        np.testing.assert_array_equal(
            out['alltoall'], np.stack([np.full(3, 10 * i + r, np.float32)
                                       for i in range(N)]))
        np.testing.assert_array_equal(out['send_recv'], _base((r - 1) % N))
        np.testing.assert_array_equal(
            out['subgroup'], _base(1) + _base(3) if r in (1, 3) else _base(r))


def test_axis_ops_over_a_dp2_mp2_mesh(ranks):
    """psum / pmax / all-gather / reduce-scatter over one axis, ppermute
    and its transpose, Megatron's f/g pair, on the reference's axis order
    (mp innermost: ranks [[0, 1], [2, 3]])."""
    got = ranks['collectives']
    mesh = rtopo.HybridTopology(dp=2, mp=2, devices=jax.devices()[:4]).mesh
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert np.array_equal(np.asarray(got[0]['partitioner']['ranks_dp2mp2']),
                          ids)
    for r, out in enumerate(got):
        dp, mp = r // 2, r % 2
        assert out['coords']['dp'] == dp and out['coords']['mp'] == mp
        mates = [2 * dp, 2 * dp + 1]          # same dp, both mp
        column = [mp, 2 + mp]                 # same mp, both dp
        np.testing.assert_array_equal(out['psum_mp'],
                                      sum(_base(i) for i in mates))
        np.testing.assert_array_equal(out['pmax_dp'],
                                      np.max([_base(i) for i in column], 0))
        np.testing.assert_array_equal(
            out['gather_mp'], np.concatenate([_base(i) for i in mates], 1))
        np.testing.assert_array_equal(
            out['scatter_dp'], np.split(sum(_base(i) for i in column),
                                        2)[dp])
        peer = mates[1 - mp]
        np.testing.assert_array_equal(out['ppermute'], _base(peer))
        # d/dx of sum(ppermute(x) * (r + 1)): the peer's weight comes back
        np.testing.assert_array_equal(out['ppermute_grad'],
                                      np.full((2, 3), peer + 1.0))
        # f: identity forward, the backward sums the mp weights
        np.testing.assert_array_equal(out['f_grad'],
                                      np.full((2, 3), sum(i + 1.0
                                                          for i in mates)))
        # g: the forward sums, the backward is the identity
        np.testing.assert_array_equal(out['g'], sum(_base(i) for i in mates))
        np.testing.assert_array_equal(out['g_grad'], np.full((2, 3), r + 1.))


def test_mesh_bound_partitioner_and_fleet_on_four_ranks(ranks):
    """tests/test_partitioner.py's mesh-bound cases on a 4-rank mesh, and
    fleet.init's degree growth and refusals."""
    pc = ranks['collectives'][0]['partitioner']
    assert pc['unknown_axis'][0] == 'ShardingRuleError'
    assert 'not in mesh axes' in pc['unknown_axis'][1]
    assert pc['non_divisible'][0] == 'ShardingRuleError'
    assert 'does not divide' in pc['non_divisible'][1]
    assert pc['divisible'] == tuple(P('dp'))
    assert pc['data_axes'] == ('dp',)
    assert pc['grown'] == dict(dp=2, mp=2, pp=1, sharding=1, sp=1, ep=1)
    shape, batch, embed_mlp = pc['from_strategy']
    assert (shape['dp'], shape['mp']) == (2, 2)
    assert batch == tuple(P('dp')) and embed_mlp == tuple(P(None, 'mp'))
    assert pc['sharding_joins_batch'] == (tuple(P(('dp', 'sharding'))),
                                          ('dp', 'sharding'))
    assert pc['bad_product'][0] == 'ValueError'
    assert 'divide' in pc['bad_product'][1]
    assert 'divide' in pc['fleet_init_bad'][1]
    assert pc['fleet_init'] == dict(dp=2, mp=2, pp=1, sharding=1, sp=1, ep=1)


# ---------------------------------------------------------------------------
# the partitioner's rule resolution (tests/test_partitioner.py:22-190)
# ---------------------------------------------------------------------------

def _resolve(mod, case):
    try:
        out = case(mod)
    except ValueError as e:
        return (type(e).__name__, str(e))
    if isinstance(out, dict):
        return {k: _resolve_val(v) for k, v in out.items()}
    return _resolve_val(out)


def _resolve_val(v):
    if isinstance(v, dict):
        return {k: _resolve_val(x) for k, x in v.items()}
    return tuple(v) if isinstance(v, tuple) else v


PART_CASES = {
    'first_rule_wins': lambda m: m.Partitioner(
        rules=(('a', 'dp'), ('a', 'mp'))).spec(('a',)),
    'unmapped_replicated': lambda m: m.Partitioner().spec(
        ('positions', 'router')),
    'none_rule_stops': lambda m: m.Partitioner(
        rules=(('kv', None), ('kv', 'mp'))).spec(('kv',)),
    'duplicate_axis_replicated': lambda m: m.Partitioner().spec(
        ('vocab', 'heads')),
    'duplicate_falls_through': lambda m: m.Partitioner(
        rules=(('a', 'mp'), ('b', 'mp'), ('b', 'dp'))).spec(('a', 'b')),
    'none_spec': lambda m: m.Partitioner().spec(None),
    'tree_specs': lambda m: m.Partitioner().tree_specs(
        {'w': ('embed', 'mlp'), 'b': ('mlp',), 'nested': {'g': None}}),
    'rank_mismatch': lambda m: m.Partitioner().spec(('embed', 'mlp'),
                                                    shape=(4,)),
    'data_axes_default': lambda m: m.Partitioner().data_axes(),
    'batch_length_heads': lambda m: m.Partitioner().spec(
        ('batch', 'length', 'heads', 'kv')),
    'explicit_rules_mp1': lambda m: dict(m.model_rules(mp=1, sp=1,
                                                       explicit=True)),
    'explicit_rules_mp4_sp2': lambda m: dict(m.model_rules(
        mp=4, sp=2, explicit=True)),
    'gspmd_rules_pp2': lambda m: dict(m.model_rules(mp=2, pp=2)),
}


@pytest.mark.parametrize('name', sorted(PART_CASES))
def test_partitioner_resolves_as_the_reference(name):
    assert (_resolve(tpart, PART_CASES[name])
            == _resolve(rpart, PART_CASES[name]))


@pytest.mark.parametrize('over', [dict(mp=4), dict(sp=2), dict(pp=2),
                                  dict(mp=2, pp=2), dict(mp=2, sp=2)])
def test_gpt_specs_as_the_reference(over):
    """param_specs (GSPMD) and the explicit-route specs the port's step
    takes, against the reference's at the same config."""
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=32, **over)
    want = _resolve_val(jgpt.param_specs(jgpt.GPTConfig(**kw)))
    assert _resolve_val(tgpt.param_specs(tgpt.GPTConfig(**kw))) == want
    explicit = jgpt._partitioner(jgpt.GPTConfig(**kw), explicit=True)
    assert (_resolve_val(tgpt.train_specs(tgpt.GPTConfig(**kw)))
            == _resolve_val(explicit.tree_specs(jgpt.LOGICAL_AXES)))


# ---------------------------------------------------------------------------
# the quantized all-reduce against the reference's on its virtual mesh
# ---------------------------------------------------------------------------

def _ref_psum(x, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:N]), ('dp',))
    kw = dict(kw)
    if 'seed' in kw:
        kw['seed'] = jnp.uint32(kw['seed'])
    f = shard_map(lambda v: rqc.quantized_psum(v[0], 'dp', **kw)[None],
                  mesh=mesh, in_specs=P('dp', None), out_specs=P('dp', None),
                  check_rep=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize('name', ['none_mean', 'bf16', 'fp8', 'int8_det',
                                  'int4_det'])
def test_quantized_psum_matches_the_reference(ranks, name):
    x, kw = _quant_inputs()['cases'][name]
    want = _ref_psum(x, **kw)
    for r in range(N):
        np.testing.assert_allclose(ranks['quant'][r][name], want[r],
                                   rtol=1e-6, atol=1e-6)


def _block_bound(x, mode, block=tqc.DEFAULT_BLOCK):
    """tests/test_quant_collectives.py's bound: each of n ranks rounds by
    less than one step of the shared grid."""
    n, size = x.shape
    nb = -(-size // block)
    xb = np.concatenate([x, np.zeros((n, nb * block - size), np.float32)],
                        1).reshape(n, nb, block)
    amax = np.abs(xb).max(axis=(0, 2))
    scale = np.where(amax > 0, amax / tqc._QMAX[mode], 1.0)
    return np.repeat(n * scale, block)[:size]


def test_stochastic_rounding_error_bounds(ranks):
    cases = _quant_inputs()['cases']
    q = ranks['quant']
    for name, mode in (('int8', 'int8'), ('int4', 'int4')):
        x = cases[name][0]
        got = q[0][name]
        for r in range(1, N):                         # ranks agree
            np.testing.assert_array_equal(q[r][name], got)
        assert np.all(np.abs(got - x.sum(0))
                      <= _block_bound(x, mode) * 1.01)
    x = cases['int8'][0]
    assert np.abs(q[0]['int8'] - x.sum(0)).max() < 0.15 * np.abs(
        x.sum(0)).max()
    det = cases['int8_det'][0]
    assert np.all(np.abs(q[0]['int8_det'] - det.sum(0))
                  <= _block_bound(det, 'int8') * 0.5 * 1.01)
    np.testing.assert_array_equal(q[0]['zero'], np.zeros(260))
    tree = _quant_inputs()['tree']
    np.testing.assert_allclose(q[0]['tree']['b'], tree['b'].mean(0),
                               rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(q[0]['tree']['w'] - tree['w'].mean(0))
                  <= _block_bound(tree['w'], 'int8') / N * 1.01)


def test_quant_mode_validation():
    with pytest.raises(ValueError, match='mode'):
        tqc._check_mode('int2')
    with pytest.raises(ValueError, match='seed'):
        tqc.quantized_psum(torch.ones(4), None, mode='int8', seed=None)


def _grad_like_tree(lib):
    shapes = {'wte': (4096, 256), 'qkv_w': (4, 256, 768), 'bias': (256,)}
    if lib == 'torch':
        return {k: torch.zeros(s) for k, s in shapes.items()}
    return {k: np.zeros(s, np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize('n_ranks', [1, 2, 8])
def test_bytes_accounting_equals_the_reference(n_ranks):
    assert (tqc.bytes_report(_grad_like_tree('torch'), n_ranks)
            == rqc.bytes_report(_grad_like_tree('np'), n_ranks))
    for mode in ('f32', 'bf16', 'int8', 'int4', 'fp8'):
        assert (tqc.collective_bytes(_grad_like_tree('torch'), n_ranks, mode)
                == rqc.collective_bytes(_grad_like_tree('np'), n_ranks,
                                        mode))
    assert tqc.leaf_bytes(256, 4, 'int8', 8) == rqc.leaf_bytes(256, 4,
                                                               'int8', 8)
    assert tqc._ring_factor(n_ranks) == rqc._ring_factor(n_ranks)


# ---------------------------------------------------------------------------
# Q3.19: the collectives' fault point; Q3.21: spawn without a backend
# ---------------------------------------------------------------------------

def test_collectives_fire_the_collective_entry_fault_point(monkeypatch):
    """With ``PADDLE_FAULT_INJECT=collective.entry:1``, the six collectives
    at which the reference fires it (``paddle_tpu/distributed/
    collective.py:54-180``) raise ``InjectedFault`` in both packages."""
    import paddle_tpu.distributed as rdist
    import paddle_tpu_torch as tpaddle
    from paddle_tpu import fault as rfault
    from paddle_tpu_torch import fault as tfault
    tpaddle.set_device('cpu')
    t = torch.arange(4.)
    calls = {
        'all_reduce': (lambda d, x: d.all_reduce(x)),
        'all_gather': (lambda d, x: d.all_gather([], x)),
        'broadcast': (lambda d, x: d.broadcast(x, src=0)),
        'reduce_scatter': (lambda d, x: d.reduce_scatter(x, [x])),
        'alltoall': (lambda d, x: d.alltoall([x])),
        'barrier': (lambda d, x: d.barrier()),
    }
    for pkg, dist, x in ((tfault, tdist, t),
                         (rfault, rdist, paddle.to_tensor(t.numpy()))):
        monkeypatch.setenv('PADDLE_FAULT_INJECT', 'collective.entry:1')
        pkg.reload()
        try:
            for name, call in calls.items():
                with pytest.raises(pkg.InjectedFault):
                    call(dist, x)
        finally:
            monkeypatch.delenv('PADDLE_FAULT_INJECT')
            pkg.reload()
        # disarmed, they return
        calls['all_reduce'](dist, x)
        calls['barrier'](dist, x)


def test_spawn_picks_a_backend_and_passes_master_port(tmp_path):
    """Without ``backend=`` two workers meet (gloo here: the ranks would
    share a card, or there is none), as the reference's own test calls
    ``spawn`` (tests/test_launch_elastic.py:190); ``master_port=`` reaches
    them as ``MASTER_PORT``."""
    assert tdist.default_backend(2) == (
        'nccl' if torch.cuda.is_available()
        and torch.cuda.device_count() >= 2 else 'gloo')
    tdist.spawn(C.write_rank, (str(tmp_path),), nprocs=2, master_port=29512)
    got = sorted((tmp_path / f'rank{r}.txt').read_text().split()
                 for r in range(2))
    assert got == [['0', '2', 'gloo', '29512'], ['1', '2', 'gloo', '29512']]
