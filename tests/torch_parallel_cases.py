"""Workers of the port's multi-process CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_gpt_parallel.py``).

Each function runs in every rank that ``paddle_tpu_torch.distributed.spawn``
starts (gloo on the CPU). They import numpy, torch and the port only, never
JAX: the parent test holds what they write against the reference. Inputs
come from ``inputs.pkl`` in the shared directory; each rank writes
``<name>.rank<r>.pkl`` there.
"""
import os
import pickle

import numpy as np
import torch

# the tiny GPT every layout trains (the reference tests' widths)
GPT = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
           max_seq_len=32, dtype='float32', use_flash=True, remat=True)
BATCH = (8, 16)
STEPS = 2
LR = 1e-3
# AdamW at epsilon 1e-6: at the default 1e-8, a gradient that is zero but
# for f32 rounding (a dead GELU unit's out_w row) moves its weight by up
# to lr / 2 on either package, whatever the layout
OPT = dict(learning_rate=LR, weight_decay=0.01, epsilon=1e-6)

# (name, HybridTopology degrees, GPTConfig overrides) over 4 ranks
LAYOUTS = [
    ('dp2_mp2', dict(dp=2, mp=2), dict(mp=2)),
    ('dp2_sp2', dict(sp=2), dict(sp=2)),
    ('dp2_pp2_gpipe', dict(pp=2), dict(pp=2, n_microbatches=2)),
    ('mp2_pp2_1f1b', dict(mp=2, pp=2),
     dict(mp=2, pp=2, n_microbatches=2, pp_schedule='1f1b')),
    ('dp2_sp2_gqa', dict(sp=2), dict(sp=2, num_kv_heads=2)),
    ('dp4_gq_bf16', dict(dp=4), dict(grad_quant='bf16')),
    ('dp4_gq_int8', dict(dp=4), dict(grad_quant='int8')),
]

# ZeRO: the quadratic loss of tests/test_distributed.py:300-348
ZERO_STEPS = 5
ZERO_LR = 1e-2

# ring flash with dropout: tests/test_ring_flash.py's smallest shape
RING = dict(sp=2, b=1, s=256, h=2, d=64, drop=0.25, seed=7)


def _start():
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    return dist


def _inputs(outdir):
    with open(os.path.join(outdir, 'inputs.pkl'), 'rb') as f:
        return pickle.load(f)


def _save(outdir, name, rank, obj):
    with open(os.path.join(outdir, f'{name}.rank{rank}.pkl'), 'wb') as f:
        pickle.dump(obj, f)


def _np(x):
    return x.detach().cpu().numpy().copy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def collectives(outdir):
    """Every collective of the API and the axis-level ops over 4 ranks;
    each rank writes what it got."""
    dist = _start()
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.parallel import tp_ad
    r, n = dist.get_rank(), dist.get_world_size()
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out = {'rank': r, 'world': n}
    for op in ('sum', 'max', 'min', 'prod', 'avg'):
        x = base.clone() / 10 + 1
        dist.all_reduce(x, op=op)
        out[f'all_reduce_{op}'] = _np(x)
    got = []
    dist.all_gather(got, base)
    out['all_gather'] = np.stack([_np(g) for g in got])
    x = base.clone()
    dist.broadcast(x, src=2)
    out['broadcast'] = _np(x)
    x = base.clone()
    dist.scatter(x, [base + 100 * i for i in range(n)] if r == 1 else None,
                 src=1)
    out['scatter'] = _np(x)
    x = torch.zeros(2, 3)
    dist.reduce_scatter(x, [base + i for i in range(n)])
    out['reduce_scatter'] = _np(x)
    res = dist.alltoall([base[0] * 0 + 10 * r + j for j in range(n)])
    out['alltoall'] = np.stack([_np(t) for t in res])
    # a ring of send/recv: even ranks send first, odd ranks receive first
    x = torch.zeros(2, 3)
    nxt, prv = (r + 1) % n, (r - 1) % n
    if r % 2 == 0:
        dist.send(base, dst=nxt)
        dist.recv(x, src=prv)
    else:
        dist.recv(x, src=prv)
        dist.send(base, dst=nxt)
    out['send_recv'] = _np(x)
    sub = dist.new_group([1, 3])
    x = base.clone()
    if sub is not None:
        dist.all_reduce(x, group=sub)
    out['subgroup'] = _np(x)
    dist.barrier()
    # the axis-level ops on a dp2 x mp2 mesh
    mesh = HybridTopology(dp=2, mp=2).mesh
    mp, dp = mesh.group('mp'), mesh.group('dp')
    out['coords'] = dict(mesh.coords)
    out['psum_mp'] = _np(coll.psum(base, mp))
    out['pmax_dp'] = _np(coll.pmax(base, dp))
    out['gather_mp'] = _np(coll.all_gather_axis(base, mp, dim=1))
    out['scatter_dp'] = _np(coll.reduce_scatter_axis(base, dp, dim=0))
    x = base.clone().requires_grad_()
    y = coll.ppermute(x, mp, shift=1)
    (gx,) = torch.autograd.grad((y * (r + 1)).sum(), x)
    out['ppermute'], out['ppermute_grad'] = _np(y), _np(gx)
    x = base.clone().requires_grad_()
    (gx,) = torch.autograd.grad((tp_ad.f_identity(x, mp) * (r + 1)).sum(), x)
    out['f_grad'] = _np(gx)
    x = base.clone().requires_grad_()
    y = tp_ad.g_allreduce(x, mp)
    (gx,) = torch.autograd.grad((y * (r + 1)).sum(), x)
    out['g'], out['g_grad'] = _np(y), _np(gx)
    out['partitioner'] = _partitioner_cases()
    _save(outdir, 'collectives', r, out)


def write_rank(outdir):
    """``spawn``'s worker without a backend of the caller's: this rank,
    the world's size and backend, and ``MASTER_PORT``."""
    dist = _start()
    import torch.distributed as tdist
    r = dist.get_rank()
    with open(os.path.join(outdir, f'rank{r}.txt'), 'w') as f:
        f.write(f'{r} {dist.get_world_size()} {tdist.get_backend()} '
                f"{os.environ.get('MASTER_PORT')}")


def _partitioner_cases():
    """The mesh-bound cases of tests/test_partitioner.py on 4 ranks:
    (result or the error's type and message) each."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.parallel import Partitioner

    def run(fn):
        try:
            return fn()
        except ValueError as e:
            return (type(e).__name__, str(e))
    dp4 = HybridTopology(dp=4).mesh
    dp2mp2 = HybridTopology(dp=2, mp=2).mesh

    def strategy(**hc):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = hc
        return s
    return {
        'unknown_axis': run(lambda: Partitioner(
            rules=(('batch', 'nosuch'),), mesh=dp4)),
        'non_divisible': run(lambda: Partitioner(mesh=dp4).spec(
            ('batch',), shape=(6,))),
        'divisible': run(lambda: tuple(Partitioner(mesh=dp4).spec(
            ('batch',), shape=(16,)))),
        'data_axes': Partitioner(mesh=dp2mp2).data_axes(),
        'grown': HybridTopology(mp=2).degrees,
        'ranks_dp2mp2': dp2mp2.ranks.tolist(),
        'from_strategy': run(lambda: (
            lambda pt: (pt.mesh.shape, tuple(pt.spec(('batch',))),
                        tuple(pt.spec(('embed', 'mlp')))))(
                strategy(dp_degree=2, mp_degree=2).to_partition_rules())),
        'sharding_joins_batch': run(lambda: (
            lambda pt: (tuple(pt.spec(('batch',))), pt.data_axes()))(
                strategy(dp_degree=2, sharding_degree=2)
                .to_partition_rules())),
        'bad_product': run(lambda: strategy(
            dp_degree=3, mp_degree=2).to_partition_rules()),
        'fleet_init_bad': run(lambda: fleet.init(
            is_collective=True, strategy=strategy(dp_degree=3,
                                                  mp_degree=2))),
        'fleet_init': run(lambda: fleet.init(
            is_collective=True, strategy=strategy(mp_degree=2)).degrees),
    }


def distributed(outdir):
    """tests/test_torch_distributed.py's one spawn."""
    collectives(outdir)
    quant(outdir)


def quant(outdir):
    """quantized_psum and psum_tree over the 4 ranks of a dp4 mesh, each
    rank feeding its row of the parent's inputs."""
    dist = _start()
    from paddle_tpu_torch.distributed import quant_collectives as qc
    from paddle_tpu_torch.distributed.topology import HybridTopology
    r = dist.get_rank()
    dp = HybridTopology(dp=4).mesh.group('dp')
    inp = _inputs(outdir)['quant']
    out = {}
    for name, (x, kw) in inp['cases'].items():
        out[name] = _np(qc.quantized_psum(torch.from_numpy(x[r]), dp, **kw))
    tree = {k: torch.from_numpy(v[r]) for k, v in inp['tree'].items()}
    got = qc.psum_tree(tree, dp, mode='int8', seed=9, mean=True)
    out['tree'] = _tree_np(got)
    _save(outdir, 'quant', r, out)


# ---------------------------------------------------------------------------
# tests/test_torch_gpt_parallel.py
# ---------------------------------------------------------------------------

def gpt_layouts(outdir):
    """Each layout of LAYOUTS: 2 AdamW steps of the mesh train step from
    the parent's parameters and batch; the losses and the gathered
    parameters. Then ZeRO 1-3 and ring flash attention with dropout."""
    dist = _start()
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.models import gpt
    r = dist.get_rank()
    inp = _inputs(outdir)
    toks = torch.from_numpy(inp['tokens'])
    tgts = torch.from_numpy(inp['targets'])
    out = {}
    for name, deg, over in LAYOUTS:
        topo = HybridTopology(**deg)
        cfg = gpt.GPTConfig(**dict(GPT, **over))
        full = gpt.params_from_numpy(inp['params'][over.get(
            'num_kv_heads', 0)], cfg, 'cpu')
        params = gpt.place_params(full, cfg, topo.mesh)
        opt = topt.AdamW(**OPT)
        state = opt.functional_init(params)
        step = gpt.make_train_step(cfg, opt, topo.mesh)
        losses = []
        for i in range(STEPS):
            loss, params, state = step(params, state, 1000 + i, LR, toks,
                                       tgts)
            losses.append(loss.item())
        out[name] = {'losses': losses, 'params': _tree_np(
            gpt.gather_params(params, cfg, topo.mesh))}
    out['zero'] = _zero(inp['zero'])
    out['ring'] = _ring(inp['ring'])
    _save(outdir, 'gpt', r, out)


def _zero(inp):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.parallel import zero
    mesh = HybridTopology(dp=4).mesh

    def quad(p, x, y):
        return torch.mean((x @ p['w'] + p['b'] - y) ** 2)

    out = {}
    for stage in (1, 2, 3):
        opt = topt.Adam(learning_rate=ZERO_LR)
        step, init_state = zero.make_zero_train_step(quad, opt, mesh,
                                                     stage=stage)
        p, s = init_state({k: torch.from_numpy(v.copy())
                           for k, v in inp['params'].items()})
        xb = step.place_batch(torch.from_numpy(inp['x']))
        yb = step.place_batch(torch.from_numpy(inp['y']))
        losses = []
        for _ in range(ZERO_STEPS):
            loss, p, s = step(p, s, ZERO_LR, xb, yb)
            losses.append(loss.item())
        specs = step.specs['tree']
        out[stage] = {
            'losses': losses,
            'w': _np(zero.replicate(p, specs, mesh)['w'] if stage >= 3
                     else p['w']),
            'w_block': tuple(p['w'].shape),
            'm1_block': tuple(s['w']['moment1'].shape),
            'specs': {k: tuple(v) for k, v in specs.items()}}
    return out


def _ring(inp):
    """ring_flash_attention with dropout over sp=2 (dp grows to 2): the
    gathered output and gradients of sum(out * dO)."""
    from paddle_tpu_torch.distributed.collective import all_gather_axis
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.parallel import ring_flash_attention
    from paddle_tpu_torch.parallel.partitioner import PartitionSpec, shard
    mesh = HybridTopology(sp=RING['sp']).mesh
    spec = PartitionSpec(None, 'sp', None, None)
    out = {}
    for name, case in inp.items():
        loc = [shard(torch.from_numpy(case[k]), spec, mesh).requires_grad_()
               for k in ('q', 'k', 'v')]
        g = shard(torch.from_numpy(case['g']), spec, mesh)
        o = ring_flash_attention(*loc, 'sp', causal=True,
                                 drop_rate=RING['drop'], seed=RING['seed'],
                                 mesh=mesh)
        grads = torch.autograd.grad((o * g).sum(), loc)
        grp = mesh.group('sp')
        out[name] = {k: _np(all_gather_axis(t.detach(), grp, dim=1))
                     for k, t in zip(('out', 'dq', 'dk', 'dv'),
                                     (o, *grads))}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_parallel.py: the MoE GPT's mesh step, fp8 over a
# dp/mp mesh, hybrid_zero3_specs
# ---------------------------------------------------------------------------

# the tiny MoE every layout trains (the reference tests' widths)
MOE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           n_experts=4, max_seq_len=32, dtype='float32', use_flash=True,
           remat=True)
# the fp8 GPT: C.GPT at 2 layers
GPT_FP8 = dict(GPT, num_layers=2, matmul_precision='fp8')

# rounds over 4 ranks: (degrees, ranks, case) laid out on ranks [0, 1] and
# [2, 3] side by side, or (degrees, None, case) over all four. A case:
# (name, model, config overrides, batch key); 'skew' puts one token id in
# every row of the first dp block, so its first choices fill one expert
# past the global capacity and the second block's are dropped there
MOE_ROUNDS = [
    [(dict(dp=2), [0, 1], ('dp2', 'moe', {}, 'batch')),
     (dict(ep=2), [2, 3], ('ep2', 'moe', {}, 'batch'))],
    [(dict(mp=2), [0, 1], ('mp2', 'moe', dict(mp=2), 'batch')),
     (dict(dp=2), [2, 3], ('dp2_skew', 'moe', {}, 'skew'))],
    [(dict(dp=2, ep=2), None, ('dp2_ep2', 'moe', {}, 'batch'))],
    [(dict(dp=2, ep=2), None, ('dp2_ep2_skew', 'moe', {}, 'skew'))],
    [(dict(dp=2), [0, 1], ('gpt_fp8_dp2', 'gpt', {}, 'batch')),
     (dict(mp=2), [2, 3], ('gpt_fp8_mp2', 'gpt', dict(mp=2), 'batch'))],
    [(dict(dp=2), [0, 1], ('moe_fp8_dp2', 'moe',
                           dict(matmul_precision='fp8'), 'batch')),
     (dict(mp=2), [2, 3], ('moe_fp8_mp2', 'moe',
                           dict(mp=2, matmul_precision='fp8'), 'batch'))],
]


def _paths(tree, prefix=''):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f'{prefix}/{k}')]
    return [(prefix, tree)]


def _moe_case(inp, mesh, case):
    """One case on this rank's mesh: C.STEPS AdamW steps of the mesh step;
    the losses, the gathered parameters and (fp8) the state."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt, moe_gpt
    name, model, over, bkey = case
    mod = moe_gpt if model == 'moe' else gpt
    base = MOE if model == 'moe' else GPT_FP8
    cfg = (moe_gpt.MoEConfig if model == 'moe' else gpt.GPTConfig)(
        **dict(base, **over))
    full = gpt.params_from_numpy(inp['params'][model], cfg, 'cpu')
    params = mod.place_params(full, cfg, mesh)
    opt = topt.AdamW(**OPT)
    state = opt.functional_init(params)
    step = mod.make_train_step(cfg, opt, mesh)
    toks, tgts = (torch.from_numpy(a) for a in inp[bkey])
    f8 = (mod.init_fp8_state(cfg, 'cpu')
          if cfg.matmul_precision == 'fp8' else None)
    losses, states = [], []
    for i in range(STEPS):
        if f8 is None:
            loss, params, state = step(params, state, 0, LR, toks, tgts)
        else:
            loss, params, state, f8 = step(params, state, f8, 0, LR, toks,
                                           tgts)
            states.append(_tree_np(f8))
        losses.append(loss.item())
    return {'losses': losses, 'states': states,
            'params': _tree_np(mod.gather_params(params, cfg, mesh))}


def moe_layouts(outdir):
    """Every round of MOE_ROUNDS, then ZeRO-3 inside a dp2 x mp2 layout
    (``hybrid_zero3_specs``: each rank's blocks, and ``replicate`` back);
    each rank writes its cases' results."""
    dist = _start()
    from paddle_tpu_torch.distributed.topology import HybridTopology
    from paddle_tpu_torch.models import gpt, moe_gpt
    from paddle_tpu_torch.parallel import partitioner, zero
    r = dist.get_rank()
    inp = _inputs(outdir)
    out = {}
    for rnd in MOE_ROUNDS:
        # every rank builds every mesh of the round and the groups over
        # two axes the steps take, in one order (new_group is collective
        # over the world)
        meshes = [(HybridTopology(**deg, ranks=ranks).mesh, ranks, case)
                  for deg, ranks, case in rnd]
        for mesh, _, _ in meshes:
            mesh.group(('ep', 'mp'))
            mesh.group(('dp', 'mp'))
        for mesh, ranks, case in meshes:
            if ranks is None or r in ranks:
                out[case[0]] = _moe_case(inp, mesh, case)
    mesh = HybridTopology(dp=2, mp=2).mesh
    hybrid = {}
    for model, mod in (('gpt', gpt), ('moe', moe_gpt)):
        cfg = (gpt.GPTConfig(**dict(GPT_FP8, mp=2)) if model == 'gpt'
               else moe_gpt.MoEConfig(**dict(MOE, mp=2)))
        full = gpt.params_from_numpy(inp['params'][model], cfg, 'cpu')
        specs = zero.hybrid_zero3_specs(full, mod.train_specs(cfg), mesh)
        mine = partitioner.shard_tree(full, specs, mesh)
        back = zero.replicate(mine, specs, mesh)
        hybrid[model] = {'shapes': {k: tuple(v.shape)
                                    for k, v in _paths(mine)},
                         'back': _tree_np(back)}
    out['hybrid'] = hybrid
    _save(outdir, 'moe', r, out)
