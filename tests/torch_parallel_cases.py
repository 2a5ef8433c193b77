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


# ---------------------------------------------------------------------------
# tests/test_torch_fleet_parallel.py: fleet's data- and tensor-parallel
# Layer path over 2 ranks
# ---------------------------------------------------------------------------

# the ERNIE-width MLM program (tests/torch_nn_cases.py) cut to a CPU test
FLEET = dict(vocab=128, hidden=64, layers=2, heads=4, ffn=128,
             max_seq_len=32, dropout=0.0)
FLEET_BATCH = (4, 32)
FLEET_STEPS = 2
FLEET_OPT = dict(learning_rate=1e-3, weight_decay=0.01, epsilon=1e-6)
FLEET_CLIP = 1.0
# the eager data-parallel forms: (name, how the program is wrapped)
DP_FORMS = ('dataparallel', 'model', 'optimizer', 'both', 'buckets',
            'zero2')
BUCKET_MB = 0.05         # 'buckets': DataParallel(comm_buffer_size=)
# hapi fit with a strategy: the global batch in (dp2, mp2), or a loader
# over a DistributedBatchSampler giving each rank its block (dp2_sampler)
HAPI_LAYOUTS = ('dp2', 'mp2', 'dp2_sampler')
MLP_LR = 1e-2
MLP_CLIP = 0.05          # small enough that the clip acts
LSGD_LR = 0.2


def _fleet(paddle, strategy_kw=None, **degrees):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {f'{k}_degree': v for k, v in degrees.items()}
    for k, v in (strategy_kw or {}).items():
        setattr(st, k, v)
    return fleet, st, fleet.init(is_collective=True, strategy=st)


def _mlm_net(paddle, inp, mp):
    import torch_nn_cases as N
    paddle.seed(0)
    if mp:
        net = N.ernie_mlm_mp(paddle, **FLEET)
        net.set_state_dict(N.mlm_mp_state(inp['mlm_state'], FLEET['heads']))
    else:
        net = N.ernie_mlm(paddle, **FLEET)
        net.set_state_dict(inp['mlm_state'])
    return net


def _adamw(paddle, params):
    return paddle.optimizer.AdamW(
        parameters=params, grad_clip=paddle.nn.ClipGradByGlobalNorm(
            FLEET_CLIP), **FLEET_OPT)


def _state_np(net):
    return {k: _np(v._value) for k, v in net.state_dict().items()}


def _block(arrays, rank, n=2):
    b = arrays[0].shape[0] // n
    return [a[rank * b:(rank + 1) * b] for a in arrays]


def _mlm_loss(paddle, logits, labels):
    F = paddle.nn.functional
    return F.cross_entropy(logits.astype('float32').reshape(
        [-1, FLEET['vocab']]), labels.reshape([-1]), ignore_index=-100)


def _dp_form(paddle, inp, rank, form):
    """One eager data-parallel program form over dp2: the rank's block of
    the batch, ``FLEET_STEPS`` AdamW steps; each step's local loss and
    collective calls."""
    from paddle_tpu_torch.distributed import DataParallel
    kw = ({'sharding': True, 'sharding_configs': {'stage': 2}}
          if form == 'zero2' else None)
    fleet, st, topo = _fleet(paddle, kw, dp=2)
    net = _mlm_net(paddle, inp, mp=False)
    if form == 'dataparallel':
        model = paddle.DataParallel(net)
    elif form == 'buckets':
        model = DataParallel(net, comm_buffer_size=BUCKET_MB)
    elif form in ('model', 'both', 'zero2'):
        model = fleet.distributed_model(net)
    else:
        model = net
    opt = _adamw(paddle, net.parameters())
    if form in ('optimizer', 'both', 'zero2'):
        opt = fleet.distributed_optimizer(opt, st)
    toks, types, mask, labels = [paddle.to_tensor(a) for a in
                                 _block(inp['batch'], rank)]
    losses, calls = [], []
    for _ in range(FLEET_STEPS):
        topo.mesh.reset_staged()
        loss = _mlm_loss(paddle, model(toks, types, mask), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        calls.append(topo.mesh.staged()['collectives'])
        losses.append(float(loss))
    grads = [p._value for p in net.parameters()]
    return {'losses': losses, 'calls': calls, 'state': _state_np(net),
            'n_param_bytes': [g.numel() * 4 for g in grads]}


def _mp_eager(paddle, inp, outdir, rank):
    """mp2: the ernie_mlm_mp program, its weights sliced from the full
    state, distributed_model + distributed_optimizer, the whole batch on
    both ranks."""
    fleet, st, topo = _fleet(paddle, mp=2)
    net = fleet.distributed_model(_mlm_net(paddle, inp, mp=True))
    opt = fleet.distributed_optimizer(_adamw(paddle, net.parameters()), st)
    toks, types, mask, labels = [paddle.to_tensor(a) for a in inp['batch']]
    losses, calls = [], []
    for _ in range(FLEET_STEPS):
        topo.mesh.reset_staged()
        loss = net.loss(toks, types, mask, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        calls.append(topo.mesh.staged()['collectives'])
        losses.append(float(loss))
    state = _state_np(net)
    # the whole state, gathered on every rank, written once by rank 0
    full = net.state_dict()
    if rank == 0:
        paddle.save(full, os.path.join(outdir, 'mp2.pdparams'))
    local = {n: tuple(p._value.shape) for n, p in net.named_parameters()}
    return {'losses': losses, 'calls': calls, 'state': state,
            'local_shapes': local}


def _sharded_step(paddle, inp, rank, layout):
    import torch_nn_cases as N
    from paddle_tpu_torch.parallel import make_sharded_train_step
    mp = layout == 'mp2'
    fleet, st, topo = _fleet(paddle, **({'mp': 2} if mp else {'dp': 2}))
    net = _mlm_net(paddle, inp, mp)
    opt = _adamw(paddle, net.parameters())
    step, init = make_sharded_train_step(
        net, N.mlm_loss(paddle, FLEET['vocab']), opt, mesh=topo.mesh,
        batch_axes=('dp',))
    params, bufs, state = init()
    toks, types, mask, labels = inp['batch']
    losses = []
    for _ in range(FLEET_STEPS):
        loss, params, bufs, state = step(params, bufs, state, None,
                                         FLEET_OPT['learning_rate'],
                                         (toks, types, mask), (labels,))
        losses.append(float(loss))
    return {'losses': losses, 'state': _state_np(net)}


def _hapi_fit(paddle, inp, rank, layout):
    import torch_nn_cases as N
    mp = layout == 'mp2'
    fleet, st, topo = _fleet(paddle, **({'mp': 2} if mp else {'dp': 2}))
    net = _mlm_net(paddle, inp, mp)
    model = paddle.Model(net)
    model.prepare(_adamw(paddle, net.parameters()),
                  N.mlm_loss(paddle, FLEET['vocab']), strategy=st)
    rows = N.mlm_rows(paddle, [np.concatenate([a] * FLEET_STEPS)
                               for a in inp['batch']])
    if layout == 'dp2_sampler':
        # upstream Paddle's pattern: the sampler splits the dataset over
        # the data ranks (rank r reads rows r, r + 2, ...), so each step's
        # two blocks are the global batch's rows
        loader = paddle.io.DataLoader(
            rows, batch_sampler=paddle.io.DistributedBatchSampler(
                rows, batch_size=FLEET_BATCH[0] // 2))
    else:
        loader = paddle.io.DataLoader(rows, batch_size=FLEET_BATCH[0],
                                      shuffle=False)
    losses = []

    class Losses(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs['loss']))
    model.fit(loader, epochs=1, log_freq=1, verbose=0, callbacks=[Losses()])
    ev = model.evaluate(loader, verbose=0)
    return {'losses': losses, 'state': _state_np(net), 'eval': ev}


def _mlp_loss(params, x, y):
    h = torch.relu(x @ params['w1'] + params['b1'])
    return torch.mean(torch.square(h @ params['w2'] - y))


def _zero_stage(paddle, inp, rank, stage):
    """ZeRO stage 1-3 through fleet.distributed_optimizer's
    functional_apply on the MLP: each rank's block of the batch; stage 3
    passes the parameters as blocks."""
    from paddle_tpu_torch.parallel import zero
    fleet, st, topo = _fleet(
        paddle, {'sharding': True, 'sharding_configs': {'stage': stage}},
        dp=2)
    mesh = topo.mesh
    params = {k: torch.tensor(v) for k, v in inp['mlp'].items()}
    opt = paddle.optimizer.AdamW(
        learning_rate=MLP_LR, weight_decay=0.01, epsilon=1e-6,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(MLP_CLIP))
    dopt = fleet.distributed_optimizer(opt, st)
    state = dopt.functional_init(params)
    specs = zero.zero_specs(params, mesh, ('dp',))
    cur = zero.place(params, mesh, ('dp',)) if stage >= 3 else params
    x, y = (torch.tensor(a) for a in _block(inp['mlp_xy'], rank))
    for _ in range(FLEET_STEPS):
        full = zero.replicate(cur, specs, mesh) if stage >= 3 else cur
        live = {k: v.detach().requires_grad_() for k, v in full.items()}
        loss = _mlp_loss(live, x, y)
        grads = dict(zip(live, torch.autograd.grad(loss, list(
            live.values()))))
        cur, state = dopt.functional_apply(cur, grads, state, MLP_LR)
    out = zero.replicate(cur, specs, mesh) if stage >= 3 else cur
    return {k: _np(v) for k, v in out.items()}


def _lars(paddle, inp, rank):
    fleet, st, topo = _fleet(paddle, {'lars': True}, dp=2)
    opt = fleet.distributed_optimizer(
        paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9), st)
    params = {k: torch.tensor(v) for k, v in inp['mlp'].items()}
    state = opt.functional_init(params)
    x, y = (torch.tensor(a) for a in _block(inp['mlp_xy'], rank))
    for _ in range(FLEET_STEPS):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(
            _mlp_loss(live, x, y), list(live.values()))))
        params, state = opt.functional_apply(params, grads, state, 0.1)
    return {'inner': type(opt._inner).__name__,
            'params': {k: _np(v) for k, v in params.items()}}


def _quad(params, x):
    return torch.mean(torch.square(x @ params['w'] - 1.0))


def _localsgd(paddle, inp, rank):
    from paddle_tpu_torch.parallel.localsgd import (
        collapse_replicas, make_localsgd_train_step, replicate_for_localsgd)
    fleet, st, topo = _fleet(paddle, dp=2)
    out = {}
    for k, steps in ((1, 1), (4, 4)):
        opt = paddle.optimizer.SGD(learning_rate=LSGD_LR)
        params = {'w': torch.tensor(inp['lsgd_w'])}
        step = make_localsgd_train_step(_quad, opt, topo.mesh, k_steps=k)
        p = replicate_for_localsgd(params)
        s = replicate_for_localsgd(opt.functional_init(params))
        ws, losses = [], []
        for i in range(steps):
            loss, p, s = step(p, s, torch.tensor(inp['lsgd_x']), i, LSGD_LR)
            ws.append(_np(p['w']))
            losses.append(float(loss))
        out[k] = {'w': ws, 'losses': losses,
                  'collapsed': _np(collapse_replicas(p)['w'])}
    return out


def _syncbn(paddle, inp, rank):
    fleet, st, topo = _fleet(paddle, dp=2)
    paddle.seed(0)
    bn = paddle.nn.SyncBatchNorm(inp['bn_x'].shape[1])
    bn.set_state_dict({'weight': inp['bn_w'], 'bias': inp['bn_b']})
    x = paddle.to_tensor(_block([inp['bn_x']], rank)[0], stop_gradient=False)
    cot = paddle.to_tensor(_block([inp['bn_cot']], rank)[0])
    out = bn(x)
    (out * cot).sum().backward()
    return {'out': _np(out._value), 'x_grad': _np(x.grad._value),
            'w_grad': _np(bn.weight.grad._value),
            'b_grad': _np(bn.bias.grad._value),
            'mean': _np(bn._mean._value), 'var': _np(bn._variance._value)}


def _mp_layers(paddle, inp, rank):
    """The three meta_parallel layers at mp2 from full weights: outputs,
    the input's gradient and the gathered parameter gradients of
    sum(out * cot)."""
    fleet, st, topo = _fleet(paddle, mp=2)
    out = {}
    L = inp['layers']
    for name, make, x, cot in (
            ('col_gather', lambda: fleet.ColumnParallelLinear(
                16, 8, gather_output=True), L['x16'], L['cot8']),
            ('col_split', lambda: fleet.ColumnParallelLinear(
                16, 8, gather_output=False), L['x16'],
             _block([L['cot8'].transpose(2, 0, 1)], rank)[0]
             .transpose(1, 2, 0)),
            ('row_full', lambda: fleet.RowParallelLinear(
                8, 16, input_is_parallel=False), L['x8'], L['cot16']),
            ('row_parallel', lambda: fleet.RowParallelLinear(
                8, 16, input_is_parallel=True),
             _block([L['x8'].transpose(2, 0, 1)], rank)[0]
             .transpose(1, 2, 0), L['cot16']),
            ('vocab', lambda: fleet.VocabParallelEmbedding(32, 8),
             L['ids'], L['cot_emb'])):
        paddle.seed(0)
        layer = make()
        layer.set_state_dict(L[name.split('_')[0]])
        xt = paddle.to_tensor(np.ascontiguousarray(x),
                              stop_gradient=(name == 'vocab'))
        y = layer(xt)
        (y * paddle.to_tensor(np.ascontiguousarray(cot))).sum().backward()
        grads = {}
        for n, p in layer.named_parameters():
            g = p.grad._value
            info = getattr(p, '_dist', None)
            grads[n] = _np(info.gather(g) if info is not None else g)
        out[name] = {'out': _np(y._value), 'grads': grads,
                     'x_grad': (None if name == 'vocab'
                                else _np(xt.grad._value)),
                     'shapes': {n: tuple(p._value.shape)
                                for n, p in layer.named_parameters()},
                     'state': _state_np(layer)}
    return out


def _metrics(paddle, rank):
    from paddle_tpu_torch.distributed.fleet import metrics as M
    pos = np.array([1, 2, 3, 4], 'float64') * (rank + 1)
    neg = np.array([4, 3, 2, 1], 'float64') + rank
    return {'sum': M.sum(np.array([rank + 1.0, 2.0 ** 30 + rank])),
            'max': M.max(np.array([rank, -rank])),
            'min': M.min(np.array([rank, -rank])),
            'auc': M.auc(pos, neg), 'mae': M.mae(1.5 + rank, 3 + rank),
            'mse': M.mse(2.0 * (rank + 1), 4), 'rmse': M.rmse(2.0, 4),
            'acc': M.acc(rank + 3, 10)}


def _sampler(paddle):
    from paddle_tpu_torch.io import DistributedBatchSampler
    out = {}
    for name, deg in (('mp2', {'mp': 2}), ('dp2', {'dp': 2})):
        _fleet(paddle, **deg)
        s = DistributedBatchSampler(list(range(10)), batch_size=2)
        out[name] = [list(b) for b in s]
    return out


def fleet_cases(outdir):
    """Every case of tests/test_torch_fleet_parallel.py on one of 2
    ranks; writes fleet.rank<r>.pkl."""
    dist = _start()
    import paddle_tpu_torch as paddle
    paddle.set_device('cpu')
    rank = dist.get_rank()
    inp = _inputs(outdir)
    res = {'rank': rank}
    res['sampler'] = _sampler(paddle)
    res['dp'] = {f: _dp_form(paddle, inp, rank, f) for f in DP_FORMS}
    res['mp_eager'] = _mp_eager(paddle, inp, outdir, rank)
    res['sharded'] = {lay: _sharded_step(paddle, inp, rank, lay)
                      for lay in ('dp2', 'mp2')}
    res['hapi'] = {lay: _hapi_fit(paddle, inp, rank, lay)
                   for lay in HAPI_LAYOUTS}
    res['zero'] = {s: _zero_stage(paddle, inp, rank, s) for s in (1, 2, 3)}
    res['lars'] = _lars(paddle, inp, rank)
    res['localsgd'] = _localsgd(paddle, inp, rank)
    res['syncbn'] = _syncbn(paddle, inp, rank)
    res['layers'] = _mp_layers(paddle, inp, rank)
    res['metrics'] = _metrics(paddle, rank)
    _save(outdir, 'fleet', rank, res)
