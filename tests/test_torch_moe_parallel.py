"""The MoE GPT's mesh train step (dp, ep, mp), fp8 over a dp/mp mesh and
``hybrid_zero3_specs`` on the port, against the reference.

One spawn of 4 gloo ranks (tests/torch_parallel_cases.py ``moe_layouts``)
runs every layout, two meshes of 2 ranks side by side or one of 4, 2
AdamW steps each from the reference's parameters. The reference's MoE
step under GSPMD is its global function, so the parent holds each layout
to the reference's single-device step: each step's loss and the gathered
parameters after 2 steps, f32, 1e-5 for dp and ep, 1e-4 for mp. The
'skew' batch puts one token id in every row of the first dp block: its
first choices overfill one expert, so positions, capacity and the aux
loss counted per rank would train a different model than the global
routing does. fp8 over dp2 / mp2 (GPT, and MoE's qkv and proj): every
rank's scales and amax histories after each step are the reference's
single-device state. The specs (``param_specs``,
``expert_partition_specs``, ``hybrid_zero3_specs``) are the reference's,
and a ZeRO-3-in-mp2 placement cut by them gathers back whole."""
import dataclasses
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import moe_gpt as jmoe
from paddle_tpu.parallel import moe as rmoe
from paddle_tpu.parallel import zero as rzero

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import moe_gpt as tmoe
from paddle_tpu_torch.parallel import moe as tmoe_ffn
from paddle_tpu_torch.parallel import zero as tzero

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_cases as C  # noqa: E402

N = 4
CASES = {case[0]: case for rnd in C.MOE_ROUNDS for _, _, case in rnd}


def _ref_cfg(model, **over):
    if model == 'moe':
        return jmoe.MoEConfig(**dict(C.MOE, **over))
    return jgpt.GPTConfig(**dict(C.GPT_FP8, **over))


def _inputs():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 64, C.BATCH).astype(np.int32)
    tgts = rs.randint(0, 64, C.BATCH).astype(np.int32)
    skew = toks.copy()
    skew[:C.BATCH[0] // 2] = 5
    params = {m: jax.tree_util.tree_map(np.asarray, (
        jmoe if m == 'moe' else jgpt).init_params(_ref_cfg(m),
                                                  jax.random.PRNGKey(0)))
        for m in ('moe', 'gpt')}
    return {'params': params, 'batch': (toks, tgts), 'skew': (skew, tgts)}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """-> (inputs, {case: its first rank's results}); the ranks of a
    mesh must agree on the losses and the fp8 state."""
    out = str(tmp_path_factory.mktemp('moe_parallel'))
    inp = _inputs()
    with open(os.path.join(out, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inp, f)
    tdist.spawn(C.moe_layouts, (out,), nprocs=N, backend='gloo')
    ranks = []
    for r in range(N):
        with open(os.path.join(out, f'moe.rank{r}.pkl'), 'rb') as f:
            ranks.append(pickle.load(f))
    res = {}
    for name in CASES:
        mine = [rk[name] for rk in ranks if name in rk]
        assert len(mine) in (2, 4), name
        for other in mine[1:]:
            assert other['losses'] == mine[0]['losses'], name
            for a, b in zip(other['states'], mine[0]['states']):
                jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
        res[name] = mine[0]
    res['hybrid'] = [rk['hybrid'] for rk in ranks]
    return inp, res


_REF = {}


def _ref_run(inp, model, over, bkey):
    """The reference's single-device step (its GSPMD step computes the
    same global function): (losses, params, fp8 states) after C.STEPS
    AdamW steps; memoized by (model, precision, batch)."""
    fp8 = over.get('matmul_precision') == 'fp8'
    key = (model, fp8, bkey)
    if key in _REF:
        return _REF[key]
    cfg = _ref_cfg(model, **({'matmul_precision': 'fp8'} if fp8 else {}))
    mod = jmoe if model == 'moe' else jgpt
    params = jax.tree_util.tree_map(jnp.asarray, inp['params'][model])
    opt = paddle.optimizer.AdamW(**C.OPT)
    state = opt.functional_init(params)
    step = mod.make_train_step(cfg, opt)
    toks, tgts = (jnp.asarray(a) for a in inp[bkey])
    f8 = mod.init_fp8_state(cfg) if fp8 else None
    losses, states = [], []
    for i in range(C.STEPS):
        lr = jnp.asarray(C.LR, jnp.float32)
        if fp8:
            loss, params, state, f8 = step(params, state, f8,
                                           jax.random.PRNGKey(i), lr, toks,
                                           tgts)
            states.append(jax.tree_util.tree_map(np.asarray, f8))
        else:
            loss, params, state = step(params, state, jax.random.PRNGKey(i),
                                       lr, toks, tgts)
        losses.append(float(loss))
    _REF[key] = (losses, jax.tree_util.tree_map(np.asarray, params), states)
    return _REF[key]


def _max_err(got, want, path=''):
    if isinstance(want, dict):
        return max((_max_err(got[k], want[k], f'{path}/{k}') for k in want),
                   key=lambda e: e[0])
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()), path


MOE_CASES = [n for n, c in CASES.items()
             if c[1] == 'moe' and 'matmul_precision' not in c[2]]


@pytest.mark.parametrize('name', MOE_CASES)
def test_moe_layout_matches_the_reference(run, name):
    inp, res = run
    _, model, over, bkey = CASES[name]
    losses, params, _ = _ref_run(inp, model, over, bkey)
    tol = 1e-4 if over.get('mp', 1) > 1 else 1e-5
    got = res[name]
    np.testing.assert_allclose(got['losses'], losses, rtol=tol, atol=tol)
    err, where = _max_err(got['params'], params)
    assert err <= tol, f'{name}: params {where} off by {err:.3e}'


def test_the_skewed_batch_routes_differently_per_rank():
    """The 'skew' case discriminates: routing each dp block alone (its own
    capacity, positions and aux) gives another loss than the global
    routing of the whole batch."""
    inp = _inputs()
    cfg = tmoe.MoEConfig(**C.MOE)
    p = tgpt.params_from_numpy(inp['params']['moe'], cfg, 'cpu')
    toks, tgts = (torch.from_numpy(a).long() for a in inp['skew'])
    h = C.BATCH[0] // 2
    with torch.no_grad():
        whole = tmoe.loss_fn(p, toks, tgts, cfg).item()
        halves = np.mean([tmoe.loss_fn(p, toks[s], tgts[s], cfg).item()
                          for s in (slice(0, h), slice(h, None))])
    assert abs(whole - halves) > 1e-3, (whole, halves)


FP8_CASES = [n for n, c in CASES.items()
             if c[2].get('matmul_precision') == 'fp8' or c[1] == 'gpt']


@pytest.mark.parametrize('name', FP8_CASES)
def test_fp8_state_over_the_mesh_is_the_references(run, name):
    """Every rank's new scales and amax histories equal the reference's
    single-device state after each step (f32; the operands' blocks are
    the reference's tensors up to the mesh's summation order)."""
    inp, res = run
    _, model, over, bkey = CASES[name]
    losses, _, states = _ref_run(inp, model, dict(over,
                                                  matmul_precision='fp8'),
                                 bkey)
    got = res[name]
    np.testing.assert_allclose(got['losses'], losses, rtol=1e-4)
    assert len(got['states']) == len(states) == C.STEPS
    for g, w in zip(got['states'], states):
        for mm, roles in w['blocks'].items():
            for role, meta in roles.items():
                for k in ('scale', 'ahist'):
                    np.testing.assert_allclose(
                        g['blocks'][mm][role][k], np.asarray(meta[k]),
                        rtol=1e-5, err_msg=f'{name} {mm} {role} {k}')


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_specs_are_the_references():
    """``param_specs`` (tests/test_partitioner.py:122-128 among them),
    ``expert_partition_specs`` and ``hybrid_zero3_specs`` over GPT's and
    MoE's trees on a dp2 x mp2 mesh."""
    for mp in (1, 2):
        rcfg = jmoe.MoEConfig(**dict(C.MOE, mp=mp))
        tcfg = tmoe.MoEConfig(**dict(C.MOE, mp=mp))
        assert (_spec_tuples(tmoe.param_specs(tcfg))
                == _spec_tuples(jmoe.param_specs(rcfg)))
    blocks = tmoe.param_specs(tcfg)['blocks']
    assert tuple(blocks['w_in']) == (None, 'ep', None, 'mp')
    assert tuple(blocks['w_out']) == (None, 'ep', 'mp', None)
    assert tuple(blocks['gate_w']) == (None, None, None)
    assert (_spec_tuples(tmoe_ffn.expert_partition_specs())
            == _spec_tuples(rmoe.expert_partition_specs()))
    rmesh = rtopo.HybridTopology(dp=2, mp=2, devices=jax.devices()[:4]).mesh
    tmesh = types.SimpleNamespace(shape=dict(rmesh.shape))
    inp = _inputs()
    for model, rmod, tmod, cls in (('gpt', jgpt, tgpt, 'GPTConfig'),
                                   ('moe', jmoe, tmoe, 'MoEConfig')):
        base = C.GPT_FP8 if model == 'gpt' else C.MOE
        rcfg = getattr(rmod, cls)(**dict(base, mp=2))
        tcfg = getattr(tmod, cls)(**dict(base, mp=2))
        tree = inp['params'][model]
        want = rzero.hybrid_zero3_specs(tree, rmod.param_specs(rcfg), rmesh)
        got = tzero.hybrid_zero3_specs(tree, tmod.param_specs(tcfg), tmesh)
        assert _spec_tuples(got) == jax.tree_util.tree_map(
            tuple, want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))


def test_hybrid_zero3_placement_gathers_back(run):
    """Each rank's blocks under ``hybrid_zero3_specs`` over the mesh
    step's specs (dp2 x mp2) are the specs' shapes, and ``replicate``
    gathers the global tree back on every rank."""
    inp, res = run
    mesh = types.SimpleNamespace(shape={'dp': 2, 'mp': 2})
    for model, mod, cls in (('gpt', tgpt, 'GPTConfig'),
                            ('moe', tmoe, 'MoEConfig')):
        base = C.GPT_FP8 if model == 'gpt' else C.MOE
        cfg = getattr(mod, cls)(**dict(base, mp=2))
        tree = inp['params'][model]
        specs = tzero.hybrid_zero3_specs(tree, mod.train_specs(cfg), mesh)
        flat = dict(C._paths(specs))
        for r, hy in enumerate(res['hybrid']):
            for path, shape in hy[model]['shapes'].items():
                full = dict(C._paths(tree))[path].shape
                spec = tuple(flat[path]) + (None,) * (len(full)
                                                      - len(flat[path]))
                want = tuple(s // int(np.prod([mesh.shape.get(a, 1) for a in (
                    () if e is None else e if isinstance(e, tuple)
                    else (e,))])) for s, e in zip(full, spec))
                assert shape == want, (model, r, path)
            err, where = _max_err(hy[model]['back'], tree)
            assert err == 0.0, (model, r, where)


def test_moe_mesh_refusals_and_pp_as_the_reference():
    """sp > 1 raises where the reference's step raises (its ring meets an
    unbound 'sp' axis); pp > 1, which the reference's step ignores (its
    layers stay replicated, its function the single-device one), trains
    the pp = 1 step, held to the reference's single-device step."""
    inp = _inputs()
    rcfg = jmoe.MoEConfig(**dict(C.MOE, sp=2))
    topo = rtopo.HybridTopology(sp=2, devices=jax.devices()[:2])
    params = jax.tree_util.tree_map(jnp.asarray, inp['params']['moe'])
    opt = paddle.optimizer.AdamW(**C.OPT)
    step = jmoe.make_train_step(rcfg, opt, topo.mesh)
    toks, tgts = (jnp.asarray(a) for a in inp['batch'])
    with pytest.raises(NameError, match='unbound axis name: sp'):
        step(params, opt.functional_init(params), jax.random.PRNGKey(0),
             jnp.float32(C.LR), toks, tgts)
    tcfg = tmoe.MoEConfig(**C.MOE)
    for over in (dict(sp=2), dict(sp=2, matmul_precision='fp8')):
        with pytest.raises(NotImplementedError, match='unbound axis name'):
            tmoe.make_train_step(dataclasses.replace(tcfg, **over),
                                 topt.AdamW())
    losses, _, _ = _ref_run(inp, 'moe', {}, 'batch')
    p = tgpt.params_from_numpy(inp['params']['moe'], tcfg, 'cpu')
    topt_ = topt.AdamW(**C.OPT)
    s = topt_.functional_init(p)
    step = tmoe.make_train_step(dataclasses.replace(tcfg, pp=2), topt_)
    got = [step(p, s, 0, C.LR, *(torch.from_numpy(a) for a in
                                 inp['batch']))[0].item()
           for _ in range(C.STEPS)]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
