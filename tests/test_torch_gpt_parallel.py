"""GPT's hybrid-parallel train step on the port (models/gpt.py's mesh path)
against the reference's ``make_train_step`` at the same layout.

One spawn of 4 gloo ranks (tests/torch_parallel_cases.py) runs every
layout from the reference's parameters and batch, 2 AdamW steps each, and
ZeRO 1-3 and ring flash attention with dropout; the parent runs the
reference on 4 of its virtual CPU devices at the same layout and holds
the port to it: each step's loss and the gathered parameters after 2
steps to 1e-4 (f32). The layouts: dp2 x mp2 (the reference's GSPMD path;
the port's explicit route), dp2 x sp2 (the port's ring through kernels
1-3's twins; the reference's plain ring, as its kernels do not run on a
CPU outside interpret mode), dp2 x pp2 GPipe, mp2 x pp2 1F1B, GQA under
sp2, grad_quant bf16 on dp4; grad_quant int8 (the port's rounding stream
is not the reference's) held within the reference's own bound of its
full-width curve (5e-3, tests/test_quant_collectives.py); ZeRO stages 1-3
on dp4 to the reference's ``make_zero_train_step`` at that stage and to
plain Adam."""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.models import gpt as jgpt
import paddle_tpu.parallel.ring_attention  # noqa: F401
from paddle_tpu.parallel import zero as rzero

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.topology import HybridTopology
from paddle_tpu_torch.models import gpt as tgpt

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_cases as C  # noqa: E402

# the package re-exports shadow the submodule with its function
rra = sys.modules['paddle_tpu.parallel.ring_attention']

N = 4
TOL = 1e-4


def _ref_params(kvh):
    cfg = jgpt.GPTConfig(**dict(C.GPT, num_kv_heads=kvh))
    return jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))


def _inputs():
    rs = np.random.RandomState(0)
    ring = {k: rs.randn(C.RING['b'], C.RING['s'], C.RING['h'],
                        C.RING['d']).astype(np.float32) for k in 'qkvg'}
    return {
        'params': {0: _ref_params(0), 2: _ref_params(2)},
        'tokens': rs.randint(0, C.GPT['vocab_size'], C.BATCH).astype(
            np.int32),
        'targets': rs.randint(0, C.GPT['vocab_size'], C.BATCH).astype(
            np.int32),
        'zero': {'params': {'w': rs.randn(16, 8).astype(np.float32),
                            'b': np.zeros((8,), np.float32)},
                 'x': rs.randn(32, 16).astype(np.float32),
                 'y': rs.randn(32, 8).astype(np.float32)},
        'ring': {'mha': ring},
    }


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """-> (inputs, rank 0's results); every rank's gathered results must
    agree."""
    out = str(tmp_path_factory.mktemp('gpt_parallel'))
    inp = _inputs()
    with open(os.path.join(out, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inp, f)
    tdist.spawn(C.gpt_layouts, (out,), nprocs=N, backend='gloo')
    res = []
    for r in range(N):
        with open(os.path.join(out, f'gpt.rank{r}.pkl'), 'rb') as f:
            res.append(pickle.load(f))
    for name, _, _ in C.LAYOUTS:
        for r in range(1, N):
            assert res[r][name]['losses'] == res[0][name]['losses'], name
    return inp, res[0]


def _ref_run(inp, deg, over, grad_quant=None):
    """The reference's make_train_step on 4 virtual devices: (losses,
    params) after C.STEPS AdamW steps."""
    over = dict(over)
    if grad_quant is not None:
        over['grad_quant'] = grad_quant
    topo = rtopo.HybridTopology(**deg, devices=jax.devices()[:N])
    cfg = jgpt.GPTConfig(**dict(C.GPT, **over))
    params = jax.tree_util.tree_map(
        jnp.asarray, inp['params'][over.get('num_kv_heads', 0)])
    params = jgpt.place_params(params, cfg, topo.mesh)
    opt = paddle.optimizer.AdamW(**C.OPT)
    state = opt.functional_init(params)
    step = jgpt.make_train_step(cfg, opt, topo.mesh)
    toks, tgts = jnp.asarray(inp['tokens']), jnp.asarray(inp['targets'])
    losses = []
    for i in range(C.STEPS):
        loss, params, state = step(params, state, jax.random.PRNGKey(100 + i),
                                   jnp.asarray(C.LR, jnp.float32), toks, tgts)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _max_err(got, want, path=''):
    if isinstance(want, dict):
        return max((_max_err(got[k], want[k], f'{path}/{k}') for k in want),
                   key=lambda e: e[0])
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()), path


HELD = [name for name, _, _ in C.LAYOUTS if name != 'dp4_gq_int8']


@pytest.mark.parametrize('name', HELD)
def test_layout_matches_the_reference(run, name):
    inp, res = run
    _, deg, over = next(lay for lay in C.LAYOUTS if lay[0] == name)
    losses, params = _ref_run(inp, deg, over)
    got = res[name]
    np.testing.assert_allclose(got['losses'], losses, rtol=TOL, atol=TOL)
    err, where = _max_err(got['params'], params)
    assert err <= TOL, f'{name}: params {where} off by {err:.3e}'


def test_grad_quant_int8_tracks_full_width(run):
    """The reference's bar for int8 (test_gpt_int8_single_step_close): the
    quantized curve within 5e-3 of the full-width one."""
    inp, res = run
    _, deg, over = next(lay for lay in C.LAYOUTS if lay[0] == 'dp4_gq_int8')
    base, _ = _ref_run(inp, deg, over, grad_quant='none')
    np.testing.assert_allclose(res['dp4_gq_int8']['losses'], base, atol=5e-3)
    assert res['dp4_gq_int8']['losses'] != res['dp4_gq_bf16']['losses']


@pytest.mark.parametrize('stage', [1, 2, 3])
def test_zero_stage_matches_the_reference_and_plain_adam(run, stage):
    inp, res = run
    z = inp['zero']
    got = res['zero'][stage]
    mesh = rtopo.HybridTopology(dp=N, devices=jax.devices()[:N]).mesh

    def quad(p, x, y):
        return jnp.mean((x @ p['w'] + p['b'] - y) ** 2)

    opt = paddle.optimizer.Adam(learning_rate=C.ZERO_LR)
    step, init_state = rzero.make_zero_train_step(quad, opt, mesh,
                                                  stage=stage, donate=False)
    params = {k: jnp.asarray(v) for k, v in z['params'].items()}
    p, s = init_state(params)
    xb, yb = step.place_batch(jnp.asarray(z['x'])), step.place_batch(
        jnp.asarray(z['y']))
    losses = []
    for _ in range(C.ZERO_STEPS):
        loss, p, s = step(p, s, jnp.asarray(C.ZERO_LR), xb, yb)
        losses.append(float(loss))
    np.testing.assert_allclose(got['losses'], losses, rtol=1e-5)
    np.testing.assert_allclose(got['w'], np.asarray(p['w']), rtol=1e-5,
                               atol=1e-6)
    ref_p = dict(params)
    ref_s = opt.functional_init(ref_p)
    for _ in range(C.ZERO_STEPS):
        _, g = jax.value_and_grad(lambda q: quad(q, z['x'], z['y']))(ref_p)
        ref_p, ref_s = opt.functional_apply(ref_p, g, ref_s,
                                            jnp.asarray(C.ZERO_LR))
    np.testing.assert_allclose(got['w'], np.asarray(ref_p['w']), rtol=1e-5,
                               atol=1e-6)
    # the layout: the specs are the reference's, the optimizer state is
    # in blocks on every stage, the parameters only at stage 3
    want = rzero.zero_specs(params, mesh)
    assert got['specs'] == {k: tuple(v) for k, v in want.items()}
    assert got['m1_block'] == (16 // N, 8)
    assert got['w_block'] == ((16 // N, 8) if stage >= 3 else (16, 8))


def test_ring_flash_dropout_matches_the_reference(run):
    """ring_flash_attention with dropout over sp=2 (the kernels' twins)
    against the reference's ring in interpret mode at the shape of
    tests/test_ring_flash.py's dropout gradient test: out, dq, dk, dv."""
    inp, res = run
    fa = sys.modules['paddle_tpu.ops.flash_attention']
    case = inp['ring']['mha']
    mesh = Mesh(np.asarray(jax.devices()[:C.RING['sp']]), ('sp',))
    spec = P(None, 'sp', None, None)
    f = shard_map(lambda q, k, v: rra.ring_flash_attention(
        q, k, v, 'sp', True, C.RING['drop'], jnp.uint32(C.RING['seed'])),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_rep=False)
    fa.set_interpret(True)
    try:
        out, vjp = jax.vjp(f, *(jnp.asarray(case[k]) for k in 'qkv'))
        grads = vjp(jnp.asarray(case['g']))
    finally:
        fa.set_interpret(False)
    got = res['ring']['mha']
    for k, want in zip(('out', 'dq', 'dk', 'dv'), (out, *grads)):
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_mesh_step_refusals_are_the_references():
    """The reference's own refusals in one process (a 1-rank mesh); fp8
    over a dp/mp mesh is ported (step K2): on a 1-rank mesh it is the
    single-device fp8 step, loss and state."""
    mesh = HybridTopology().mesh
    base = tgpt.GPTConfig(**C.GPT)
    opt = topt.AdamW()
    cases = [
        (dict(dropout=0.1, pp=2), 'pipeline'),
        (dict(matmul_precision='fp8', sp=2), 'shard_map'),
        (dict(matmul_precision='fp8', grad_quant='bf16'), 'shard_map'),
        (dict(grad_quant='int8', pp=2, pp_schedule='1f1b'), '1F1B'),
    ]
    for over, msg in cases:
        cfg = dataclasses.replace(base, **over)
        with pytest.raises(NotImplementedError, match=msg):
            tgpt.make_train_step(cfg, opt, mesh)
        rcfg = jgpt.GPTConfig(**dict(C.GPT, **over))
        with pytest.raises(NotImplementedError, match=msg):
            jgpt.make_train_step(rcfg, paddle.optimizer.AdamW(),
                                 rtopo.HybridTopology(
                                     devices=jax.devices()[:1]).mesh)
    import torch
    fcfg = dataclasses.replace(base, num_layers=2, matmul_precision='fp8')
    inp = _inputs()
    toks = torch.from_numpy(inp['tokens'])
    runs = []
    for m in (None, mesh):
        p = tgpt.init_params(fcfg, torch.Generator().manual_seed(0), 'cpu')
        o = topt.AdamW(**C.OPT)
        s, f8 = o.functional_init(p), tgpt.init_fp8_state(fcfg, 'cpu')
        loss, p, s, f8 = tgpt.make_train_step(fcfg, o, m)(
            p, s, f8, 0, C.LR, toks, toks)
        runs.append((loss.item(), f8['blocks']['qkv']['g']['ahist']))
    assert runs[1][0] == runs[0][0]
    assert torch.equal(runs[1][1], runs[0][1])
    with pytest.raises(ValueError, match='mp=2'):
        tgpt.make_train_step(dataclasses.replace(base, mp=2), opt, mesh)


def test_one_rank_mesh_step_matches_the_single_device_step():
    """On a mesh of one rank the explicit route (the full-logits loss, no
    collective) equals the single-device step (the blockwise loss)."""
    import torch
    inp = _inputs()
    cfg = tgpt.GPTConfig(**C.GPT)
    toks = torch.from_numpy(inp['tokens'])
    tgts = torch.from_numpy(inp['targets'])
    runs = []
    for mesh in (None, HybridTopology().mesh):
        p = tgpt.params_from_numpy(inp['params'][0], cfg, 'cpu')
        opt = topt.AdamW(**C.OPT)
        s = opt.functional_init(p)
        step = tgpt.make_train_step(cfg, opt, mesh)
        runs.append([step(p, s, 0, C.LR, toks, tgts)[0].item()
                     for _ in range(C.STEPS)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
