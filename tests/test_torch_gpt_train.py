"""The port's GPT training path (paddle_tpu_torch/models/gpt.py: loss_fn,
remat, make_train_step, with the flash backward and AdamW) against the JAX
package's, on the CPU at 2 layers in float32: the reference's own
parameters (converted through numpy), its Pallas flash kernels in
interpret mode, the same tokens from a numpy seed, and the dropout seed
the reference draws from its key (``jax.random.bits(key, (1,),
uint32)[0]``), which the port takes in the key's place.

Tolerances: 1e-4 relative on the loss and on each gradient tensor (its
largest error over its largest value): f32 on both sides, summed in other
orders through two layers, the LM head and the flash backward; the same
1e-4 on a 6-step AdamW loss curve. (Not on the parameters it ends with:
Adam divides by sqrt(v), so an element whose gradient is rounding noise,
the k bias's for one, moves by up to lr a step either way.)"""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa

fa = importlib.import_module('paddle_tpu.ops.flash_attention')

S, B, V = 128, 2, 256
_CFGS = {
    # head dim 64, S 128: the reference's kernels take these in interpret
    # mode; xent_chunk 128 divides the vocab (the blockwise loss)
    'mha': dict(vocab_size=V, hidden_size=128, num_layers=2, num_heads=2,
                max_seq_len=S, dtype='float32', xent_chunk=128),
    'gqa': dict(vocab_size=V, hidden_size=256, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=S, dtype='float32',
                xent_chunk=128),
}


@pytest.fixture
def interpret():
    fa.set_interpret(True)
    try:
        yield
    finally:
        fa.set_interpret(False)


def _model(name, **over):
    cfg = jgpt.GPTConfig(**dict(_CFGS[name], **over))
    jp = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = tgpt.GPTConfig(**dataclasses.asdict(cfg))
    return cfg, jp, tcfg, tgpt.params_from_numpy(jp, tcfg, 'cpu')


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, S)).astype(np.int32),
            rng.randint(0, V, (B, S)).astype(np.int32))


def _seed_of(key):
    return int(jax.random.bits(key, (1,), jnp.uint32)[0])


def _port_value_and_grad(tp, tcfg, toks, tgts, seed):
    leaves = tgpt._leaves(tp)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    loss = tgpt.loss_fn(tgpt._rebuild(tp, live), torch.from_numpy(toks),
                        torch.from_numpy(tgts), tcfg, seed)
    grads = torch.autograd.grad(loss, live)
    return loss.item(), tgpt._rebuild(tp, grads)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _assert_grads(got, want, tol, path=''):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_grads(got[k], w, tol, f'{path}{k}.')
        else:
            assert _rel(got[k].numpy(), w) <= tol, f'{path}{k}'


@pytest.mark.parametrize('name,over', [
    ('mha', {}),
    ('gqa', {}),
    ('mha', dict(dropout=0.1)),
    ('gqa', dict(dropout=0.1, remat_policy='full')),
    ('mha', dict(xent_chunk=96)),          # does not divide V: log_softmax
])
def test_loss_and_grads_match_jax(interpret, name, over):
    cfg, jp, tcfg, tp = _model(name, **over)
    toks, tgts = _batch(1)
    key = jax.random.PRNGKey(3)
    jl, jg = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(toks),
        jnp.asarray(tgts), cfg, key)
    tl, tg = _port_value_and_grad(tp, tcfg, toks, tgts, _seed_of(key))
    assert abs(tl - float(jl)) <= 1e-4 * abs(float(jl))
    _assert_grads(tg, jg, 1e-4)


def test_dropout_changes_the_loss_and_follows_the_seed():
    _, _, tcfg, tp = _model('mha', dropout=0.1)
    toks, tgts = _batch(2)
    a, _ = _port_value_and_grad(tp, tcfg, toks, tgts, 5)
    b, _ = _port_value_and_grad(tp, tcfg, toks, tgts, 5)
    c, _ = _port_value_and_grad(tp, tcfg, toks, tgts, 2 ** 31 + 5)
    off, _ = _port_value_and_grad(tp, dataclasses.replace(tcfg, dropout=0.0),
                                  toks, tgts, 5)
    assert a == b and a != c and a != off


def test_remat_policies_give_equal_grads_and_rerun_kernel_1(monkeypatch):
    """none / full / dots: the same gradients (recomputation repeats the
    same arithmetic), and under both remat policies the attention forward
    runs again in the backward: 2 per layer, the backward once per layer."""
    calls = {'fwd': 0, 'bwd': 0}
    fwd, bwd = tfa.flash_fwd_reference, tfa.flash_bwd_reference

    def count_fwd(*a, **k):
        calls['fwd'] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls['bwd'] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tfa, 'flash_fwd_reference', count_fwd)
    monkeypatch.setattr(tfa, 'flash_bwd_reference', count_bwd)
    toks, tgts = _batch(4)
    grads, seen = {}, {}
    for remat, policy in ((False, 'dots'), (True, 'full'), (True, 'dots')):
        _, _, tcfg, tp = _model('gqa', remat=remat, remat_policy=policy,
                                dropout=0.1)
        calls.update(fwd=0, bwd=0)
        _, grads[(remat, policy)] = _port_value_and_grad(tp, tcfg, toks,
                                                         tgts, 77)
        seen[(remat, policy)] = dict(calls)
    L = tcfg.num_layers
    assert seen[(False, 'dots')] == {'fwd': L, 'bwd': L}
    assert seen[(True, 'full')] == {'fwd': 2 * L, 'bwd': L}
    assert seen[(True, 'dots')] == {'fwd': 2 * L, 'bwd': L}
    base = grads[(False, 'dots')]
    for k in ((True, 'full'), (True, 'dots')):
        for a, b in zip(tgpt._leaves(grads[k]), tgpt._leaves(base)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_six_step_train_curve_matches_reference_with_dropout(interpret):
    cfg, jp, tcfg, tp = _model('gqa', dropout=0.1)
    toks, tgts = _batch(5)
    jopt = paddle.optimizer.AdamW(learning_rate=2e-3, weight_decay=0.01)
    topt_ = topt.AdamW(learning_rate=2e-3, weight_decay=0.01)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jopt.functional_init(jparams)
    tstate = topt_.functional_init(tp)
    jstep = jgpt.make_train_step(cfg, jopt)
    tstep = tgpt.make_train_step(tcfg, topt_)
    jt, jy = jnp.asarray(toks), jnp.asarray(tgts)
    tt, ty = torch.from_numpy(toks), torch.from_numpy(tgts)
    jcurve, tcurve = [], []
    for i in range(6):
        key = jax.random.PRNGKey(100 + i)
        jl, jparams, jstate = jstep(jparams, jstate, key, jnp.float32(2e-3),
                                    jt, jy)
        tl, tp, tstate = tstep(tp, tstate, _seed_of(key), 2e-3, tt, ty)
        jcurve.append(float(jl))
        tcurve.append(tl.item())
    np.testing.assert_allclose(tcurve, jcurve, rtol=1e-4)
    assert tcurve[-1] < tcurve[0]


def test_unported_train_options_raise_naming_the_roadmap():
    """Step K1 ported the mesh step: grad_quant and an explicit mesh train
    here on a mesh of one rank (the layouts of several ranks are held in
    tests/test_torch_gpt_parallel.py); mp/sp/pp > 1 need a mesh of that
    degree; fp8 under sp raises the reference's own message."""
    from paddle_tpu_torch.distributed import HybridTopology
    cfg, jp, tcfg, tp = _model('mha')
    toks, tgts = _batch(2)
    tt, ty = torch.from_numpy(toks), torch.from_numpy(tgts)
    mesh = HybridTopology().mesh
    for over, where in ((dict(grad_quant='int8'), None), ({}, mesh)):
        opt = topt.AdamW(learning_rate=2e-3)
        params = jax.tree_util.tree_map(np.copy, jp)
        p = tgpt.params_from_numpy(params, tcfg, 'cpu')
        step = tgpt.make_train_step(dataclasses.replace(tcfg, **over), opt,
                                    where)
        state = opt.functional_init(p)
        losses = [step(p, state, 7, 2e-3, tt, ty)[0].item()
                  for _ in range(2)]
        assert np.isfinite(losses).all() and losses[1] < losses[0]
    opt = topt.AdamW()
    for over in (dict(mp=2), dict(sp=2), dict(pp=2)):
        with pytest.raises(ValueError, match='mesh'):
            tgpt.make_train_step(dataclasses.replace(tcfg, **over), opt)
    with pytest.raises(NotImplementedError, match='shard_map'):
        tgpt.make_train_step(
            dataclasses.replace(tcfg, matmul_precision='fp8', sp=2), opt)

@pytest.mark.parametrize('heads,dtype', [(4, 'float32'), (2, 'float32'),
                                         (4, 'bfloat16')])
def test_attention_route_is_chosen_by_the_kernel_gate(heads, dtype,
                                                      monkeypatch):
    """``use_flash`` takes kernel 1 (its twin here) only where an instance
    exists, chosen from the shape before the call as the reference's
    ``flash_attention_available`` gate chooses (head dim 64/128/256,
    f32/bf16); head dim 32 runs the reference's einsum path, and both
    routes give the reference's logits."""
    calls = []
    real = tgpt.flash_attention
    monkeypatch.setattr(tgpt, 'flash_attention',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    over = dict(vocab_size=64, hidden_size=128, num_layers=1,
                num_heads=heads, max_seq_len=32, dtype=dtype)
    jcfg = jgpt.GPTConfig(**over)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tgpt.GPTConfig(**over)
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, 'cpu')
    toks = np.arange(32, dtype=np.int32).reshape(1, 32) % 64
    got = tgpt.forward(tp, torch.from_numpy(toks), tcfg).float().numpy()
    want = np.asarray(jgpt.forward(jp, jnp.asarray(toks), jcfg), np.float32)
    assert (len(calls) > 0) == (tcfg.head_dim == 64)
    tol = 3e-2 if dtype == 'bfloat16' else 1e-4
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    q = torch.zeros((1, 4, heads, tcfg.head_dim),
                    dtype=tgpt.torch_dtype(dtype))
    assert tfa.kernel_takes(q, q, q) == (tcfg.head_dim == 64)
    assert not tfa.kernel_takes(q.half(), q.half(), q.half())
