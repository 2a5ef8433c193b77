"""The port's blockwise LM-head loss (paddle_tpu_torch/ops/xent.py) and its
Adam/AdamW functional core (paddle_tpu_torch/optimizer/) against the JAX
package's, on the CPU. Inputs come from numpy seeds.

Tolerances: the loss and its gradients 1e-5 (f32 chunk matmuls summed in
another order); the optimizer 1e-6 (the same ops in the same order, each
rounding once in f32; the f32 square root and division may differ by an
ulp between the two libraries)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import xent as jxent
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops import xent as txent


def _xent_case(n=96, h=32, v=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h).astype(np.float32)
    w = (rng.randn(v, h) * 0.3).astype(np.float32)
    t = rng.randint(0, v, size=n).astype(np.int32)
    t[:3] = [0, v - 1, v // 2]           # both vocab ends, a chunk edge
    return x, w, t


@pytest.mark.parametrize('chunk', [64, 128, 256])
def test_blockwise_xent_loss_and_grads_match_jax(chunk):
    x, w, t = _xent_case(seed=chunk)
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jxent.softmax_xent_blockwise(a, b, jnp.asarray(t),
                                                  chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = txent.softmax_xent_blockwise(tx, tw, torch.from_numpy(t), chunk)
    tl.backward()
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


def test_blockwise_xent_equals_the_dense_loss_and_keeps_dtypes():
    x, w, t = _xent_case(n=40, v=128, seed=3)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = txent.softmax_xent_blockwise(tx, tw, torch.from_numpy(t), 32)
    dense = torch.nn.functional.cross_entropy(
        tx.float() @ tw.T, torch.from_numpy(t).long())
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-5)
    loss.backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    with pytest.raises(ValueError, match='divide'):
        txent.softmax_xent_blockwise(tx, tw, torch.from_numpy(t), 48)


# ---------------------------------------------------------------------------
# Adam / AdamW, functional core
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {'w': rng.randn(6, 5).astype(np.float32),
            'blocks': {'a': rng.randn(3, 4, 2).astype(np.float32),
                       'b': rng.randn(7).astype(np.float32)}}


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(v.copy())) for k, v in tree.items()}


def _assert_tree(got, want, tol):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree(got[k], v, tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize('kind,kw', [
    ('AdamW', dict(learning_rate=2e-3, weight_decay=0.01)),
    ('AdamW', dict(learning_rate=1e-2, beta1=0.8, beta2=0.99, epsilon=1e-6,
                   weight_decay=0.1)),
    ('Adam', dict(learning_rate=2e-3)),
    ('Adam', dict(learning_rate=2e-3, weight_decay=0.05)),
])
def test_optimizer_three_steps_match_functional_apply(kind, kw):
    jo = getattr(paddle.optimizer, kind)(**kw)
    to = getattr(topt, kind)(**kw)
    params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jo.functional_init(jp), to.functional_init(tp)
    assert set(ts['w']) == set(js['w'])
    for i in range(3):
        grads = _tree(10 + i)
        lr = 2e-3 * (i + 1)
        jp, js = jo.functional_apply(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), js,
            jnp.float32(lr))
        tp2, ts2 = to.functional_apply(tp, _to_torch(grads), ts, lr)
        assert tp2 is tp and ts2 is ts          # updated in place
    _assert_tree(tp, jp, 1e-6)
    for k in ('moment1', 'moment2', 'beta1_pow', 'beta2_pow'):
        np.testing.assert_allclose(ts['w'][k].numpy(), np.asarray(js['w'][k]),
                                   rtol=1e-6, atol=1e-6)


def test_optimizer_skips_a_missing_gradient_and_casts_the_gradient():
    to = topt.AdamW(learning_rate=1e-2)
    p = {'a': torch.ones(3), 'b': torch.ones(2)}
    st = to.functional_init(p)
    to.functional_apply(p, {'a': None, 'b': torch.ones(2, dtype=torch.bfloat16)},
                        st, None)
    assert torch.equal(p['a'], torch.ones(3))
    assert float(st['a']['beta1_pow']) == 1.0
    assert p['b'].dtype == torch.float32 and (p['b'] < 1).all()


def test_eager_optimizer_paths_ported_in_j1():
    """Ported with the eager optimizer (ROADMAP Queue 1 item 7, step J1):
    ``grad_clip`` clips functional_apply's gradients, ``step()`` with no
    parameters does nothing, and ``parameters=`` takes any list, stepping
    only its Parameters (raw torch tensors are skipped, as the reference
    skips non-Parameters)."""
    from paddle_tpu_torch import nn as tnn
    p = {'w': torch.ones(4)}
    opt = topt.SGD(learning_rate=1.0, grad_clip=tnn.ClipGradByValue(0.25))
    opt.functional_apply(p, {'w': torch.full((4,), 3.0)},
                         opt.functional_init(p))
    assert torch.equal(p['w'], torch.full((4,), 0.75))
    topt.AdamW().step()
    raw = torch.zeros(2)
    topt.Adam(parameters=[raw]).step()
    assert torch.equal(raw, torch.zeros(2))
