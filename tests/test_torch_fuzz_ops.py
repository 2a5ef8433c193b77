"""tests/test_fuzz_ops.py's property strategies with the port held against
the JAX package (bounded hypothesis fuzz, 25 examples each): same inputs,
same shapes, dtypes and values, gradients included."""
import jax
import numpy as np
import pytest

pytest.importorskip('hypothesis')
from hypothesis import given, settings, strategies as st

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device

_FAST = settings(max_examples=25, deadline=None)

shapes = st.lists(st.integers(1, 5), min_size=1, max_size=3).map(tuple)


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def arr(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype('float32') * 4 - 2)


def both(fn, *arrays, tol=1e-5):
    """fn(P, *tensors) -> list of tensors, through both packages: equal
    shapes and dtypes, values within ``tol``. The reference's ops run as
    one ``jax.jit`` program (one compile an example, not one a
    primitive)."""
    def program(*values):
        return [t._value for t in fn(ref, *map(ref.to_tensor, values))]
    want = jax.jit(program)(*arrays)
    got = fn(port, *map(port.to_tensor, arrays))
    assert len(got) == len(want)
    for t, r in zip(got, want):
        assert t.shape == list(r.shape)
        assert str(t.dtype).replace('torch.', '') == np.dtype(r.dtype).name
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol)


@_FAST
@given(shape=shapes, seed=st.integers(0, 2**16))
def test_fuzz_unary(shape, seed):
    both(lambda P, x: [P.tanh(x), P.exp(x), P.abs(x), P.sigmoid(x)],
         arr(shape, seed))


@_FAST
@given(shape=shapes, seed=st.integers(0, 2**16),
       op=st.sampled_from(['add', 'subtract', 'multiply', 'maximum',
                           'minimum']))
def test_fuzz_binary_broadcast(shape, seed, op):
    both(lambda P, x, y: [getattr(P, op)(x, y)], arr(shape, seed),
         arr(shape[-1:], seed + 1))


@_FAST
@given(shape=shapes, seed=st.integers(0, 2**16), keep=st.booleans())
def test_fuzz_reductions(shape, seed, keep):
    axis = len(shape) - 1
    both(lambda P, x: [P.sum(x, axis=axis, keepdim=keep),
                       P.max(x, axis=axis, keepdim=keep),
                       P.mean(x, axis=axis, keepdim=keep)],
         arr(shape, seed))


@_FAST
@given(seed=st.integers(0, 2**16), m=st.integers(1, 6), k=st.integers(1, 6),
       n=st.integers(1, 6))
def test_fuzz_matmul_grad(seed, m, k, n):
    """matmul value AND gradient."""
    def fn(P, x, y):
        x.stop_gradient = False
        y.stop_gradient = False
        out = P.matmul(x, y)
        out.sum().backward()
        return [out, x.grad, y.grad]
    both(fn, arr((m, k), seed), arr((k, n), seed + 1))


@_FAST
@given(shape=shapes, seed=st.integers(0, 2**16))
def test_fuzz_manipulation_roundtrips(shape, seed):
    perm = list(range(len(shape)))[::-1]
    both(lambda P, x: [P.reshape(P.flatten(x), list(shape)),
                       P.transpose(P.transpose(x, perm), perm),
                       P.flip(P.flip(x, [0]), [0]), P.flatten(x)],
         arr(shape, seed), tol=0)


@_FAST
@given(seed=st.integers(0, 2**16), n=st.integers(2, 16), k=st.integers(1, 8))
def test_fuzz_topk_sort_consistency(seed, n, k):
    k = min(k, n)
    a = arr((n,), seed)
    both(lambda P, x: list(P.topk(x, k)), a)
    v, i = port.topk(port.to_tensor(a), k)
    np.testing.assert_allclose(np.sort(v.numpy())[::-1],
                               np.sort(a)[::-1][:k], rtol=1e-6)
    np.testing.assert_allclose(a[i.numpy()], v.numpy(), rtol=1e-6)
