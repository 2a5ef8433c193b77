"""Autograd of paddle_tpu_torch (torch's autograd under the Paddle API)
against the JAX package's tape: the cases of tests/test_autograd.py and
tests/test_double_grad.py through both packages, gradients within 1e-5
(f32), plus the port's aliasing and in-place rules."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from torch_op_cases import gradient_penalty
from paddle_tpu_torch import device as port_device

PACKAGES = [pytest.param(ref, id='reference'), pytest.param(port, id='port')]


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    yield
    port_device._current = prev


def _var(P, v):
    t = P.to_tensor(np.asarray(v, dtype='float32'))
    t.stop_gradient = False
    return t


def _np(t):
    return None if t is None else np.asarray(t.numpy())


# ---- scenarios: each returns the arrays it computed ---------------------------
_A4 = np.random.RandomState(0).rand(4).astype('float32')
_A34 = np.random.RandomState(1).rand(3, 4).astype('float32')
_B42 = np.random.RandomState(2).rand(4, 2).astype('float32')
_A6 = np.random.RandomState(3).rand(6).astype('float32')


def simple_backward(P):
    x = _var(P, [1., 2., 3.])
    (x * x).sum().backward()
    return [x.grad]


def chain(P):
    x = _var(P, _A4)
    P.exp(P.sin(x)).mean().backward()
    return [x.grad]


def accumulation(P):
    x = _var(P, np.ones(3))
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    g = x.grad
    x.clear_grad()
    return [g, x.grad]


def retain_graph(P):
    x = _var(P, np.ones(3))
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def paddle_grad(P):
    x = _var(P, [2., 3.])
    (gx,) = P.grad((x ** 3).sum(), x)
    return [gx, x.grad]


def matmul_grad(P):
    a, b = _var(P, _A34), _var(P, _B42)
    P.matmul(a, b).sum().backward()
    return [a.grad, b.grad]


def split_grad(P):
    x = _var(P, _A6)
    s = P.split(x, 3)
    (s[0] * 2 + s[2]).sum().backward()
    return [x.grad]


def getitem_grad(P):
    x = _var(P, _A34)
    x[1:3].sum().backward()
    (x[:, ::-1][0] * x[[0, 2]][1]).sum().backward()
    return [x.grad]


def non_scalar_root(P):
    x = _var(P, _A34)
    (x * x).backward()
    y = x * 3
    y.backward(P.to_tensor(_A34))
    return [x.grad]


def retained_intermediate(P):
    x = _var(P, _A4)
    y = x * 2
    y.retain_grads()
    (y * y).sum().backward()
    return [x.grad, y.grad]


def stop_gradient_intermediate(P):
    x = _var(P, _A4)
    y = x * 2
    y.stop_gradient = True
    (y * x).sum().backward()
    return [x.grad]


def grad_leaves_other_grads(P):
    x, w = _var(P, _A4), _var(P, _A4[::-1].copy())
    (w * x).sum().backward()
    before = _np(w.grad)
    (gx,) = P.grad((x * w * x).sum(), [x])
    return [gx, w.grad, before]


def grad_unused_and_outputs(P):
    x, y = _var(P, _A4), _var(P, _A4 + 1)
    z = x * x
    g = P.grad([z], [x, y], grad_outputs=[P.to_tensor(_A4)])
    gu = P.grad([(x * 2).sum()], [x, y], allow_unused=True)
    return [g[0], g[1], gu[0], gu[1] is None]


def autograd_backward(P):
    x = _var(P, _A4)
    P.autograd.backward([(x * x).sum(), (x * 3).sum()])
    return [x.grad]


def second_and_third_order(P):
    x = _var(P, [2.0])
    y = x * x * x
    (g,) = P.grad([y], [x], create_graph=True)
    (g2,) = P.grad([g], [x], create_graph=True)
    (g3,) = P.grad([g2], [x])
    return [g, g2, g3]


def second_order_transcendental(P):
    x = _var(P, [0.5])
    (g,) = P.grad([P.sin(x) * x], [x], create_graph=True)
    (g2,) = P.grad([g], [x])
    return [g, g2]


def second_order_matmul(P):
    rng = np.random.RandomState(0)
    w = _var(P, rng.rand(3, 3))
    x = P.to_tensor(rng.rand(4, 3).astype('float32'))
    (gw,) = P.grad([(P.matmul(x, w) ** 2).sum()], [w], create_graph=True)
    (gw2,) = P.grad([gw.sum()], [w])
    return [gw, gw2]


def pylayer_cube(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, grad):
            x, = ctx.saved_tensor()
            return grad * 3 * x * x

    x = _var(P, [2.0, -1.0])
    y = Cube.apply(x)
    y.sum().backward()
    return [y, x.grad]


def pylayer_multiple_outputs(P):
    class SplitScale(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            return x * 2, x * k

        @staticmethod
        def backward(ctx, g1, g2):
            return g1 * 2 + g2 * 3

    x = _var(P, [1.0, 2.0])
    a, b = SplitScale.apply(x, 3.0)
    (a.sum() + b.sum()).backward()
    return [a, b, x.grad]


SCENARIOS = [simple_backward, chain, accumulation, retain_graph, paddle_grad,
             matmul_grad, split_grad, getitem_grad, non_scalar_root,
             retained_intermediate, stop_gradient_intermediate,
             grad_leaves_other_grads, grad_unused_and_outputs,
             autograd_backward, second_and_third_order,
             second_order_transcendental, second_order_matmul,
             gradient_penalty, pylayer_cube, pylayer_multiple_outputs]


@pytest.mark.parametrize('scenario', SCENARIOS, ids=lambda s: s.__name__)
def test_gradients_match_the_reference(scenario):
    want = scenario(ref)
    got = scenario(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, bool):
            assert g is w or g == w
            continue
        g, w = _np(g) if hasattr(g, 'numpy') else g, \
            _np(w) if hasattr(w, 'numpy') else w
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# ---- the reference's own expectations, on the port -----------------------------

def test_analytic_values_on_the_port():
    np.testing.assert_allclose(_np(simple_backward(port)[0]), [2., 4., 6.])
    want = jax.grad(lambda v: jnp.mean(jnp.exp(jnp.sin(v))))(_A4)
    np.testing.assert_allclose(_np(chain(port)[0]), np.asarray(want),
                               rtol=1e-5)
    g, cleared = accumulation(port)
    np.testing.assert_allclose(_np(g), 5.0)
    assert cleared is None
    np.testing.assert_allclose(_np(retain_graph(port)[0]), 4.0)
    gx, xg = paddle_grad(port)
    np.testing.assert_allclose(_np(gx), [12., 27.])
    assert xg is None                   # paddle.grad leaves .grad alone
    np.testing.assert_allclose(_np(split_grad(port)[0]),
                               [2, 2, 0, 0, 1, 1])
    g, g2, g3 = second_and_third_order(port)
    np.testing.assert_allclose([_np(g), _np(g2), _np(g3)],
                               [[12.], [12.], [6.]])
    gx, gp, gw = gradient_penalty(port)
    w = np.random.RandomState(11).uniform(-0.5, 0.5, (4, 1)).astype(
        'float32').reshape(-1)
    np.testing.assert_allclose(_np(gw).reshape(-1),
                               2 * (8 * (w ** 2).sum() - 1.0) * 16 * w,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(pylayer_cube(port)[1]), [12., 3.])
    np.testing.assert_allclose(_np(pylayer_multiple_outputs(port)[2]),
                               [5., 5.])


@pytest.mark.parametrize('P', PACKAGES)
def test_no_grad_and_stop_gradient(P):
    x = _var(P, np.ones(3))
    with P.no_grad():
        y = (x * 2).sum()
    assert y.stop_gradient and y.is_leaf
    c = P.to_tensor(np.ones(3, 'float32'))
    assert c.stop_gradient
    (x * c).sum().backward()
    assert x.grad is not None and c.grad is None


@pytest.mark.parametrize('P', PACKAGES)
def test_create_graph_false_grads_are_detached(P):
    x = _var(P, [3.0])
    (g,) = P.grad([x * x], [x])
    assert g.stop_gradient and g.is_leaf


@pytest.mark.parametrize('P', PACKAGES)
def test_a_second_backward_raises(P):
    x = _var(P, np.ones(3))
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


@pytest.mark.parametrize('P', PACKAGES)
def test_a_second_backward_through_a_graph_that_saved_nothing_raises(P):
    """(x + 1).sum() saves no tensor, so torch alone would back through it
    twice; the reference raises for any graph, and so does the port, also
    through a node the first backward shared."""
    x = _var(P, np.ones(3))
    y = (x + 1).sum()
    y.backward()
    with pytest.raises(RuntimeError, match='second time'):
        y.backward()
    w = x + 1
    w.sum().backward()
    with pytest.raises(RuntimeError, match='second time'):
        (w * 2).sum().backward()
    z = (x + 2).sum()
    z.backward(retain_graph=True)
    z.backward()
    np.testing.assert_allclose(_np(x.grad), 4.0)


# ---- aliasing and in-place rules ---------------------------------------------------

def test_views_keep_their_values_when_the_source_is_updated_in_place():
    x = port.to_tensor(np.arange(6, dtype='float32'))
    y = x.reshape([2, 3])
    s = x[1:4]
    t = y.transpose([1, 0])
    d = x.detach()
    n = x.numpy()
    x.add_(1)
    x[0] = 100.0
    y.zero_()
    assert x.numpy().tolist() == [100., 2., 3., 4., 5., 6.]
    assert y.numpy().sum() == 0
    np.testing.assert_array_equal(s.numpy(), [1., 2., 3.])
    np.testing.assert_array_equal(t.numpy(), np.arange(6).reshape(2, 3).T)
    np.testing.assert_array_equal(d.numpy(), np.arange(6))
    np.testing.assert_array_equal(n, np.arange(6))


@pytest.mark.parametrize('P', PACKAGES)
def test_in_place_on_a_leaf_that_requires_grad(P):
    """Torch's own in-place op on such a leaf raises; the Paddle API
    rebinds it: it stays a leaf, keeps stop_gradient and its .grad."""
    x = _var(P, [1., 2.])
    (x * x).sum().backward()
    x.add_(P.to_tensor(np.ones(2, 'float32')))
    x.scale_(2.0)
    x.set_value(x * 1)
    assert x.is_leaf and not x.stop_gradient
    np.testing.assert_allclose(_np(x), [4., 6.])
    np.testing.assert_allclose(_np(x.grad), [2., 4.])
    with P.no_grad():
        x.set_value(x - 0.5 * x.grad)
        x.zero_()
    assert x.is_leaf and not x.stop_gradient
    (x * 3).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [5., 7.])


def test_setitem_then_backward_gives_the_functional_grads():
    """x[0] = v keeps the graph: the gradients are those of the
    reference's functional form (``.at[0].set``, differentiated by
    jax.grad). The reference's Tensor path drops them instead (its node's
    output is a temporary; ROADMAP Known differences), which the last
    lines pin down."""
    def loss(a, v):
        y = a * 2
        y = y.at[0].set(v)
        return jnp.sum(y * y)
    gx_want, gv_want = jax.grad(loss, (0, 1))(np.array([2., 3.], 'float32'),
                                              np.float32(5.))

    x = _var(port, [2., 3.])
    v = _var(port, 5.0)
    y = x * 2
    y[0] = v
    (y * y).sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(gx_want), rtol=1e-6)
    np.testing.assert_allclose(_np(v.grad), np.asarray(gv_want), rtol=1e-6)

    leaf = _var(port, [2., 3.])
    leaf[0] = v
    assert not leaf.is_leaf and not leaf.stop_gradient
    (leaf * leaf).sum().backward()
    assert leaf.grad is None                  # not a leaf any more
    np.testing.assert_allclose(_np(v.grad), np.asarray(gv_want) + 10.0)

    rx, rv = _var(ref, [2., 3.]), _var(ref, 5.0)
    ry = rx * 2
    ry[0] = rv
    (ry * ry).sum().backward()
    assert rx.grad is None and rv.grad is None


def test_a_leaf_off_the_gradients_graph_keeps_no_grad():
    """The penalty's gradient does not depend on the bias: torch leaves
    its .grad None, where the reference's taped backward of the add node
    takes the bias as an input and gives it zeros (ROADMAP Known
    differences)."""
    grads = {}
    for P in (ref, port):
        b = _var(P, np.zeros(1))
        x = _var(P, np.ones((2, 2)))
        (gx,) = P.grad([(x * 3 + b).sum()], [x], create_graph=True)
        (gx * gx).sum().backward()
        grads[P] = b.grad
    assert grads[port] is None
    np.testing.assert_array_equal(_np(grads[ref]), [0.0])


def test_stop_gradient_only_on_floating_tensors():
    i = port.to_tensor(np.array([1, 2]), stop_gradient=False)
    assert i.stop_gradient            # integers cannot require grad
    f = port.to_tensor(np.array([1., 2.]), stop_gradient=False)
    assert not f.stop_gradient and f.is_leaf
    f.stop_gradient = True
    assert f.stop_gradient


def test_grad_mode_is_per_thread():
    seen = {}

    def worker():
        seen['enabled'] = port.autograd.is_grad_enabled()
        x = _var(port, [1.0])
        seen['records'] = not (x * 2).stop_gradient

    with port.no_grad():
        assert not port.autograd.is_grad_enabled()
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen == {'enabled': True, 'records': True}
    port.set_grad_enabled(False)
    try:
        assert not port.autograd.is_grad_enabled()
        assert (_var(port, [1.0]) * 2).stop_gradient
    finally:
        port.set_grad_enabled(True)
    assert port.autograd.is_grad_enabled()


def test_the_eager_mlp_step_matches_the_reference():
    """chip_smoke.py phase 20's training loop at a small size: two SGD
    steps through both packages give the same losses and weights."""
    from torch_op_cases import mlp_data, mlp_step
    weights, x, y = mlp_data(16, 64, 32)
    result = {}
    for P in (ref, port):
        params = [P.to_tensor(w, stop_gradient=False) for w in weights]
        tx, ty = P.to_tensor(x), P.to_tensor(y)
        losses = [float(mlp_step(P, params, tx, ty, 2.0)) for _ in range(2)]
        result[P] = losses, [p.numpy() for p in params]
        assert all(p.grad is None and not p.stop_gradient for p in params)
    (rl, rp), (tl, tp) = result[ref], result[port]
    np.testing.assert_allclose(tl, rl, rtol=1e-5)
    assert tl[1] < tl[0]
    for a, b in zip(tp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
