"""The eager op library of paddle_tpu_torch against the JAX package's, on
the CPU: every case of ``tests/torch_op_cases.py`` through both packages
(shape, dtype and value), the numpy cases of ``tests/test_tensor_ops.py``
re-run on the port, and the random ops held to shape, dtype, range and the
moments of 10^5 draws."""
import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import test_tensor_ops as ref_numpy_cases
import torch_op_cases as cases
from paddle_tpu_torch import device as port_device


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._current
    port.set_device('cpu')
    port.seed(0)
    yield
    port_device._current = prev


def reference_result(case):
    """The JAX package's result for a case, its ops traced and compiled as
    one program (the reference's op library under ``jax.jit``, as its
    static path runs it): one XLA compile a case instead of one for each
    primitive, which on a CPU is the whole cost. A case that runs host
    code (``np.unique``, ``nonzero``, a value read back) runs eagerly."""
    is_tensor = lambda t: isinstance(t, ref.Tensor)   # noqa: E731
    arrays = [a for a in case.inputs if isinstance(a, np.ndarray)]
    traced = {}

    def program(*values):
        it = iter(values)
        args = [ref.to_tensor(next(it)) if isinstance(a, np.ndarray) else a
                for a in case.inputs]
        leaves, tree = jax.tree_util.tree_flatten(case.call(ref, *args),
                                                  is_leaf=is_tensor)
        traced['tree'], traced['leaves'] = tree, leaves
        return [t._value for t in leaves if is_tensor(t)]

    try:
        values = iter(jax.jit(program)(*arrays))
    except (TypeError, jax.errors.JAXTypeError, jax.errors.JAXIndexError,
            jax.errors.ConcretizationTypeError):
        return case.run(ref)
    leaves = [ref.Tensor(next(values)) if is_tensor(t) else t
              for t in traced['leaves']]
    return jax.tree_util.tree_unflatten(traced['tree'], leaves)


@pytest.mark.parametrize('case', cases.C, ids=lambda c: c.name)
def test_case_matches_the_reference(case):
    want = cases.flatten(reference_result(case))
    got = cases.flatten(case.run(port))
    cases.compare(case, got, want)


def test_the_table_covers_every_op_of_the_namespace():
    """Every public callable of paddle_tpu.tensor is called by some case
    (or is one of the deferrals, the random ops held below, or a helper
    the table uses to build its inputs)."""
    import inspect
    import paddle_tpu.tensor as RT
    names = {n for n in dir(RT) if not n.startswith('_')
             and callable(getattr(RT, n))
             and not inspect.ismodule(getattr(RT, n))}
    src = open(cases.__file__).read()
    called = {n for n in names if f'P.{n}(' in src or f"'{n}'" in src
              or f'.{n}(' in src}
    held_elsewhere = {'create_array', 'array_read', 'array_write',
                      'array_length', 'Tensor', 'op', 'apply_op', 'seed',
                      'set_printoptions', 'uniform_', 'is_tensor'} | set(
        cases.RANDOM)
    assert names - called - held_elsewhere == set()


REF_NUMPY_TESTS = ['test_creation', 'test_elementwise_math',
                   'test_reductions', 'test_matmul_linalg',
                   'test_manipulation', 'test_indexing_and_search',
                   'test_logic', 'test_random_and_stats',
                   'test_tensor_method_bindings_r4']


@pytest.mark.parametrize('name', REF_NUMPY_TESTS)
def test_reference_numpy_cases_on_the_port(name, monkeypatch):
    """tests/test_tensor_ops.py's own test bodies with ``paddle`` bound to
    the port (numpy is their reference)."""
    monkeypatch.setattr(ref_numpy_cases, 'paddle', port)
    getattr(ref_numpy_cases, name)()


def test_reference_operators_and_methods_on_the_port():
    """tests/test_tensor_ops.py::test_operators_and_methods, whose last
    dtype check reads numpy's ``dtype.name``; the port's dtypes are
    torch's, so it compares with ``paddle.int32``."""
    paddle = port
    a = paddle.to_tensor(np.array([2., 4.], 'float32'))
    b = paddle.to_tensor(np.array([1., 2.], 'float32'))
    assert (a + b).numpy().tolist() == [3., 6.]
    assert (a - b).numpy().tolist() == [1., 2.]
    assert (a * b).numpy().tolist() == [2., 8.]
    assert (a / b).numpy().tolist() == [2., 2.]
    assert (a ** 2).numpy().tolist() == [4., 16.]
    assert (-a).numpy().tolist() == [-2., -4.]
    assert (a > b).numpy().tolist() == [True, True]
    assert (1 + a).numpy().tolist() == [3., 5.]
    assert a.add(b).numpy().tolist() == [3., 6.]
    assert a.astype('int64').dtype == paddle.int32
    assert a.numel().item() == 2


def test_fft_and_signal_wait_for_their_slice():
    """Ported with step I's rest (ROADMAP Queue 1 item 6): the calls that
    raised before run, in complex64 as the reference's, and agree with it
    (the op table holds every fft and signal name)."""
    a = np.random.RandomState(0).rand(32).astype('float32')
    for name in ('fft.fft', 'fft.rfft', 'signal.stft'):
        mod, fn = name.split('.')
        args = (8,) if mod == 'signal' else ()
        got = getattr(getattr(port, mod), fn)(port.to_tensor(a), *args)
        want = getattr(getattr(ref, mod), fn)(ref.to_tensor(a), *args)
        assert got.dtype == port.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# ---- random ops -------------------------------------------------------------
@pytest.mark.parametrize('name', sorted(cases.RANDOM))
def test_random_op_matches_the_reference_in_distribution(name):
    """Streams differ (threefry vs torch's generator); shape, dtype, range
    and the first two moments of 10^5 draws agree with the reference's and
    with the distribution's (within 6 standard errors)."""
    ref.seed(3)
    r = cases.check_random(name, cases.RANDOM[name][0](ref))
    t = cases.check_random(name, cases.RANDOM[name][0](port))
    assert t.shape == r.shape


def test_random_streams_repeat_under_a_seed_and_never_touch_torch_global():
    import torch
    before = torch.random.get_rng_state()
    port.seed(7)
    a = [port.rand([5]).numpy(), port.randint(0, 100, [5]).numpy(),
         port.randperm(6).numpy()]
    state = port.get_rng_state()
    c = port.randn([4]).numpy()
    port.seed(7)
    b = [port.rand([5]).numpy(), port.randint(0, 100, [5]).numpy(),
         port.randperm(6).numpy()]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    port.set_rng_state(state)
    np.testing.assert_array_equal(port.randn([4]).numpy(), c)
    assert not np.array_equal(port.rand([5]).numpy(), a[0])
    assert torch.equal(torch.random.get_rng_state(), before)


def test_multinomial_without_replacement_draws_distinct_indices():
    p = np.array([[0.1, 0.0, 0.6, 0.3], [1., 1., 1., 1.]], 'float32')
    for P in (ref, port):
        out = P.multinomial(P.to_tensor(p), 3).numpy()
        assert out.shape == (2, 3)
        assert all(len(set(row)) == 3 for row in out)
        assert 1 not in out[0]


# ---- what numpy() and repr() give back ---------------------------------------

def test_bfloat16_numpy_is_float32_with_the_reference_values():
    """numpy() of bfloat16 returns float32 (every bfloat16 is exact in
    float32); the reference returns an ml_dtypes array of the same
    values."""
    a = cases.f(3, 4)
    r = ref.to_tensor(a).astype('bfloat16')
    t = port.to_tensor(a).astype('bfloat16')
    assert t.dtype == port.bfloat16
    got = t.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(r.numpy(), np.float32))
    # a bfloat16 reference array carries over
    back = port.to_tensor(r.numpy())
    assert back.dtype == port.bfloat16
    np.testing.assert_array_equal(back.numpy(), got)


@pytest.mark.parametrize('value,kw', [
    (np.array([1.5, 2.0], 'float32'), {}),
    (np.arange(6, dtype='int64').reshape(2, 3), {}),
    (np.array([True, False]), {}),
    (np.array([[0.123456, -7.0]], 'float32'), {'stop_gradient': False}),
    (np.float32(3.25), {}),
])
def test_repr_is_the_reference_repr(value, kw):
    assert repr(port.to_tensor(value, **kw)) == repr(ref.to_tensor(value,
                                                                   **kw))


def test_numpy_is_a_copy():
    x = port.to_tensor(np.zeros(3, 'float32'))
    a = x.numpy()
    a[0] = 5
    assert x.numpy()[0] == 0


def test_bool_stays_bool_where_the_reference_gives_int32():
    """Known, deliberate difference: ``clone``, ``add_n`` and
    ``masked_select_dense`` of bool keep bool (Paddle's documented dtype),
    where the reference's ``x + 0`` gives int32."""
    b = np.array([True, False, True])
    for P, want in ((port, 'bool'), (ref, 'int32')):
        x = P.to_tensor(b)
        for out in (P.clone(x), P.add_n([x, x]), P.masked_select_dense(x, x)):
            assert cases.dtype_name(out.dtype) == want
            assert tuple(out.shape) == (3,)
    np.testing.assert_array_equal(port.add_n([port.to_tensor(b)] * 2).numpy(),
                                  b)


def test_nonzero_of_a_0d_tensor_has_no_index_columns():
    """Known, deliberate difference: ``nonzero`` of a true 0-d tensor has
    shape [1, 0] (one hit, no axes to index), the reference's [1, 1]
    (numpy's rule for 0-d input)."""
    t = np.array(True)
    assert tuple(port.nonzero(port.to_tensor(t)).shape) == (1, 0)
    assert tuple(ref.nonzero(ref.to_tensor(t)).shape) == (1, 1)
    assert tuple(port.nonzero(port.to_tensor(np.array(False))).shape) == (0, 0)
