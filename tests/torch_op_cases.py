"""One table of eager op cases, run through either package.

Each case calls the Paddle API of a module ``P`` (``paddle_tpu`` or
``paddle_tpu_torch``) on tensors made from fixed numpy inputs. The CPU
test (``tests/test_torch_tensor_ops.py``) holds the port against the JAX
package case by case; ``chip_smoke.py`` phase 20 holds the port on the
card against the port on the CPU. Imports numpy only.

Tolerances (f32): 'ew' cases (elementwise) rtol 1e-5 / atol 1e-6; 'red'
cases (reductions, matmul, linalg, and invariants of decompositions whose
signs and order the solver picks) 1e-4. Integer and bool outputs are
equal; dtypes and shapes are equal.
"""
import numpy as np

TOL = {'ew': (1e-5, 1e-6), 'red': (1e-4, 1e-4)}

_R = np.random.RandomState(0)


def f(*shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, shape).astype('float32')


def pos(*shape):
    return f(*shape, lo=0.5, hi=2.0)


def unit(*shape):
    return f(*shape, lo=-0.9, hi=0.9)


def i32(*shape, lo=-5, hi=6):
    return _R.randint(lo, hi, shape).astype('int32')


def nz32(*shape):
    a = i32(*shape, lo=1, hi=6)
    return a * np.where(_R.rand(*shape) > 0.5, 1, -1).astype('int32')


def boo(*shape):
    return _R.rand(*shape) > 0.5


def spd(n):
    a = f(n, n)
    return (a @ a.T + n * np.eye(n)).astype('float32')


def well(n):
    return (f(n, n) + 3 * np.eye(n)).astype('float32')


class Case:
    """``call(P, *tensors)`` on ``inputs`` (numpy arrays become
    ``P.to_tensor`` tensors; anything else passes as it is)."""

    def __init__(self, name, call, inputs, kind='ew'):
        self.name, self.call, self.inputs, self.kind = name, call, inputs, kind

    def run(self, P):
        args = [P.to_tensor(a) if isinstance(a, np.ndarray) else a
                for a in self.inputs]
        return self.call(P, *args)

    def __repr__(self):
        return self.name


def dtype_name(dt):
    """'float32', 'int32', 'bool', ... for a numpy or a torch dtype."""
    return getattr(dt, 'name', None) or str(dt).replace('torch.', '')


def flatten(out):
    """A case's result as [(dtype name, shape, numpy values)]."""
    if isinstance(out, (list, tuple)) and not (
            out and all(isinstance(o, (int, float, bool)) for o in out)):
        return [r for o in out for r in flatten(o)]
    if hasattr(out, 'numpy') and hasattr(out, 'dtype'):
        return [(dtype_name(out.dtype), tuple(out.shape),
                 np.asarray(out.numpy()))]
    return [('py', (), np.asarray(out))]


def compare(case, got, want):
    """Largest error of ``got`` against ``want`` (both ``flatten``ed);
    raises AssertionError on a mismatch in count, dtype, shape or value."""
    rtol, atol = TOL[case.kind]
    assert len(got) == len(want), (case, len(got), len(want))
    worst = 0.0
    for (gd, gs, gv), (wd, ws, wv) in zip(got, want):
        assert gd == wd, f'{case}: dtype {gd} != {wd}'
        assert gs == ws, f'{case}: shape {gs} != {ws}'
        if gv.dtype.kind in 'biuO' or wv.dtype.kind in 'biuO' or \
                gd == 'py' and gv.dtype.kind not in 'fc':
            np.testing.assert_array_equal(gv, wv, err_msg=str(case))
            continue
        gv64, wv64 = gv.astype(np.complex128), wv.astype(np.complex128)
        np.testing.assert_allclose(gv64, wv64, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=str(case))
        fin = np.isfinite(gv64) & np.isfinite(wv64)
        if fin.any():
            worst = max(worst, float(np.abs(gv64[fin] - wv64[fin]).max()))
    return worst


C = []


def case(name, call, inputs, kind='ew'):
    C.append(Case(name, call, inputs, kind))


# ---- math: unary ------------------------------------------------------------
_DOMAIN = {'acos': unit, 'asin': unit, 'atanh': unit, 'erfinv': unit,
           'acosh': lambda *s: pos(*s) + 1, 'log': pos, 'log2': pos,
           'log10': pos, 'log1p': pos, 'sqrt': pos, 'rsqrt': pos,
           'reciprocal': pos, 'digamma': pos, 'lgamma': pos}
for _n in ['abs', 'acos', 'asin', 'atan', 'acosh', 'asinh', 'atanh', 'ceil',
           'cos', 'cosh', 'exp', 'expm1', 'floor', 'log', 'log2', 'log10',
           'log1p', 'neg', 'reciprocal', 'round', 'rsqrt', 'sign', 'sin',
           'sinh', 'sqrt', 'square', 'tan', 'tanh', 'erf', 'erfinv',
           'digamma', 'lgamma', 'angle', 'conj', 'trunc', 'frac', 'sigmoid',
           'rad2deg', 'deg2rad', 'log_']:
    case(_n, lambda P, x, _n=_n: getattr(P, _n)(x), [_DOMAIN.get(_n, f)(3, 4)])
for _n in ['abs', 'neg', 'sign', 'square', 'exp', 'sqrt', 'floor', 'ceil',
           'round', 'trunc', 'sin']:
    case(f'{_n}_int', lambda P, x, _n=_n: getattr(P, _n)(x),
         [i32(3, 4, lo=0) if _n == 'sqrt' else i32(3, 4)])
case('unary_special', lambda P, x: [P.exp(x), P.log(x), P.sqrt(x)],
     [np.array([0., -1., np.inf, -np.inf, np.nan, 1e-30], 'float32')])

# ---- math: binary -------------------------------------------------------------
_BIN = ['add', 'subtract', 'multiply', 'divide', 'floor_divide', 'mod',
        'remainder', 'floor_mod', 'pow', 'maximum', 'minimum', 'fmax', 'fmin',
        'atan2', 'logaddexp']
for _n in _BIN:
    _y = pos(3, 4) if _n in ('floor_divide', 'mod', 'remainder', 'floor_mod',
                             'divide') else f(3, 4)
    case(_n, lambda P, x, y, _n=_n: getattr(P, _n)(x, y),
         [pos(3, 4) if _n == 'pow' else f(3, 4), _y])
    case(f'{_n}_bcast', lambda P, x, y, _n=_n: getattr(P, _n)(x, y),
         [pos(2, 3, 4) if _n == 'pow' else f(2, 3, 4), pos(4)])
for _n in ['add', 'subtract', 'multiply', 'divide', 'floor_divide', 'mod',
           'maximum', 'minimum', 'bitwise_and', 'bitwise_or', 'bitwise_xor',
           'gcd', 'lcm']:
    case(f'{_n}_int', lambda P, x, y, _n=_n: getattr(P, _n)(x, y),
         [i32(3, 4), nz32(3, 4)])
case('pow_int', lambda P, x: [P.pow(x, 2), x ** 3, x ** 2.0],
     [i32(3, 4)])
for _n in ['bitwise_and', 'bitwise_or', 'bitwise_xor']:
    case(f'{_n}_bool', lambda P, x, y, _n=_n: getattr(P, _n)(x, y),
         [boo(3, 4), boo(3, 4)])
case('bitwise_not', lambda P, x, y: [P.bitwise_not(x), P.bitwise_not(y)],
     [i32(3, 4), boo(3, 4)])
case('mixed_int_float', lambda P, x, y: [x + y, x * y, P.maximum(x, y)],
     [i32(3, 4), f(3, 4)])
case('weak_scalars', lambda P, x, y, b: [
    x * 1.5, x + 2, 2 - x, x / 2, x // 2, y * 2.0, 2.0 ** y,
    1 - y, y / 3, b + 1, b + b, b * 2, b + 1.0, x % 3, -x, abs(x)],
    [i32(3, 4), f(3, 4), boo(3, 4)])
case('f16_strong_0d', lambda P, x: [x * P.to_tensor(2.0), x * 2.0,
                                    (x * 2.0).astype('float32')],
     [f(3, 4).astype('float16')])
case('operators', lambda P, x, y: [
    x + y, x - y, x * y, x / y, x // y, x % y, x ** 2, x @ y.T,
    x == y, x != y, x < y, x <= y, x > y, x >= y, 1 + x, 3 * y],
    [f(3, 4), pos(3, 4)])
case('operators_int', lambda P, x, y: [x & y, x | y, x ^ y, ~x, x == 1],
     [i32(3, 4), nz32(3, 4)])
case('scale', lambda P, x: [
    P.scale(x, 2.0, 1.0), P.scale(x, 2.0, 1.0, bias_after_scale=False),
    P.scale(x, 0.5, act='relu'), P.scale(x, 0.5, act='tanh')], [f(3, 4)])
case('clip', lambda P, x: [P.clip(x, -0.5, 0.5), P.clip(x, min=0.1),
                           P.clip(x, max=0.1)], [f(3, 4)])
case('clip_int', lambda P, x: P.clip(x, -2, 2), [i32(3, 4)])
case('stanh', lambda P, x: P.stanh(x), [f(3, 4)])
case('multiplex', lambda P, a, b, i: P.multiplex([a, b], i),
     [f(4, 3), f(4, 3), np.array([[0], [1], [1], [0]], 'int32')])
case('sum', lambda P, x: [P.sum(x), P.sum(x, axis=1), P.sum(x, axis=[0, 2]),
                          P.sum(x, axis=-1, keepdim=True),
                          P.sum(x, dtype='float32')], [f(2, 3, 4)], 'red')
case('sum_int_bool', lambda P, x, b: [P.sum(x), P.sum(x, 1), P.sum(b),
                                      P.sum(b, 0)], [i32(3, 4), boo(3, 4)])
case('nansum', lambda P, x: [P.nansum(x), P.nansum(x, axis=1)],
     [np.where(boo(3, 4), f(3, 4), np.nan).astype('float32')], 'red')
case('prod', lambda P, x: [P.prod(x), P.prod(x, 1), P.prod(x, [0, 2]),
                           P.prod(x, 1, keepdim=True)], [pos(2, 3, 4)],
     'red')
case('prod_int', lambda P, x: [P.prod(x), P.prod(x, 0)], [i32(3, 3)])
for _n in ['max', 'min', 'amax', 'amin']:
    case(_n, lambda P, x, _n=_n: [
        getattr(P, _n)(x), getattr(P, _n)(x, axis=1),
        getattr(P, _n)(x, axis=[0, 2], keepdim=True)], [f(2, 3, 4)])
    case(f'{_n}_int', lambda P, x, _n=_n: getattr(P, _n)(x, axis=0),
         [i32(3, 4)])
case('logsumexp', lambda P, x: [P.logsumexp(x), P.logsumexp(x, axis=1),
                                P.logsumexp(x, axis=1, keepdim=True)],
     [f(3, 4)], 'red')
case('cumsum', lambda P, x: [P.cumsum(x), P.cumsum(x, axis=1),
                             P.cumsum(x, axis=0, dtype='float32')],
     [f(3, 4)], 'red')
case('cumsum_int_bool', lambda P, x, b: [P.cumsum(x, 1), P.cumsum(b)],
     [i32(3, 4), boo(3, 4)])
case('cumprod', lambda P, x: [P.cumprod(x, dim=1), P.cumprod(x)],
     [pos(3, 4)], 'red')
case('matmul', lambda P, a, b, c: [
    P.matmul(a, b), P.matmul(a, a, transpose_y=True),
    P.matmul(b, b, transpose_x=True), P.matmul(c, b), P.matmul(a, b[:, 0]),
    P.mm(a, b)], [f(3, 4), f(4, 5), f(2, 3, 4)], 'red')
case('matmul_int', lambda P, a, b, v: [
    P.matmul(a, b), P.mm(a, b), P.matmul(v, b), P.matmul(a, b[:, 0]),
    P.bmm(a[None], b[None]), P.mv(a, b[:, 0]), a @ b, P.matmul(a > 0, b > 0)],
    [i32(3, 4), i32(4, 5), i32(4)])
case('inner_outer_dot', lambda P, a, b, m: [
    P.inner(a, b), P.outer(a, b), P.dot(a, b), P.dot(m, m)],
    [f(4), f(4), f(3, 4)], 'red')
case('addmm', lambda P, i, x, y: [P.addmm(i, x, y),
                                  P.addmm(i, x, y, beta=0.5, alpha=2.0)],
     [f(3, 5), f(3, 4), f(4, 5)], 'red')
case('multiply_fn', lambda P, x, y: P.multiply_(x, y), [f(3, 4), f(3, 4)])
case('trace', lambda P, x, i: [P.trace(x), P.trace(x, offset=1),
                               P.trace(i)], [f(4, 4), i32(3, 3)], 'red')
case('isfinite_isinf_isnan', lambda P, x: [P.isfinite(x), P.isinf(x),
                                           P.isnan(x)],
     [np.array([1., np.inf, -np.inf, np.nan, 0.], 'float32')])
case('all_any', lambda P, b, x: [
    P.all(b), P.any(b), P.all(b, axis=1), P.any(b, axis=0, keepdim=True),
    P.all(x), P.any(x, axis=1)], [boo(3, 4), i32(3, 4)])
case('broadcast_shape', lambda P, x, y: [P.broadcast_shape_op(x, y),
                                         P.broadcast_shape([3, 1], [1, 4])],
     [f(3, 1), f(1, 4)])
case('increment', lambda P, x: [P.increment(x), P.increment(x, 2.5)],
     [f(3, 4)])
case('lerp', lambda P, x, y, w: [P.lerp(x, y, 0.3), P.lerp(x, y, w)],
     [f(3, 4), f(3, 4), unit(3, 4)])
case('diff', lambda P, x, p: [
    P.diff(x), P.diff(x, n=2, axis=0), P.diff(x, prepend=p, axis=0)],
    [f(3, 4), f(1, 4)])
case('heaviside', lambda P, x, y: P.heaviside(x, y),
     [np.array([-1., 0., 2., 0.], 'float32'), f(4)])
case('divide_int_aware', lambda P, x, y: P.divide_int_aware(x, y),
     [i32(3, 4), nz32(3, 4)])

# ---- manipulation ---------------------------------------------------------------
case('reshape', lambda P, x: [
    P.reshape(x, [6, 4]), P.reshape(x, [-1, 2]), P.reshape_(x, [4, 6]),
    x.reshape([2, 12])], [f(2, 3, 4)])
case('flatten', lambda P, x: [P.flatten(x), P.flatten(x, 1),
                              P.flatten(x, 0, 1), P.flatten_(x.clone())],
     [f(2, 3, 4)])
case('transpose_axes', lambda P, x: [
    P.transpose(x, [2, 0, 1]), P.moveaxis(x, 0, -1), P.swapaxes(x, 0, 2),
    x.T, P.transpose_last2(x)], [f(2, 3, 4)])
case('squeeze_unsqueeze', lambda P, x: [
    P.squeeze(x), P.squeeze(x, 0), P.squeeze(x, [0, 2]), P.squeeze(x, 1),
    P.squeeze_(x, 2), P.unsqueeze(x, 1), P.unsqueeze(x, [0, 2]),
    P.unsqueeze_(x, -1)], [f(1, 3, 1, 4)])
case('concat_stack', lambda P, x, y, i: [
    P.concat([x, y], axis=1), P.concat([x, y]), P.stack([x, y]),
    P.stack([x, y], axis=2), P.concat([x, i], axis=0)],
    [f(2, 3), f(2, 3), i32(2, 3)])
case('split_chunk_unbind', lambda P, x: [
    P.split(x, 3, axis=1), P.split(x, [2, -1], axis=2),
    P.split(x, [1, 2], axis=1), P.chunk(x, 2, axis=2), P.unbind(x, 1),
    P.unstack(x, 0)], [f(2, 3, 4)])
case('tile_expand', lambda P, x, y: [
    P.tile(x, [2, 1]), P.tile(x, [2, 1, 2]), P.expand(x, [2, 3, 4]),
    P.expand(x, [-1, 4]), P.expand_as(x, y), P.broadcast_to(x, [2, 3, 4]),
    P.broadcast_tensors([x, y])], [f(3, 1), f(3, 4)])
case('flip_roll_rot', lambda P, x: [
    P.flip(x, [1]), P.flip(x, 0), P.reverse(x, [0, 2]), P.roll(x, 1),
    P.roll(x, 2, axis=1), P.roll(x, [1, -1], axis=[0, 2]), P.rot90(x),
    P.rot90(x, 2, axes=[1, 2])], [f(2, 3, 4)])
_IDX = np.array([0, 5, -1, -7, 2], 'int32')     # in and out of range
case('gather', lambda P, x, i, j: [
    P.gather(x, j, axis=1), P.gather(x, i[:2], axis=0), P.gather(x, i, 1)],
    [f(3, 4), np.array([1, 0], 'int32'), _IDX])
case('gather_int_bool', lambda P, x, b, i: [P.gather(x, i, axis=1),
                                            P.gather(b, i, axis=1)],
     [i32(3, 4), boo(3, 4), _IDX])
case('index_select', lambda P, x, i: [P.index_select(x, i, axis=1),
                                      P.index_select(x, i[:3])],
     [f(3, 4), _IDX])
case('gather_nd', lambda P, x, i: [P.gather_nd(x, i), P.gather_nd(x, i[:, :1])],
     [f(3, 4), np.array([[0, 5], [7, 1], [-1, -1], [1, 2]], 'int32')])
case('take_along_axis', lambda P, x, i: [P.take_along_axis(x, i, 1),
                                         P.take_along_axis(x, i[:1], 1)],
     [f(3, 4), np.array([[0, 5, -1, -9]] * 3, 'int32')])
case('index_sample', lambda P, x, i: P.index_sample(x, i),
     [f(3, 4), np.array([[0, 5], [1, -1], [2, -9]], 'int32')])
case('scatter', lambda P, x, i, u: [
    P.scatter(x, i, u), P.scatter(x, i, u, overwrite=False)],
    [f(4, 3), np.array([0, 5, -1], 'int32'), f(3, 3)])
case('scatter_nd_add', lambda P, x, i, u: [P.scatter_nd_add(x, i, u),
                                           P.scatter_nd(i, u, [3, 4])],
     [f(3, 4), np.array([[0, 5], [7, 1], [-1, -1], [1, 2]], 'int32'),
      f(4)])
case('scatter_nd_rows', lambda P, x, i, u: P.scatter_nd_add(x, i, u),
     [f(3, 4), np.array([[1], [1], [3]], 'int32'), f(3, 4)])
case('put_along_axis', lambda P, x, i, v: [
    P.put_along_axis(x, i, 9.0, 1), P.put_along_axis(x, i, v, 1, 'add'),
    P.put_along_axis(x, i, v, 1, 'multiply')],
    [f(3, 4), np.array([[0], [5], [-1]], 'int32'), f(3, 1)])
case('slice', lambda P, x: [
    P.slice(x, [0, 2], [0, 1], [2, 3]), P.slice(x, [1], [-2], [10000]),
    P.strided_slice(x, [1], [0], [3], [2]),
    P.strided_slice(x, [2], [3], [0], [-1]),
    P.strided_slice(x, [0, 2], [1, -1], [2, -5], [1, -2])], [f(2, 3, 4)])
case('unique', lambda P, x: [
    P.unique(x), P.unique(x, return_index=True, return_inverse=True,
                          return_counts=True),
    P.unique_consecutive(x), P.unique_consecutive(
        x, return_inverse=True, return_counts=True),
    P.unique_consecutive_vals(x)],
    [np.array([3, 1, 1, 2, 3, 3, 0], 'int32')])
case('unique_float', lambda P, x: P.unique(x),
     [np.array([0.5, -1., 0.5, 2.], 'float32')])
case('repeat_interleave', lambda P, x: [P.repeat_interleave(x, 2, axis=1),
                                        P.repeat_interleave(x, 3)],
     [f(2, 3)])
case('complex_parts', lambda P, x: [
    P.as_complex(x), P.real(P.as_complex(x)), P.imag(P.as_complex(x)),
    P.as_real(P.as_complex(x)), P.conj(P.as_complex(x)),
    P.abs(P.as_complex(x)), P.angle(P.as_complex(x))], [f(3, 2)])
case('real_imag_float', lambda P, x: [P.real(x), P.imag(x)], [f(3, 2)])
case('cast', lambda P, x, i: [
    P.cast(x, 'int32'), P.cast(x, 'bool'), P.cast(i, 'float32'),
    P.cast(x, 'int64'), P.cast(x, 'float64'), x.astype('float16'),
    x.cast('bfloat16').astype('float32'), P.cast(i, 'bool')],
    [f(3, 4) * 3, i32(3, 4)])
case('crop', lambda P, x: [P.crop(x, [2, 2], [1, 1]), P.crop(x, [1, 3]),
                           P.crop_tensor(x, [2, 2], [0, 2])], [f(3, 4)])
case('shard_index', lambda P, x: P.shard_index(x, 20, 2, 1),
     [np.array([[1], [6], [12], [19]], 'int32')])
case('tensordot', lambda P, x, y: [P.tensordot(x, y, 1),
                                   P.tensordot(x, y, [[1], [0]])],
     [f(3, 4), f(4, 5)], 'red')
case('builtins_helpers', lambda P: [P.builtins_sum([1, 2, 3]),
                                    P.builtins_min(4, 2)], [])

# ---- logic -----------------------------------------------------------------------
for _n in ['equal', 'not_equal', 'greater_than', 'greater_equal',
           'less_than', 'less_equal']:
    case(_n, lambda P, x, y, i, _n=_n: [
        getattr(P, _n)(x, y), getattr(P, _n)(x, 0.5), getattr(P, _n)(i, 1),
        getattr(P, _n)(i, x)],
        [np.round(f(3, 4)), np.round(f(3, 4)), i32(3, 4)])
for _n in ['logical_and', 'logical_or', 'logical_xor']:
    case(_n, lambda P, a, b, i, _n=_n: [getattr(P, _n)(a, b),
                                        getattr(P, _n)(i, a)],
         [boo(3, 4), boo(3, 4), i32(3, 4)])
case('logical_not', lambda P, a, i: [P.logical_not(a), P.logical_not(i)],
     [boo(3, 4), i32(3, 4)])
case('close_equal', lambda P, x, y: [
    P.equal_all(x, x), P.equal_all(x, y), P.allclose(x, x + 1e-9),
    P.allclose(x, y), P.isclose(x, y, atol=0.5), P.is_empty(x),
    P.is_tensor(x), P.is_tensor(1.0)], [f(3, 4), f(3, 4)])

# ---- search ----------------------------------------------------------------------
_TIES = np.array([[3., 1., 3., 2., 1.], [0., 0., 5., 5., 0.]], 'float32')
case('argmax_argmin', lambda P, x, t: [
    P.argmax(x), P.argmax(x, axis=1), P.argmin(x, axis=0, keepdim=True),
    P.argmax(t, axis=1), P.argmin(t, axis=1), P.argmax(x, keepdim=True)],
    [f(3, 4), _TIES])
case('argsort_sort', lambda P, x, t: [
    P.argsort(x, axis=1), P.argsort(x, axis=0, descending=True),
    P.sort(x, axis=1), P.sort(x, axis=0, descending=True),
    P.argsort(t), P.argsort(t, descending=True)], [f(3, 4), _TIES])
case('topk', lambda P, x, t: [
    P.topk(x, 2), P.topk(x, 2, axis=0, largest=False), P.topk(t, 3),
    P.topk(t, 2, largest=False)], [f(3, 4), _TIES])
case('kthvalue', lambda P, x: [P.kthvalue(x, 2), P.kthvalue(x, 1, axis=0,
                                                           keepdim=True)],
     [f(3, 4)])
case('where', lambda P, c, x, y: [
    P.where(c, x, y), P.where(c, x, 0.0), P.where(x > 0, x, P.zeros_like(x))],
    [boo(3, 4), f(3, 4), f(3, 4)])
case('nonzero', lambda P, x: [P.nonzero(x), P.nonzero(x, as_tuple=True)],
     [i32(3, 4, lo=0, hi=2)])
case('masked_select', lambda P, x, m: [P.masked_select(x, m),
                                       P.masked_select_dense(x, m)],
     [f(3, 4), boo(3, 4)])
case('searchsorted', lambda P, s, v, s2, v2: [
    P.searchsorted(s, v), P.searchsorted(s, v, right=True),
    P.searchsorted(s2, v2)],
    [np.array([0., 1., 1., 3., 5.], 'float32'),
     np.array([[1., 4., -1.], [5., 0., 2.]], 'float32'),
     np.sort(f(2, 5), axis=1), f(2, 3)])
case('index_put', lambda P, x, i, j, v: [
    P.index_put(x, [i, j], v), P.index_put(x, [i, j], v, accumulate=True),
    P.index_put(x, [i], P.ones([4]))],
    [f(3, 4), np.array([0, 2, 5], 'int32'), np.array([1, -1, 0], 'int32'),
     f(3)])

# ---- stat ------------------------------------------------------------------------
case('mean_std_var', lambda P, x, i: [
    P.mean(x), P.mean(x, axis=1), P.mean(x, axis=[0, 1], keepdim=True),
    P.std(x), P.std(x, axis=0, unbiased=False), P.var(x, axis=1),
    P.var(x, unbiased=False), P.mean(i)], [f(3, 4), i32(3, 4)], 'red')
case('median_quantile', lambda P, x, n: [
    P.median(x), P.median(x, axis=1), P.median(x, axis=0, keepdim=True),
    P.quantile(x, 0.3), P.quantile(x, [0.25, 0.5], axis=1),
    P.quantile(x, 0.9, axis=0, keepdim=True), P.nanmedian(n),
    P.nanmedian(n, axis=1), P.nanquantile(n, 0.4, axis=1),
    P.nanmean(n), P.nanmean(n, axis=0), P.median(n, axis=1)],
    [f(4, 6), np.where(boo(4, 6), f(4, 6), np.nan).astype('float32')],
    'red')
case('numel_mode', lambda P, x, m: [P.numel(x), x.numel(), P.mode(m),
                                    P.mode(m, axis=0, keepdim=True)],
     [f(3, 4), np.array([[1., 2., 2., 3.], [4., 4., 1., 1.],
                         [0., 1., 2., 3.]], 'float32')])

# ---- linalg ----------------------------------------------------------------------
case('norm', lambda P, x: [
    P.norm(x), P.norm(x, axis=1), P.norm(x, p=1, axis=1),
    P.norm(x, p=float('inf'), axis=0), P.norm(x, p=float('-inf'), axis=1),
    P.norm(x, p=0, axis=1), P.norm(x, p=3, axis=[0, 1]),
    P.norm(x, p=2, axis=1, keepdim=True), P.linalg.norm(x)], [f(3, 4)],
    'red')
case('dist', lambda P, x, y: [P.dist(x, y), P.dist(x, y, float('inf')),
                              P.dist(x, y, 0), P.dist(x, y, 1)],
     [f(3, 4), f(3, 4)], 'red')
case('solve_family', lambda P, a, s, b: [
    P.inverse(a), P.inv(a), P.linalg.inv(a), P.det(a), P.slogdet(a),
    P.matrix_power(a, 3), P.matrix_power(a, -1), P.solve(a, b),
    P.cholesky(s), P.cholesky(s, upper=True),
    P.cholesky_solve(b, P.cholesky(s)), P.cond(a), P.pinv(a),
    P.pinv(s, hermitian=True)], [well(4), spd(4), f(4, 2)], 'red')
case('triangular_solve', lambda P, a, b: [
    P.triangular_solve(P.triu(a), b), P.triangular_solve(P.tril(a), b,
                                                          upper=False),
    P.triangular_solve(P.triu(a), b, transpose=True),
    P.triangular_solve(P.triu(a), b, unitriangular=True)],
    [well(4), f(4, 3)], 'red')
case('matrix_rank', lambda P, a, d: [P.matrix_rank(a), P.matrix_rank(d),
                                     P.matrix_rank(a, 0.9)],
     [well(4), np.outer(f(4), f(4)).astype('float32')])
case('svd_qr_invariants', lambda P, x: [
    (lambda u, s, v: [s, P.matmul(u * s, v.T),
                      P.matmul(u.T, u)])(*P.svd(x)),
    (lambda q, r: [P.matmul(q, r), P.matmul(q.T, q), P.abs(r)])(*P.qr(x)),
    (lambda q, r: [P.matmul(q, r), P.abs(r)])(*P.qr(x, mode='complete'))],
    [f(5, 3)], 'red')
case('eigh', lambda P, s: [
    P.eigh(s)[0], P.eigvalsh(s), P.eigvalsh(s, UPLO='U'),
    (lambda w, v: [P.matmul(s, v) - v * w, P.matmul(v.T, v)])(*P.eigh(s))],
    [spd(4)], 'red')
case('eig', lambda P, a: [
    P.sort(P.real(P.eigvals(a))), P.sort(P.imag(P.eigvals(a))),
    (lambda w, v: P.abs(P.matmul(P.cast(a, 'complex64'), v)
                        - v * w))(*P.eig(a))],
    [spd(4)], 'red')
case('lstsq', lambda P, a, b, v: [P.lstsq(a, b), P.lstsq(a, v)],
     [f(6, 3), f(6, 2), f(6)], 'red')
case('cross_bmm_mv', lambda P, x, y, a, b, m, v: [
    P.cross(x, y), P.cross(x, y, axis=1), P.bmm(a, b), P.mv(m, v),
    P.multi_dot([m, m.T, m])], [f(3, 3), f(3, 3), f(2, 3, 4), f(2, 4, 5),
                                f(3, 4), f(4)], 'red')
case('histogram_bincount', lambda P, x, i, w: [
    P.histogram(x, bins=5), P.histogram(x, bins=4, min=-1, max=1),
    P.bincount(i), P.bincount(i, weights=w), P.bincount(i, minlength=9)],
    [f(20), i32(8, lo=0, hi=6), pos(8)])
case('corrcoef_cov', lambda P, x, fw, aw: [
    P.corrcoef(x), P.corrcoef(x, rowvar=False), P.cov(x),
    P.cov(x, rowvar=False, ddof=False), P.cov(x, fweights=fw, aweights=aw)],
    [f(3, 5), np.array([1, 2, 1, 3, 1], 'int32'), pos(5)], 'red')

# ---- creation ----------------------------------------------------------------------
case('fill_creation', lambda P: [
    P.ones([2, 3]), P.zeros([4], 'int32'), P.full([2, 2], 7),
    P.full([2], 1.5, 'float16'), P.full([2], True, 'bool'),
    P.empty([2, 3]), P.eye(3), P.eye(2, 4, 'int32'), P.ones(3),
    P.zeros([2, 2], 'int64')], [])
case('like_creation', lambda P, x: [
    P.ones_like(x), P.zeros_like(x, 'int32'), P.full_like(x, 3.0),
    P.empty_like(x), x.ones_like(), x.full_like(-1.0)], [f(2, 3)])
case('ranges', lambda P: [
    P.arange(5), P.arange(2, 9, 3), P.arange(0.5, 3), P.arange(0, 1, 0.25),
    P.arange(5, dtype='float32'), P.linspace(0, 1, 5),
    P.linspace(-2, 3, 7, 'float32'), P.logspace(0, 2, 4),
    P.logspace(1, 3, 3, base=2.0)], [], 'red')
case('diag_tri', lambda P, v, m: [
    P.diag(v), P.diag(v, 1), P.diag(v, -1, padding_value=9.0), P.diag(m),
    P.diag(m, 1), P.diagflat(v), P.diagflat(m, -1), P.tril(m), P.triu(m),
    P.tril(m, -1), P.triu(m, 1), m.tril(), m.triu(1), P.diagonal(m),
    P.diagonal(m, 1), m.diagonal()], [f(3), f(3, 4)])
case('meshgrid_kron_complex', lambda P, a, b, m: [
    P.meshgrid(a, b), P.meshgrid([a, b]), P.kron(m, m),
    P.complex(a, a * 2)], [f(3), f(2), f(2, 2)])
case('assign_clone_tolist', lambda P, x: [
    P.assign(x), P.clone(x), x.clone(), P.tolist(x), x.tolist()],
    [f(2, 2)])
case('to_tensor', lambda P: [
    P.to_tensor([1, 2, 3]), P.to_tensor([1.5, 2.0]),
    P.to_tensor(np.arange(4)), P.to_tensor(np.ones(3)),
    P.to_tensor(3.0), P.to_tensor(True), P.to_tensor([[1, 2]], 'float32'),
    P.to_tensor(np.arange(3, dtype='uint8')),
    P.to_tensor(np.ones(2, 'float32'), dtype='float16')], [])

# ---- einsum, attribute, compat ---------------------------------------------------
case('einsum', lambda P, a, b, c, s: [
    P.einsum('ij,jk->ik', a, b), P.einsum('bij->bji', c),
    P.einsum('ii->', s), P.einsum('ij,ij->i', [a, a])],
    [f(3, 4), f(4, 5), f(2, 3, 4), f(3, 3)], 'red')
case('attributes', lambda P, x, i, c: [
    P.shape(x), P.rank(x), x.rank(), P.is_complex(x), P.is_complex(c),
    P.is_floating_point(x), P.is_floating_point(i), P.is_integer(i),
    P.is_integer(x), x.shape, x.ndim, x.size, x.dim(), len(x)],
    [f(2, 3, 4), i32(2), f(2, 2).astype('complex64')])
case('add_n_t', lambda P, x, y, v: [
    P.add_n([x, y]), P.add_n([x, y, x]), P.add_n(x), x.add_n(), P.t(x),
    x.t(), P.t(v)], [f(3, 4), f(3, 4), f(4)])

# ---- in-place ops (rebinding; the results are the rebound tensors) -----------------
for _n, _dom, _args in [
        ('add_', f, (1.5,)), ('subtract_', f, (0.5,)), ('ceil_', f, ()),
        ('floor_', f, ()), ('round_', f, ()), ('exp_', f, ()),
        ('sqrt_', pos, ()), ('rsqrt_', pos, ()), ('reciprocal_', pos, ()),
        ('clip_', f, (-0.5, 0.5)), ('scale_', f, (2.0, 1.0)),
        ('tanh_', f, ())]:
    case(_n, lambda P, x, _n=_n, _a=_args: getattr(P, _n)(x, *_a),
         [_dom(3, 4)])
case('inplace_methods', lambda P, x, y: [
    x.clone().add_(y), x.clone().subtract_(y), x.clone().multiply_(y),
    x.clone().divide_(y), x.clone().clip_(-0.3, 0.3), x.clone().scale_(3.0),
    x.clone().floor_(), x.clone().ceil_(), x.clone().round_(),
    x.clone().sqrt_(), x.clone().rsqrt_(), x.clone().reciprocal_(),
    x.clone().exp_(), x.clone().tanh_(), x.clone().zero_(),
    x.clone().fill_(2.5), x.clone().flatten_(),
    x.clone().scatter_(P.to_tensor(np.array([1], 'int32')),
                       P.ones([1, 4]))],
    [pos(3, 4), pos(3, 4)])


# ---- indexing ----------------------------------------------------------------------
def _setitems(P, x, v, m):
    out = []
    for item, val in [(1, 5.0), ((slice(None), 0), v[:3]), (m, 0.0),
                      ([0, 5], 1.0), ((Ellipsis, -1), v[0]),
                      (P.to_tensor(np.array([-1, 7], 'int32')), v),
                      ((slice(None, None, -1), 1), v[:3]),
                      ((P.to_tensor(np.array([0, 2], 'int32')),
                        P.to_tensor(np.array([1, 9], 'int32'))), 7.0)]:
        y = x.clone()
        y[item] = val
        out.append(y)
    return out


case('getitem', lambda P, x, i: [
    x[1], x[:, 2:4], x[-1, ::2], x[None, 1], x[..., 1], x[1:3, -1],
    x[x > 0.5], x[[0, 2]], x[i], x[i, 1], x[::-1], x[:, ::-2],
    x[P.to_tensor(np.array([[0], [2]], 'int32')), i[:2]],
    x[P.to_tensor(1)]], [f(3, 4), np.array([0, 5, -1, -7], 'int32')])
case('setitem', _setitems, [f(3, 4), f(4), boo(3, 4)])
case('iterate', lambda P, x: [r for r in x], [f(3, 2)])


# ---- edge cases the reference defines: 0-d and empty quantiles, special
# values, integer division by zero, a flat histogram range, non-symmetric
# input to the Hermitian solvers, bool and int32 promotions --------------------
_SPECIAL = np.array([np.nan, 0., -0., -1., -2., np.inf, -np.inf, 1.5],
                    'float32')
case('quantile_0d', lambda P, x: [
    P.median(x), P.nanmedian(x), P.quantile(x, 0.3), P.nanquantile(x, 0.3),
    x.median(), P.quantile(x, [0.2, 0.7])], [np.array(2.5, 'float32')])
case('quantile_empty_axis', lambda P, x: [
    P.median(x, axis=-1), P.nanmedian(x, axis=-1),
    P.quantile(x, 0.5, axis=-1), P.nanquantile(x, 0.25, axis=1)],
    [np.zeros((0, 3), 'float32')])
case('unary_special_values', lambda P, x: [
    P.sign(x), x.sign(), P.digamma(x), P.angle(x)], [_SPECIAL])
case('int_divmod_by_zero', lambda P, x, y, z, w: [
    P.floor_divide(x, y), P.mod(x, y), P.remainder(x, y),
    P.floor_mod(x, y), x // y, x % y, z // 0, z % 0,
    P.floor_divide(w, P.full_like(w, -1)), P.mod(w, P.full_like(w, -1))],
    [np.array([7, -7, 5, 0], 'int32'), np.array([2, 2, 0, 0], 'int32'),
     np.array([5, -5, 0, 7], 'int32'),
     np.array([-2 ** 31, 5, -6, 0], 'int32')])
case('histogram_flat_range', lambda P, x, y: [
    P.histogram(x, bins=4), P.histogram(y, bins=4, min=2, max=2)],
    [np.full(3, 2.5, 'float32'), np.array([1., 2., 3.], 'float32')])
case('heaviside_int', lambda P, x, y: P.heaviside(x, y),
     [np.array([-1, 0, 3], 'int32'), np.array([5, 6, 7], 'int32')])
case('hermitian_solvers_symmetrize', lambda P, x: [
    P.linalg.eigvalsh(x), P.linalg.eigh(x)[0], P.linalg.cholesky(x)],
    [np.array([[4., 1.], [3., 5.]], 'float32')], kind='red')
case('bool_promotions', lambda P, x, y, z: [
    P.abs(x), P.ceil(x), P.floor(x), P.trunc(x), P.argmax(x), P.argmin(x),
    P.floor_divide(y, z), P.mod(y, z), P.pow(y, z),
    P.floor_divide(y, x[:4]), P.mod(y, x[:4]), P.pow(y, y)],
    [np.array([False, True, True, False, True]),
     np.array([True, False, True, False]), np.array([True] * 4)])
case('int32_to_float_linalg', lambda P, x: [
    P.complex(x, x), P.linalg.svd(x)[1], P.abs(P.linalg.qr(x)[1]),
    P.linalg.pinv(x), P.linalg.cond(x)],
    [np.array([[2, 1], [1, 3]], 'int32')], kind='red')


# ---- fft and signal (ROADMAP step I's rest) --------------------------------------
case('fft_1d', lambda P, x, i: [
    P.fft.fft(x), P.fft.ifft(x), P.fft.fft(x, n=6, axis=0),
    P.fft.ifft(x, norm='ortho'), P.fft.rfft(x), P.fft.rfft(x, n=10),
    P.fft.irfft(P.fft.rfft(x)), P.fft.irfft(P.fft.rfft(x), n=9),
    P.fft.hfft(P.fft.rfft(x)), P.fft.ihfft(x), P.fft.fft(i),
    P.fft.rfft(x, norm='forward')], [f(3, 8), i32(4)], 'red')
case('fft_nd', lambda P, x: [
    P.fft.fft2(x), P.fft.ifft2(x), P.fft.fftn(x), P.fft.ifftn(x, axes=[0]),
    P.fft.rfft2(x), P.fft.irfft2(P.fft.rfft2(x)),
    P.fft.fft2(x, s=[4, 4], axes=(0, 1)), P.fft.fftn(x, s=[2, 6])],
    [f(2, 4, 6)], 'red')
case('fft_shift_freq', lambda P, x: [
    P.fft.fftshift(x), P.fft.ifftshift(x), P.fft.fftshift(x, axes=[1]),
    P.fft.fftfreq(8, 0.5), P.fft.rfftfreq(9), P.fft.fftfreq(5)],
    [f(3, 5)])
case('signal_frame_overlap_add', lambda P, x, y: [
    P.signal.frame(x, 4, 2), P.signal.frame(y, 3, 1),
    P.signal.overlap_add(P.signal.frame(x, 4, 2), 2),
    P.signal.overlap_add(f32_frames(P, y), 3)],
    [f(2, 12), f(10)], 'red')
case('signal_stft_istft', lambda P, x, w: [
    P.signal.stft(x, 16), P.signal.stft(x, 16, 4, 12, window=w),
    P.signal.stft(x, 8, center=False, onesided=False, normalized=True),
    P.signal.istft(P.signal.stft(x, 16), 16, length=64),
    P.signal.istft(P.signal.stft(x, 16, 4, 12, window=w), 16, 4, 12,
                   window=w),
    P.signal.stft(x, 16, pad_mode='constant')],
    [f(2, 64), pos(12)], 'red')


def f32_frames(P, y):
    """A [5, 4] frame stack from a 1-D signal of 10, for overlap_add."""
    return P.reshape(y[:8], [4, 2]).transpose([1, 0]).tile([3, 1])[:5]


# ---- random ops: shape, dtype, range and the moments of N draws ------------------
N = 100_000
RANDOM = {
    # name: (call, dtype, low, high, mean, std) over N draws
    'rand': (lambda P: P.rand([N]), 'float32', 0, 1, 0.5, 12 ** -0.5),
    'randn': (lambda P: P.randn([N]), 'float32', None, None, 0.0, 1.0),
    'standard_normal': (lambda P: P.standard_normal([N]), 'float32', None,
                        None, 0.0, 1.0),
    'normal': (lambda P: P.normal(2.0, 3.0, [N]), 'float32', None, None,
               2.0, 3.0),
    'uniform': (lambda P: P.uniform([N], min=-2.0, max=4.0), 'float32', -2,
                4, 1.0, 6 * 12 ** -0.5),
    'randint': (lambda P: P.randint(0, 10, [N]), 'int32', 0, 9, 4.5,
                (99 / 12) ** 0.5),
    'randint_like': (lambda P: P.randint_like(P.zeros([N], 'int32'), 3, 7),
                     'int32', 3, 6, 4.5, (15 / 12) ** 0.5),
    'randperm': (lambda P: P.randperm(N), 'int32', 0, N - 1, (N - 1) / 2,
                 ((N * N - 1) / 12) ** 0.5),
    'bernoulli': (lambda P: P.bernoulli(P.full([N], 0.3)), 'float32', 0, 1,
                  0.3, (0.21) ** 0.5),
    'poisson': (lambda P: P.poisson(P.full([N], 4.0)), 'float32', 0, None,
                4.0, 2.0),
    'multinomial': (lambda P: P.multinomial(
        P.to_tensor(np.array([0.1, 0.0, 0.6, 0.3], 'float32')), N, True),
        'int32', 0, 3, 0.1 * 0 + 0.6 * 2 + 0.3 * 3,
        (0.6 * 4 + 0.3 * 9 - 2.1 ** 2) ** 0.5),
    'exponential_': (lambda P: P.zeros([N]).exponential_(2.0), 'float32', 0,
                     None, 0.5, 0.5),
    'uniform_': (lambda P: P.zeros([N]).uniform_(0.0, 2.0), 'float32', 0, 2,
                 1.0, 2 * 12 ** -0.5),
    'normal_': (lambda P: P.zeros([N]).normal_(1.0, 0.5), 'float32', None,
                None, 1.0, 0.5),
}


def check_random(name, t):
    """Hold N draws of a random op to its dtype, range and first two
    moments (mean within 6 standard errors, std within 2%)."""
    _, dt, lo, hi, mean, std = RANDOM[name]
    assert dtype_name(t.dtype) == dt, (name, t.dtype)
    assert tuple(t.shape) == (N,), (name, t.shape)
    v = t.numpy().astype(np.float64)
    assert lo is None or v.min() >= lo, (name, v.min())
    assert hi is None or v.max() <= hi, (name, v.max())
    assert abs(v.mean() - mean) < 6 * std / N ** 0.5, (name, v.mean(), mean)
    assert abs(v.std() - std) < 0.02 * std, (name, v.std(), std)
    return t


# ---- eager training: an MLP step and a gradient-penalty step ---------------------

def mlp_data(hidden, ffn, rows, seed=0):
    """Weights (W1 [hidden, ffn], b1, W2 [ffn, hidden], b2), inputs x and
    targets y [rows, hidden], f32, from a numpy seed."""
    rng = np.random.RandomState(seed)
    weights = [(rng.randn(hidden, ffn) / hidden ** 0.5).astype('float32'),
               np.zeros(ffn, 'float32'),
               (rng.randn(ffn, hidden) / ffn ** 0.5).astype('float32'),
               np.zeros(hidden, 'float32')]
    return (weights, rng.randn(rows, hidden).astype('float32'),
            rng.randn(rows, hidden).astype('float32'))


def mlp_step(P, params, x, y, lr):
    """One eager SGD step on mean(square(tanh(x @ W1 + b1) @ W2 + b2 - y))
    in Paddle ops only: backward, the update under no_grad through
    set_value, clear_grad. Returns the loss (a tensor)."""
    w1, b1, w2, b2 = params
    loss = P.mean(P.square(P.matmul(P.tanh(P.matmul(x, w1) + b1), w2) + b2
                           - y))
    loss.backward()
    with P.no_grad():
        for p in params:
            p.set_value(p - lr * p.grad)
    for p in params:
        p.clear_grad()
    return loss


def gradient_penalty(P):
    """tests/test_double_grad.py:51-68's WGAN-GP step, the critic's weight
    and bias as plain tensors: returns the input gradient, the penalty and
    the weight's gradient."""
    rng = np.random.RandomState(11)
    weight = P.to_tensor(rng.uniform(-0.5, 0.5, (4, 1)).astype('float32'),
                         stop_gradient=False)
    bias = P.to_tensor(np.zeros(1, 'float32'), stop_gradient=False)
    x = P.to_tensor(np.random.RandomState(1).rand(8, 4).astype('float32'),
                    stop_gradient=False)
    out = (P.matmul(x, weight) + bias).sum()
    (gx,) = P.grad([out], [x], create_graph=True)
    gp = ((gx * gx).sum() - 1.0) ** 2
    gp.backward()
    return [gx, gp, weight.grad]
