"""The rest of the top-level API surface that ``paddle.tensor`` and the top
level re-export. Port of the matching part of ``paddle_tpu/compat_api.py``.
"""
import numpy as np
import torch

from .core import dtype as _dtype_mod
from .core.dispatch import apply_op, op
from .core.tensor import Tensor, to_tensor

# type aliases
dtype = torch.dtype
VarBase = Tensor

_default_dtype = 'float32'


def set_default_dtype(d):
    """Record Paddle's default float dtype (read back by
    ``get_default_dtype``; torch's own default is never changed)."""
    global _default_dtype
    _default_dtype = _dtype_mod.dtype_name(_dtype_mod.convert_dtype(d))


def get_default_dtype():
    return _default_dtype


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return apply_op(lambda x: x, inputs)
    return apply_op(lambda xs: sum(xs[1:], xs[0]), list(inputs))


@op
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


def t(input, name=None):
    """Matrix transpose (reference tensor/linalg.py t): 0/1-D returns a
    copy, 2-D transposes, >2-D raises — the reference errors there too."""
    if input.ndim > 2:
        raise ValueError(
            'paddle.t only supports tensors with <= 2 dimensions; got '
            f'{input.ndim}-D (use paddle.transpose)')
    return _t_op(input)


@op
def _t_op(input):
    return input.transpose(0, 1) if input.dim() == 2 else input


def unstack(x, axis=0, num=None):
    from .tensor.manipulation import unbind
    return unbind(x, axis)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype='int64', name=None):
    """On the host, as the reference's; values keep x's dtype, inverse and
    counts are int32."""
    arr = x.numpy()
    if axis is None:
        arr = arr.reshape(-1)
    keep = np.ones(arr.shape[0], bool)
    keep[1:] = np.any(arr[1:] != arr[:-1], axis=tuple(range(1, arr.ndim))) \
        if arr.ndim > 1 else arr[1:] != arr[:-1]
    out = [to_tensor(arr[keep], dtype=x.dtype, place=x.place)]
    if return_inverse:
        out.append(to_tensor(np.cumsum(keep) - 1, place=x.place))
    if return_counts:
        idx = np.flatnonzero(keep)
        out.append(to_tensor(np.diff(np.append(idx, arr.shape[0])),
                             place=x.place))
    return out[0] if len(out) == 1 else tuple(out)


def crop_tensor(x, shape=None, offsets=None, name=None):
    from .tensor.manipulation import crop
    return crop(x, shape, offsets)


def scatter_(x, index, updates, overwrite=True, name=None):
    from .tensor.manipulation import scatter
    x._replace_value(scatter(x, index, updates, overwrite))
    return x


def tanh_(x, name=None):
    from .tensor.math import tanh
    x._replace_value(tanh(x))
    return x


def create_parameter(shape, dtype='float32', name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A new trainable ``nn.Parameter`` on the current device, from
    ``default_initializer`` (else zeros for a bias, Xavier normal for a
    weight); ``attr`` is accepted and not read, as in the reference."""
    from .nn.layer_base import Parameter
    from .nn import initializer as I
    init = default_initializer or (I.Constant(0.0) if is_bias
                                   else I.XavierNormal())
    return Parameter(init(tuple(shape), _dtype_mod.convert_dtype(dtype)),
                     name=name)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {}
    if precision is not None:
        kw['precision'] = precision
    if threshold is not None:
        kw['threshold'] = threshold
    if edgeitems is not None:
        kw['edgeitems'] = edgeitems
    if linewidth is not None:
        kw['linewidth'] = linewidth
    if sci_mode is not None:
        kw['suppress'] = not sci_mode
    np.set_printoptions(**kw)


def set_grad_enabled(mode):
    from .autograd import set_grad_enabled as _s
    return _s(mode)


def in_dygraph_mode():
    """Always True: the port runs eagerly (static mode is item 12)."""
    return True
