"""Module-level in-place op variants. Port of ``paddle_tpu/tensor/
inplace_and_array.py``: each computes the op out of place and rebinds the
input (``Tensor._replace_value``), so no other Tensor's storage changes.

The TensorArray ops (static control-flow storage) wait for ROADMAP Queue 1
item 12 and raise.
"""
from . import manipulation as _manip
from . import math as _math

_ARRAY_TODO = ('is not ported yet (ROADMAP Queue 1 item 12: graph capture '
               'and static control flow)')


def _inplace(base):
    def fn(x, *args, **kwargs):
        x._replace_value(base(x, *args, **kwargs))
        return x
    fn.__name__ = fn.__qualname__ = base.__name__ + '_'
    return fn


add_ = _inplace(_math.add)
subtract_ = _inplace(_math.subtract)
ceil_ = _inplace(_math.ceil)
floor_ = _inplace(_math.floor)
round_ = _inplace(_math.round)
exp_ = _inplace(_math.exp)
sqrt_ = _inplace(_math.sqrt)
rsqrt_ = _inplace(_math.rsqrt)
reciprocal_ = _inplace(_math.reciprocal)
clip_ = _inplace(_math.clip)
scale_ = _inplace(_math.scale)
flatten_ = _inplace(_manip.flatten)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    from .random import generator
    v = x._value
    draw = v.new_empty(v.shape, requires_grad=False)
    x._replace_value(draw.uniform_(min, max, generator=generator(v.device)))
    return x


def create_array(dtype='float32', initialized_list=None):
    raise NotImplementedError(f'create_array {_ARRAY_TODO}')


def array_write(x, i, array=None):
    raise NotImplementedError(f'array_write {_ARRAY_TODO}')


def array_read(array, i):
    raise NotImplementedError(f'array_read {_ARRAY_TODO}')


def array_length(array):
    raise NotImplementedError(f'array_length {_ARRAY_TODO}')
