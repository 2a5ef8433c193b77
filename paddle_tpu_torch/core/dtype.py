"""Dtype aliases with Paddle's names, backed by torch dtypes. Port of
``paddle_tpu/core/dtype.py``.

The reference runs JAX with 64-bit types off, so Paddle's int64/float64/
complex128 requests canonicalize to their 32-bit counterparts at this
boundary (``_CANON64``, ``paddle_tpu/core/dtype.py:30-50``). The port keeps
that rule: ``paddle.to_tensor(np.int64 array).dtype`` is ``int32`` in both
packages, and no op result is ever a 64-bit type (``canonical``).
"""
import numpy as np
import torch

bool = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    'bool': bool, 'uint8': uint8, 'int8': int8, 'int16': int16,
    'int32': int32, 'int64': int64, 'float16': float16,
    'bfloat16': bfloat16, 'float32': float32, 'float64': float64,
    'complex64': complex64, 'complex128': complex128,
    'uint16': torch.uint16, 'uint32': torch.uint32, 'uint64': torch.uint64,
}

_CANON64 = {torch.int64: torch.int32, torch.uint64: torch.uint32,
            torch.float64: torch.float32, torch.complex128: torch.complex64}

_FLOATING = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_INEXACT = _FLOATING + (torch.complex64, torch.complex128)


def canonical(dtype):
    """The 32-bit counterpart of a 64-bit dtype; any other dtype as is."""
    return _CANON64.get(dtype, dtype)


def convert_dtype(dtype):
    """A torch dtype for a string / numpy / torch dtype spec (None passes
    through), 64-bit types canonicalized."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return canonical(dtype)
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
        if name == 'bool_':
            name = 'bool'
    try:
        return canonical(_STR2DTYPE[name])
    except KeyError:
        raise TypeError(f'unsupported dtype {dtype!r}') from None


def dtype_name(dtype):
    """Paddle's name of a dtype: 'float32', 'int32', 'bool', ..."""
    return str(dtype).replace('torch.', '')


def is_floating(dtype):
    """Floating or complex: the dtypes that can carry a gradient."""
    return dtype in _INEXACT
