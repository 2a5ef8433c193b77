"""InputSpec. Port of ``paddle_tpu/static/input_spec.py`` (reference:
python/paddle/static/input.py). ``dtype`` is a torch dtype, 64-bit types
canonicalized to 32 bits as everywhere in the port."""
import torch

from ..core import dtype as dtypes


class InputSpec:
    def __init__(self, shape, dtype='float32', name=None):
        self.shape = tuple(shape)
        self.dtype = dtypes.convert_dtype(dtype) or torch.float32
        self.name = name

    def __repr__(self):
        return (f'InputSpec(shape={self.shape}, '
                f'dtype={dtypes.dtype_name(self.dtype)}, name={self.name})')

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, 'name', None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, ndarray.dtype, name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)
