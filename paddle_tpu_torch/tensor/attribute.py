"""Tensor attribute helpers. Port of ``paddle_tpu/tensor/attribute.py``."""
import torch

from ..core.tensor import wrap


def shape(x):
    return wrap(torch.tensor(x.shape, dtype=torch.int32,
                             device=x._value.device))


def rank(x):
    return wrap(torch.tensor(x.ndim, dtype=torch.int32,
                             device=x._value.device))


def is_complex(x):
    return x.dtype.is_complex


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return not (x.dtype.is_floating_point or x.dtype.is_complex
                or x.dtype == torch.bool)
