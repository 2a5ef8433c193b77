"""Functional activations. Port of
``paddle_tpu/nn/functional/activation.py``: each body is the reference's
formula over torch tensors, dispatched through ``core.dispatch.op`` (so
amp's hook sees it by name)."""
import torch

from ...core.dispatch import op

__all__ = ['relu', 'relu_', 'relu6', 'elu', 'selu', 'celu', 'gelu',
           'sigmoid', 'hardsigmoid', 'hardswish', 'hardtanh', 'hardshrink',
           'softshrink', 'tanhshrink', 'leaky_relu', 'prelu', 'rrelu',
           'log_sigmoid', 'maxout', 'softplus', 'softsign', 'swish', 'silu',
           'mish', 'tanh', 'thresholded_relu', 'softmax', 'softmax_',
           'log_softmax', 'gumbel_softmax', 'glu']


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@op
def relu(x, name=None):
    return torch.relu(x)


relu_ = relu


@op
def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


@op
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, _zero(x), x)))


@op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op
def celu(x, alpha=1.0, name=None):
    return torch.clamp_min(x, 0) + alpha * torch.expm1(
        torch.clamp_max(x, 0) / alpha)


@op
def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate='tanh' if approximate else 'none')


@op
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@op
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0, 1)


@op
def hardswish(x, name=None):
    return x * torch.clamp(x / 6 + 0.5, 0, 1)


@op
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@op
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@op
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


@op
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@op
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@op
def prelu(x, weight, data_format='NCHW', name=None):
    w = weight
    if w.numel() > 1:
        ax = 1 if data_format == 'NCHW' else x.dim() - 1
        shape = [1] * x.dim()
        shape[ax] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@op
def rrelu(x, lower=0.125, upper=0.3333, training=False, name=None):
    slope = (lower + upper) / 2
    return torch.where(x >= 0, x, slope * x)


@op
def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(x)


@op
def maxout(x, groups, axis=1, name=None):
    shape = list(x.shape)
    axis = axis % x.dim()
    c = shape[axis]
    shape[axis:axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


@op
def softplus(x, beta=1, threshold=20, name=None):
    return torch.where(
        beta * x > threshold, x,
        torch.log1p(torch.exp(beta * torch.clamp_max(x, threshold / beta)))
        / beta)


@op
def softsign(x, name=None):
    return x / (1 + torch.abs(x))


@op
def swish(x, name=None):
    return x * torch.sigmoid(x)


@op
def silu(x, name=None):
    return x * torch.sigmoid(x)


@op
def mish(x, name=None):
    # jax.nn.softplus is logaddexp(x, 0)
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


@op
def tanh(x, name=None):
    return torch.tanh(x)


@op
def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, _zero(x))


def _as(x, dtype):
    if dtype is None:
        return x
    from ...core.dtype import convert_dtype
    return x.to(convert_dtype(dtype))


@op
def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_as(x, dtype), dim=axis)


softmax_ = softmax


@op
def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_as(x, dtype), dim=axis)


@op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Gumbel noise from the port's generator of x's device (the stream
    differs from the reference's)."""
    from ...tensor.random import generator
    u = torch.rand(x.shape, generator=generator(x.device), device=x.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp_min(tiny)))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


@op
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)

