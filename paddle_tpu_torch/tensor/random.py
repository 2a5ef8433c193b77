"""Random ops. Port of ``paddle_tpu/tensor/random.py``.

The reference splits one global threefry key per call. The port keeps one
explicit ``torch.Generator`` per device, made on first use and seeded by
``paddle.seed`` (0 until it is called); it never touches torch's global
generator. Streams differ from the reference's (ROADMAP Known
differences); the same seed gives the same stream on a device.
"""
import threading

import torch

from ..core.tensor import Tensor, wrap
from ..device import current_device
from .creation import _dt, _shape

_lock = threading.Lock()
_seed = 0
_generators = {}        # (device type, index) -> torch.Generator


def seed(s):
    """Reset every device's generator to seed ``s``."""
    global _seed
    with _lock:
        _seed = int(s)
        _generators.clear()


def generator(device):
    """The generator of a torch device."""
    key = (device.type, device.index or 0)
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(_seed)
            _generators[key] = g
        return g


def get_rng_state():
    """The current device's generator state."""
    return generator(current_device()).get_state()


def set_rng_state(state):
    generator(current_device()).set_state(state)


def _value(x):
    return x._value if isinstance(x, Tensor) else torch.as_tensor(
        x, device=current_device())


def rand(shape, dtype=None, name=None):
    dev = current_device()
    return wrap(torch.rand(_shape(shape), generator=generator(dev),
                           dtype=_dt(dtype), device=dev))


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return wrap(torch.randn(_shape(shape), generator=generator(dev),
                            dtype=_dt(dtype), device=dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._value if isinstance(mean, Tensor) else mean
        s = std._value if isinstance(std, Tensor) else std
        dev = (m if isinstance(m, torch.Tensor) else s).device
        sh = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                    torch.as_tensor(s).shape)
        z = torch.randn(sh, generator=generator(dev), device=dev)
        return wrap(m + s * z)
    dev = current_device()
    z = torch.randn(_shape(shape or [1]), generator=generator(dev),
                    device=dev)
    return wrap(mean + std * z)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return wrap(out.uniform_(min, max, generator=generator(dev)))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return wrap(torch.randint(low, high, _shape(shape),
                              generator=generator(dev),
                              dtype=_dt(dtype, 'int64'), device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.dtype)


def randperm(n, dtype='int64', name=None):
    dev = current_device()
    return wrap(torch.randperm(n, generator=generator(dev),
                               dtype=_dt(dtype, 'int64'), device=dev))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Indices drawn with probability proportional to x's last axis (the
    weights need not sum to one)."""
    v = _value(x).to(torch.float32)
    flat = v.reshape(-1, v.shape[-1])
    out = torch.multinomial(flat, num_samples, replacement,
                            generator=generator(v.device))
    return wrap(out.reshape(v.shape[:-1] + (num_samples,)).to(torch.int32))


def bernoulli(x, name=None):
    v = _value(x)
    return wrap(torch.bernoulli(v, generator=generator(v.device)))


def poisson(x, name=None):
    v = _value(x)
    return wrap(torch.poisson(v, generator=generator(v.device)))


def exponential_(x, lam=1.0, name=None):
    v = x._value
    draw = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    x._replace_value(draw.exponential_(lam, generator=generator(v.device)))
    return x
