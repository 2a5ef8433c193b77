"""FFT ops (port of ``paddle_tpu/tensor/fft.py``) on ``torch.fft``: as the
reference with 64-bit types off, real inputs compute in float32 and give
complex64 (integer inputs as float32 first)."""
import torch

from ..core import dtype as dtypes
from ..core.dispatch import op, to_float
from ..core.tensor import wrap


def _in(x):
    return x if x.is_complex() else to_float(x)


@op
def fft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.fft(_in(x), n=n, dim=axis, norm=norm)


@op
def ifft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.ifft(_in(x), n=n, dim=axis, norm=norm)


@op
def rfft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.rfft(to_float(x), n=n, dim=axis, norm=norm)


@op
def irfft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.irfft(_in(x), n=n, dim=axis, norm=norm)


@op
def fft2(x, s=None, axes=(-2, -1), norm='backward', name=None):
    return torch.fft.fft2(_in(x), s=s, dim=axes, norm=norm)


@op
def ifft2(x, s=None, axes=(-2, -1), norm='backward', name=None):
    return torch.fft.ifft2(_in(x), s=s, dim=axes, norm=norm)


@op
def fftn(x, s=None, axes=None, norm='backward', name=None):
    return torch.fft.fftn(_in(x), s=s, dim=axes, norm=norm)


@op
def ifftn(x, s=None, axes=None, norm='backward', name=None):
    return torch.fft.ifftn(_in(x), s=s, dim=axes, norm=norm)


@op
def rfft2(x, s=None, axes=(-2, -1), norm='backward', name=None):
    return torch.fft.rfft2(to_float(x), s=s, dim=axes, norm=norm)


@op
def irfft2(x, s=None, axes=(-2, -1), norm='backward', name=None):
    return torch.fft.irfft2(_in(x), s=s, dim=axes, norm=norm)


@op
def hfft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.hfft(_in(x), n=n, dim=axis, norm=norm)


@op
def ihfft(x, n=None, axis=-1, norm='backward', name=None):
    return torch.fft.ihfft(to_float(x), n=n, dim=axis, norm=norm)


@op
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=axes)


@op
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=axes)


def _freq(fn, n, d, dtype):
    from ..device import current_device
    out = fn(n, d, dtype=torch.float32, device=current_device())
    return wrap(out.to(dtypes.convert_dtype(dtype)) if dtype else out)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)
