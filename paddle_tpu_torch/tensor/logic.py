"""Logic/comparison ops. Port of ``paddle_tpu/tensor/logic.py``."""
import torch

from ..core.dispatch import op, promote


@op
def equal(x, y, name=None):
    return torch.eq(*promote(x, y, True))


@op
def not_equal(x, y, name=None):
    return torch.ne(*promote(x, y, True))


@op
def greater_than(x, y, name=None):
    return torch.gt(*promote(x, y, True))


@op
def greater_equal(x, y, name=None):
    return torch.ge(*promote(x, y, True))


@op
def less_than(x, y, name=None):
    return torch.lt(*promote(x, y, True))


@op
def less_equal(x, y, name=None):
    return torch.le(*promote(x, y, True))


@op
def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*promote(x, y))


@op
def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*promote(x, y))


@op
def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*promote(x, y))


@op
def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


@op
def equal_all(x, y, name=None):
    return torch.all(torch.eq(*promote(x, y)))


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.all(torch.isclose(*promote(x, y), rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*promote(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@op
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    from ..core.tensor import Tensor
    return isinstance(x, Tensor)


__all__ = [_n for _n, _f in list(globals().items())
           if not _n.startswith('_') and callable(_f)
           and getattr(_f, '__module__', None) == __name__]
