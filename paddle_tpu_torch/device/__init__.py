"""Device/place management. Port of ``paddle_tpu/device/__init__.py``.

A place names a torch device: ``CPUPlace()`` the host, ``CUDAPlace(n)``
card n. ``set_device('gpu')`` / ``'gpu:N'`` / ``'cpu'`` picks the device
new tensors are created on; ops run where their inputs lie. With no
``set_device`` call the device is the card (``resolve_device``): on a
machine without one, creating a tensor raises unless the caller chose the
CPU. Nothing falls back to the host on its own.

The chosen place is process state, as in the reference.
"""
import torch

from .. import resolve_device


class _Place:
    kind = 'cpu'

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f'Place({self})'

    def __str__(self):
        return 'cpu' if self.kind == 'cpu' else f'{self.kind}:{self.device_id}'

    def __eq__(self, other):
        return (isinstance(other, _Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def torch_device(self):
        """The torch device of this place (raises on a machine without the
        card it names)."""
        if self.kind == 'cpu':
            return resolve_device('cpu')
        return resolve_device(f'cuda:{self.device_id}')


class CPUPlace(_Place):
    kind = 'cpu'


class CUDAPlace(_Place):
    kind = 'gpu'


def _no_tpu():
    return ValueError("paddle_tpu_torch runs on NVIDIA GPUs: use 'gpu' / "
                      "'gpu:N' (or CUDAPlace(N)) for the card, 'cpu' for "
                      'the host; there is no TPU place')


class TPUPlace(_Place):
    kind = 'tpu'

    def __init__(self, device_id=0):
        raise _no_tpu()


_current = None       # the place set_device chose; None: the card


def place_of(device):
    """The place of a torch device."""
    if device.type == 'cpu':
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def _parse(device):
    if isinstance(device, _Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    name, _, idx = str(device).partition(':')
    idx = int(idx) if idx else 0
    if name == 'cpu':
        return CPUPlace()
    if name in ('gpu', 'cuda'):
        return CUDAPlace(idx)
    if name == 'tpu':
        raise _no_tpu()
    raise ValueError(f"unsupported device {device!r}; use 'gpu', 'gpu:N' "
                     "or 'cpu'")


def set_device(device):
    """``set_device('gpu')`` / ``'gpu:N'`` / ``'cpu'`` (or a place): the
    device new tensors are created on. Returns the place."""
    global _current
    place = _parse(device)
    place.torch_device()          # a card that is not there raises here
    _current = place
    return place


def get_device():
    """'gpu:N' or 'cpu:0' (the reference's form): the device new tensors
    are created on."""
    place = _current if _current is not None else CUDAPlace(0)
    return f'{place.kind}:{place.device_id}'


def current_device():
    """The torch device new tensors are created on (raises without a card
    unless the CPU was chosen)."""
    if _current is not None:
        return _current.torch_device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            'paddle_tpu_torch creates tensors on the CUDA card by default '
            "and none is available; call paddle.set_device('cpu') to run "
            'on the host')
    return resolve_device(None)


def to_torch_device(place):
    """The torch device of a ``place=`` argument (a place, a string or a
    torch device); None is the current device."""
    if place is None:
        return current_device()
    return _parse(place).torch_device()


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()
