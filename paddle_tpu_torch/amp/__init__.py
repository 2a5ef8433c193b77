"""Automatic mixed precision. Port of ``paddle_tpu/amp/__init__.py``.

``auto_cast`` installs ``core.dispatch.amp_cast_hook``: inside it, the
float32 inputs of white-listed ops (O1), or of every op not black-listed
(O2), are cast to bfloat16 or float16 before the op runs. ``dtype=
'float8'`` keeps bfloat16 as the carrying dtype but quantize-dequantizes
the white-listed ops' inputs through e4m3 with current scaling
(``quantization/fp8.qdq_dynamic``): fp8 numerics with bf16 plumbing. The
GPT and MoE train steps take ``matmul_precision='fp8'`` instead, which
carries delayed-scaling state.

``GradScaler`` is the reference's dynamic loss scaling over any optimizer
with ``_parameters`` (Tensors whose ``.grad`` it rescales) and ``step()``;
``check_fp8`` / ``step_fp8`` read the overflow flag of an fp8 train
step's state.
"""
import contextlib

import torch

from ..core import dispatch
from ..quantization import fp8 as _fp8

__all__ = ['auto_cast', 'autocast', 'amp_state', 'GradScaler', 'decorate']

_WHITE = {'linear', 'matmul', 'mm', 'bmm', 'conv1d', 'conv2d', 'conv3d',
          'conv1d_transpose', 'conv2d_transpose', 'conv3d_transpose',
          'einsum_fn'}
_BLACK = {'softmax', 'log_softmax', 'cross_entropy', 'layer_norm', 'mean',
          'sum', 'exp', 'log', 'softmax_with_cross_entropy'}

_state = {'enable': False, 'level': 'O1', 'dtype': torch.bfloat16,
          'fp8': False}

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
           # float8: bf16 carries the values, white ops qdq through e4m3
           'float8': torch.bfloat16}


def amp_state():
    return _state


def _amp_signature():
    """Hashable summary of everything that changes an op's amp behaviour
    (the reference folds it into hapi's step-cache keys); None when amp is
    off."""
    if not _state['enable']:
        return None
    return (_state['level'], str(_state['dtype']).replace('torch.', ''),
            bool(_state.get('fp8')),
            tuple(sorted(_state.get('white_extra', ()))),
            tuple(sorted(_state.get('black_extra', ()))))


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level='O1', dtype='bfloat16'):
    if dtype not in _DTYPES:
        raise ValueError(
            f'auto_cast dtype must be one of {sorted(_DTYPES)}, got {dtype!r}')
    prev = dict(_state)
    _state['enable'] = enable
    _state['level'] = level
    _state['dtype'] = _DTYPES[dtype]
    _state['fp8'] = dtype == 'float8'
    if custom_white_list:
        _state['white_extra'] = set(custom_white_list)
    if custom_black_list:
        _state['black_extra'] = set(custom_black_list)
    try:
        yield
    finally:
        _state.clear()
        _state.update(prev)


autocast = auto_cast

# ops the hook never casts: an explicit dtype conversion or a constructor
_NEVER_CAST = {'cast', 'to_tensor', 'full', 'full_like', 'arange'}


def _maybe_cast_args(fn_name, args):
    """The op ``fn_name``'s positional arguments (torch tensors, lists of
    them, or anything else) with float32 tensors cast as ``auto_cast``
    says; torch's autograd records the casts (the fp8 quantize-dequantize
    differentiates through its formula, as the reference's does)."""
    if not _state['enable'] or fn_name in _NEVER_CAST:
        return args
    lp = _state['dtype']
    white = _WHITE | _state.get('white_extra', set())
    black = _BLACK | _state.get('black_extra', set())
    if _state['level'] == 'O2':
        do_cast = fn_name not in black
    else:
        do_cast = fn_name in white
    if not do_cast:
        return args
    # O2's cast-everything ops that are merely not black stay plain bf16
    fp8_here = _state.get('fp8') and fn_name in white

    def cast(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return (_fp8.qdq_dynamic(a) if fp8_here else a).to(lp)
        return a
    return [type(a)(cast(x) for x in a) if isinstance(a, (list, tuple))
            else cast(a) for a in args]


dispatch.amp_cast_hook = _maybe_cast_args


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2. ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = init_loss_scaling if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide every parameter's gradient by the loss scale and note
        whether any is non-finite (one host sync for all of them)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameters:
            if p.grad is not None:
                g = p.grad._value * inv
                p.grad = g
                flags.append(~torch.isfinite(g).all())
        self._found_inf = bool(torch.stack(flags).any()) if flags else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        """The user has already called ``scaled_loss.backward()``: unscale
        the gradients, skip the step on inf/nan and update the loss scale
        (no second backward, no clearing of gradients)."""
        self.step(optimizer)

    def check_fp8(self, fp8_state):
        """The overflow flag of an fp8 delayed-scaling state (``gpt`` /
        ``moe_gpt`` ``init_fp8_state`` as the train step updates it): a 0-d
        bool tensor on the state's device, no host sync."""
        return _fp8.found_inf(fp8_state)

    def step_fp8(self, optimizer, fp8_state):
        """Skip-step flow for the fp8 train path: read the overflow flag
        (one host sync, here), step the optimizer unless it is set, and
        run the loss-scale bookkeeping. -> True when the step was taken."""
        if not self._enable:
            optimizer.step()
            return True
        self._found_inf = bool(self.check_fp8(fp8_state))
        took = not self._found_inf
        if took:
            optimizer.step()
        self.update()
        return took

    def update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale


def decorate(models, optimizers=None, level='O2', dtype='bfloat16',
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the low-precision dtype
    (``model.to(dtype=...)``); ``dtype='float8'`` keeps bf16 storage (fp8
    numerics live in ``auto_cast(dtype='float8')``'s quantize-dequantize,
    not in the parameters)."""
    if dtype not in _DTYPES:
        raise ValueError(
            f'decorate dtype must be one of {sorted(_DTYPES)}, got {dtype!r}')
    lp = 'float16' if dtype == 'float16' else 'bfloat16'
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == 'O2':
        for m in ms:
            m.to(dtype=lp)
    if optimizers is None:
        return models if single else ms
    return (models, optimizers)
