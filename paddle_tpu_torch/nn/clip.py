"""Gradient clipping. Port of ``paddle_tpu/nn/clip.py``.

``clip_arrays`` is the form the optimizers call (a list of torch
gradients, None kept). The global norm is summed on the device: clipping
reads nothing back to the host.
"""
import torch

from ..core.tensor import Tensor, wrap


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    def clip_arrays(self, grads):
        """The clipped gradients (a list of torch tensors, None kept)."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def clip_arrays(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]

    def __call__(self, params_grads):
        return [(p, None if g is None else wrap(torch.clamp(
            g._value, self.min, self.max))) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _one(self, g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(norm, 1e-12),
                                1.0)
        return g * scale

    def clip_arrays(self, grads):
        return [None if g is None else self._one(g) for g in grads]

    def __call__(self, params_grads):
        return [(p, None if g is None else wrap(self._one(g._value)))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = clip_norm

    def clip_arrays(self, grads):
        sq = [torch.sum(torch.square(g)) for g in grads if g is not None]
        if not sq:
            return grads
        dt = sq[0].dtype
        gnorm = torch.sqrt(torch.stack([s.to(dt) for s in sq]).sum())
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return [None if g is None else g * scale.to(g.dtype) for g in grads]

    def __call__(self, params_grads):
        grads = [None if g is None else g._value for _, g in params_grads]
        clipped = self.clip_arrays(grads)
        return [(p, None if c is None else wrap(c))
                for (p, _), c in zip(params_grads, clipped)]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale every parameter's gradient in place so their joint
    ``norm_type`` norm is at most ``max_norm``; -> the norm before."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad._value for p in parameters if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros((), dtype=torch.float32))
    if norm_type == float('inf'):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g), norm_type))
                              for g in grads), 1.0 / norm_type)
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad._value * scale
    return wrap(total)
