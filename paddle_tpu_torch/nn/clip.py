"""Gradient clipping. Port of ``paddle_tpu/nn/clip.py``.

``clip_arrays`` is the form the optimizers call (a list of torch
gradients, None kept). The global norm is summed on the device: clipping
reads nothing back to the host. Where the gradients are this rank's
blocks of tensors split over ranks, ``clip_arrays(grads, shard_axes,
mesh)`` takes each gradient's mesh axes: a norm is then the whole
tensor's (a block's squares summed over the ranks that split it, one
all-reduce a set of axes; a whole tensor counted once), as the
reference's one controller computes it.
"""
import torch

from ..core.tensor import Tensor, wrap


def _sum_squares(parts, mesh):
    """{shard axes: [0-d sums of squares]} -> their total over every
    rank's blocks."""
    total = None
    for axes, sq in parts.items():
        dt = sq[0].dtype
        s = torch.stack([x.to(dt) for x in sq]).sum()
        if axes:
            from ..distributed.collective import psum
            s = psum(s.float(), mesh.group(axes)).to(dt)
        total = s if total is None else total + s.to(total.dtype)
    return total


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    def clip_arrays(self, grads, shard_axes=None, mesh=None):
        """The clipped gradients (a list of torch tensors, None kept)."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def clip_arrays(self, grads, shard_axes=None, mesh=None):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]

    def __call__(self, params_grads):
        return [(p, None if g is None else wrap(torch.clamp(
            g._value, self.min, self.max))) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _one(self, g, axes=(), mesh=None):
        sq = torch.sum(torch.square(g))
        if axes:
            sq = _sum_squares({tuple(axes): [sq]}, mesh)
        norm = torch.sqrt(sq)
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(norm, 1e-12),
                                1.0)
        return g * scale

    def clip_arrays(self, grads, shard_axes=None, mesh=None):
        axes = shard_axes or [()] * len(grads)
        return [None if g is None else self._one(g, a, mesh)
                for g, a in zip(grads, axes)]

    def __call__(self, params_grads):
        return [(p, None if g is None else wrap(self._one(g._value)))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = clip_norm

    def clip_arrays(self, grads, shard_axes=None, mesh=None):
        parts = {}
        for g, axes in zip(grads, shard_axes or [()] * len(grads)):
            if g is not None:
                parts.setdefault(tuple(axes), []).append(
                    torch.sum(torch.square(g)))
        if not parts:
            return grads
        gnorm = torch.sqrt(_sum_squares(parts, mesh))
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
