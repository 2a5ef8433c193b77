"""Megatron-style tensor-parallel AD helpers: the f/g conjugate pair.

Port of ``paddle_tpu/parallel/tp_ad.py:20-58`` (the reference's
``jax.custom_vjp`` pair over ``lax.psum``) as ``torch.autograd.Function``s
over the mp ``Group``:

Column-parallel matmul: f_identity(x) @ W_col   (backward all-reduces dx)
Row-parallel matmul:    g_allreduce(x @ W_row)   (forward all-reduces y)
"""
import torch

from ..distributed.collective import psum


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return psum(x, grp)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return psum(ct, ctx.grp), None


def g_allreduce(x, grp):
    """All-reduce forward, identity backward (row-parallel output)."""
    return _G.apply(x, grp)


def f_identity(x, grp):
    """Identity forward, all-reduce backward (column-parallel input)."""
    return _F.apply(x, grp)
