"""Einsum. Port of ``paddle_tpu/tensor/einsum.py``."""
import torch

from ..core.dispatch import apply_op, promote_all


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op(lambda xs: torch.einsum(equation, *promote_all(xs)),
                    list(operands))
