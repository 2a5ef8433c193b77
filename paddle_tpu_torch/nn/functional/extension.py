"""Extension functionals: sequence_mask, diag_embed, gather_tree,
max_unpool2d, hsigmoid_loss, margin_cross_entropy, class_center_sample,
elu_ and tanh_. Port of ``paddle_tpu/nn/functional/extension.py``.

``class_center_sample`` draws its negative classes from the port's
generator of the label's device (``tensor/random.py``), not from numpy's
global stream as the reference does: the classes it keeps (every
positive, then random negatives, sorted) follow the same rule, the draw
differs.
"""
import math

import numpy as np
import torch

from ...core import dtype as dtypes
from ...core.dispatch import op
from ...core.tensor import Tensor
from ...tensor.random import generator

__all__ = ['sequence_mask', 'diag_embed', 'gather_tree', 'max_unpool2d',
           'hsigmoid_loss', 'margin_cross_entropy', 'class_center_sample',
           'elu_', 'tanh_']


@op
def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    m = int(maxlen) if maxlen is not None else int(x.max())
    mask = torch.arange(m, device=x.device) < x[..., None]
    return mask.to(dtypes.convert_dtype(dtype))


@op
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    x = input
    n = x.shape[-1] + abs(offset)
    out = torch.zeros(tuple(x.shape[:-1]) + (n, n), dtype=x.dtype,
                      device=x.device)
    idx = torch.arange(x.shape[-1], device=x.device)
    r, c = (idx, idx + offset) if offset >= 0 else (idx - offset, idx)
    out[..., r, c] = x
    if (dim1, dim2) != (-2, -1):
        out = torch.movedim(out, (-2, -1), (dim1, dim2))
    return out


@op
def gather_tree(ids, parents):
    """Beam-search backtrace over [T, B, beam]: from the last step back,
    each beam follows its parent pointers."""
    T, B, W = ids.shape
    cur = torch.arange(W, device=ids.device).expand(B, W)
    toks = []
    for t in range(T - 1, -1, -1):
        cur = cur.to(torch.int64)
        toks.append(torch.gather(ids[t], -1, cur))
        cur = torch.gather(parents[t], -1, cur)
    return torch.stack(toks[::-1], 0)


@op
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format='NCHW', output_size=None, name=None):
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    stride = stride or kernel_size
    if isinstance(stride, int):
        stride = (stride, stride)
    n, c, h, w = x.shape
    oh = (h - 1) * stride[0] + kernel_size[0] - 2 * padding
    ow = (w - 1) * stride[1] + kernel_size[1] - 2 * padding
    if output_size is not None:
        oh, ow = output_size[-2:]
    flat = x.reshape(n, c, -1)
    idx = indices.reshape(n, c, -1).to(device=x.device, dtype=torch.int64)
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    return out.scatter(-1, idx, flat).reshape(n, c, oh, ow)


@op
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (a
    heap: node i's children 2i+1 and 2i+2, class c the leaf
    c + num_classes - 1)."""
    depth = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
    cur = label.reshape(-1).to(torch.int64) + num_classes - 1
    codes, nodes = [], []
    for _ in range(depth):
        parent = torch.div(cur - 1, 2, rounding_mode='floor')
        codes.append(cur % 2 == 0)
        nodes.append(parent)
        cur = parent
    nodes = torch.stack(nodes, 1)                      # [B, depth]
    codes = torch.stack(codes, 1)
    valid = nodes < num_classes - 1
    nodes_c = torch.clamp(nodes, 0, num_classes - 2)
    w = weight[nodes_c]                                # [B, depth, D]
    logits = torch.einsum('bd,bkd->bk', input, w)
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes_c]
    loss = torch.log1p(torch.exp(-torch.where(codes, logits, -logits)))
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    return torch.sum(loss, 1, keepdim=True)


@op
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction='mean'):
    """ArcFace-style margin softmax over cosine logits."""
    lbl = label.reshape(-1).to(torch.int64)
    onehot = torch.nn.functional.one_hot(lbl, logits.shape[-1]) > 0
    theta = torch.arccos(torch.clamp(logits, -1 + 1e-7, 1 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    adjusted = torch.where(onehot, target, logits) * scale
    logp = torch.log_softmax(adjusted, -1)
    loss = -torch.gather(logp, 1, lbl[:, None])
    if reduction == 'mean':
        loss = torch.mean(loss)
    elif reduction == 'sum':
        loss = torch.sum(loss)
    if return_softmax:
        return loss, torch.softmax(adjusted, -1)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """Every positive class plus random negatives up to ``num_samples``,
    sorted -> (labels remapped into them, the sampled classes)."""
    t = label._value if isinstance(label, Tensor) else torch.as_tensor(
        np.asarray(label))
    lbl = t.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lbl)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    order = torch.randperm(len(rest), generator=generator(t.device),
                           device=t.device).cpu().numpy()
    take = max(num_samples - len(pos), 0)
    sampled = np.sort(np.concatenate([pos, rest[order][:take]]))
    remapped = np.searchsorted(sampled, lbl)
    return (Tensor(torch.as_tensor(remapped, dtype=torch.int32,
                                   device=t.device)),
            Tensor(torch.as_tensor(sampled, dtype=torch.int32,
                                   device=t.device)))


def elu_(x, alpha=1.0, name=None):
    from .activation import elu
    x._replace_value(elu(x, alpha)._value)
    return x


def tanh_(x, name=None):
    from .activation import tanh
    x._replace_value(tanh(x)._value)
    return x
