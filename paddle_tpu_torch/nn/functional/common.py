"""Common functional ops: linear, dropout, padding, interpolate,
embedding, one_hot, cosine_similarity, pixel_shuffle, unfold. Port of
``paddle_tpu/nn/functional/common.py``.

Dropout masks come from the port's generator of the input's device
(``tensor/random.py``), so they differ from the reference's draws; the
rest is the reference's arithmetic over torch tensors.
"""
import functools

import numpy as np
import torch

from ...core.dispatch import apply_op, op, promote_all
from ...core.tensor import Tensor
from ...tensor.random import generator

__all__ = ['linear', 'dropout', 'dropout2d', 'dropout3d', 'alpha_dropout',
           'pad', 'zeropad2d', 'embedding', 'one_hot', 'label_smooth',
           'cosine_similarity', 'pixel_shuffle', 'unfold', 'interpolate',
           'upsample', 'affine_grid', 'grid_sample', 'bilinear',
           'temporal_shift', 'npair_loss_dummy']


@op
def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias); Paddle stores weight as [in, out]."""
    if x.dtype != weight.dtype or (bias is not None
                                   and bias.dtype != x.dtype):
        ts = promote_all([x, weight] + ([bias] if bias is not None else []))
        x, weight = ts[0], ts[1]
        bias = ts[2] if bias is not None else None
    if weight.dim() == 2:
        return torch.nn.functional.linear(x, weight.t(), bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _keep_mask(v, p, shape):
    """Bernoulli(1 - p) keep mask of ``shape`` on v's device."""
    u = torch.rand(tuple(shape), generator=generator(v.device),
                   device=v.device, dtype=torch.float32)
    return u < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode='upscale_in_train',
            name=None):
    if not training or p == 0:
        return x if isinstance(x, Tensor) else Tensor(x)

    def pure(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = _keep_mask(v, p, shape)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == 'upscale_in_train':
            return torch.where(keep, v / (1.0 - p), zero)
        return torch.where(keep, v, zero)
    return apply_op(pure, x)


def dropout2d(x, p=0.5, training=True, data_format='NCHW', name=None):
    axis = [0, 1] if data_format == 'NCHW' else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format='NCDHW', name=None):
    axis = [0, 1] if data_format == 'NCDHW' else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def pure(v):
        keep = _keep_mask(v, p, v.shape)
        a = (1.0 / (scale * ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5))
        b = -a * alpha_p * p
        fill = torch.full((), alpha_p, dtype=v.dtype, device=v.device)
        return a * torch.where(keep, v, fill) + b
    return apply_op(pure, x)


def _pad_index(n, lo, hi, mode):
    """Source indices of one axis padded by (lo, hi): numpy's 'reflect',
    'edge' and 'wrap' rules."""
    i = np.arange(-lo, n + hi)
    if mode == 'edge':
        return np.clip(i, 0, n - 1)
    if mode == 'wrap':
        return np.mod(i, n)
    period = 2 * (n - 1)                       # reflect, edge not repeated
    if period == 0:
        return np.zeros_like(i)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


@op
def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', name=None):
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    if len(pad) == nd * 2:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle pads are [left, right, top, bottom, ...] innermost-first
        n_spatial = len(pad) // 2
        cfg = [(0, 0)] * nd
        if data_format.startswith('NC'):
            dims = list(range(nd - n_spatial, nd))
        else:
            dims = list(range(1, 1 + n_spatial))
        for i, d in enumerate(reversed(dims)):
            cfg[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == 'constant':
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    np_mode = {'reflect': 'reflect', 'replicate': 'edge',
               'circular': 'wrap'}[mode]
    out = x
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = torch.from_numpy(_pad_index(out.shape[d], lo, hi,
                                              np_mode)).to(x.device)
            out = torch.index_select(out, d, idx)
    return out


@op
def zeropad2d(x, padding, data_format='NCHW', name=None):
    l, r, t, b = padding
    flat = ([l, r, t, b] if data_format == 'NCHW'
            else [0, 0, l, r, t, b])
    return torch.nn.functional.pad(x, flat)


@op
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = x.long()
    out = torch.nn.functional.embedding(idx, weight)
    if padding_idx is not None:
        mask = (idx == padding_idx)[..., None]
        out = torch.where(mask, torch.zeros((), dtype=out.dtype,
                                            device=out.device), out)
    return out


@op
def one_hot(x, num_classes, name=None):
    return torch.nn.functional.one_hot(x.long(), num_classes).to(
        torch.float32)


@op
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


@op
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


@op
def pixel_shuffle(x, upscale_factor, data_format='NCHW', name=None):
    r = upscale_factor
    if data_format == 'NCHW':
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """[N, C*kh*kw, L] patches, channel-major as
    ``conv_general_dilated_patches`` orders them."""
    return torch.nn.functional.unfold(
        x, _pair(kernel_sizes), dilation=_pair(dilations),
        padding=_pair(paddings), stride=_pair(strides))


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in, n_out):
    """The reference's nearest rule src = floor(i * in / out)."""
    return np.minimum((np.arange(n_out) * n_in / n_out).astype(np.int64),
                      n_in - 1)


@functools.lru_cache(maxsize=64)
def _area_weights(n_in, n_out):
    """[n_out, n_in] adaptive-average bins [floor(i*in/out),
    ceil((i+1)*in/out)), averaged unweighted."""
    w = np.zeros((n_out, n_in), np.float64)
    for o in range(n_out):
        a = int(np.floor(o * n_in / n_out))
        b = int(np.ceil((o + 1) * n_in / n_out))
        w[o, a:b] = 1.0 / (b - a)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_taps(n_in, n_out, align_corners, align_mode, kind):
    """(indices, weights) tap lists, each [n_out]: source coords
    i*(in-1)/(out-1) with align_corners, i*in/out with align_mode 1, else
    half-pixel; edge-replicated taps; cubic at a = -0.75."""
    i = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = i * ((n_in - 1) / (n_out - 1)) if n_out > 1 else np.zeros(1)
    elif align_mode == 1:
        src = i * (n_in / n_out)
    else:
        src = (i + 0.5) * (n_in / n_out) - 0.5
    s0 = np.floor(src).astype(np.int64)
    frac = src - s0
    if kind == 'linear':
        taps = ((0, 1.0 - frac), (1, frac))
    else:
        a = -0.75

        def cub(t):
            t = np.abs(t)
            return np.where(
                t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                np.where(t < 2, a * (((t - 5) * t + 8) * t - 4), 0.0))
        taps = tuple((k, cub(frac - k)) for k in (-1, 0, 1, 2))
    idxs = tuple(np.clip(s0 + k, 0, n_in - 1) for k, _ in taps)
    wts = tuple(np.asarray(w, np.float32) for _, w in taps)
    return idxs, wts


def interpolate(x, size=None, scale_factor=None, mode='nearest',
                align_corners=False, align_mode=0, data_format='NCHW',
                name=None):
    """Resize each spatial axis in turn by the reference's rules: nearest
    src = floor(i * in / out) (a gather, dtype kept), area as adaptive
    average bins, linear / cubic (a = -0.75) taps at half-pixel, aligned
    corner or i * in / out (align_mode 1) coordinates, in float32 and
    back to the input's dtype."""
    if data_format in ('NCHW', 'NCW', 'NCDHW'):
        spatial = list(x.shape[2:])
        first_spatial = 2
    else:
        spatial = list(x.shape[1:-1])
        first_spatial = 1
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        if isinstance(size, Tensor):
            size = size.tolist()
        size = [int(s.item() if isinstance(s, Tensor) else s) for s in size]
    kind = {'nearest': 'nearest', 'linear': 'linear', 'bilinear': 'linear',
            'trilinear': 'linear', 'bicubic': 'cubic', 'area': 'area'}[mode]
    amode = align_mode if (kind == 'linear' and not align_corners) else 0

    def pure(v):
        out = v
        for ax_i, (n_in, n_out) in enumerate(zip(spatial, size)):
            axis = first_spatial + ax_i
            if n_in == n_out:
                continue
            if kind == 'nearest':
                idx = torch.from_numpy(_nearest_index(n_in, n_out))
                out = torch.index_select(out, axis, idx.to(v.device))
                continue
            moved = torch.movedim(out, axis, 0).float()
            if kind == 'area':
                w = torch.from_numpy(_area_weights(n_in, n_out)).to(v.device)
                acc = torch.tensordot(w, moved, dims=1)
            else:
                idxs, wts = _resize_taps(n_in, n_out, align_corners, amode,
                                         kind)
                bshape = (n_out,) + (1,) * (moved.dim() - 1)
                acc = None
                for ix, w in zip(idxs, wts):
                    term = (torch.from_numpy(w).to(v.device).reshape(bshape)
                            * torch.index_select(
                                moved, 0, torch.from_numpy(ix).to(v.device)))
                    acc = term if acc is None else acc + term
            out = torch.movedim(acc, 0, axis)
        return out.to(v.dtype)
    return apply_op(pure, x)


def upsample(x, size=None, scale_factor=None, mode='nearest',
             align_corners=False, align_mode=0, data_format='NCHW',
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@op
def affine_grid(theta, out_shape, align_corners=True, name=None):
    n, c, h, w = [int(s) for s in out_shape]
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1, 1, h, dtype=theta.dtype, device=dev)
        xs = torch.linspace(-1, 1, w, dtype=theta.dtype, device=dev)
    else:
        ys = ((torch.arange(h, device=dev) * 2 + 1) / h - 1).to(theta.dtype)
        xs = ((torch.arange(w, device=dev) * 2 + 1) / w - 1).to(theta.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [h, w, 3]
    return torch.einsum('hwk,nik->nhwi', base, theta)


@op
def grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True, name=None):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1) / 2 * (w - 1)
        iy = (gy + 1) / 2 * (h - 1)
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    ix1, iy1 = ix0 + 1, iy0 + 1
    flat = x.reshape(n, c, h * w)

    def sample(iy_, ix_):
        iyc = torch.clamp(iy_, 0, h - 1).long()
        ixc = torch.clamp(ix_, 0, w - 1).long()
        idx = (iyc * w + ixc).reshape(n, 1, -1).expand(n, c, -1)
        v = torch.gather(flat, 2, idx).reshape((n, c) + tuple(iy_.shape[1:]))
        if padding_mode == 'zeros':
            valid = ((iy_ >= 0) & (iy_ <= h - 1) & (ix_ >= 0)
                     & (ix_ <= w - 1))
            v = v * valid[:, None].to(v.dtype)
        return v

    if mode == 'nearest':
        return sample(torch.round(iy), torch.round(ix))
    w00 = (iy1 - iy) * (ix1 - ix)
    w01 = (iy1 - iy) * (ix - ix0)
    w10 = (iy - iy0) * (ix1 - ix)
    w11 = (iy - iy0) * (ix - ix0)
    return (sample(iy0, ix0) * w00[:, None] + sample(iy0, ix1) * w01[:, None]
            + sample(iy1, ix0) * w10[:, None]
            + sample(iy1, ix1) * w11[:, None])


@op
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum('bi,oij,bj->bo', x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


@op
def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    nt, c, h, w = x.shape
    n = nt // seg_num
    x = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold], torch.zeros_like(x[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                       x[:, :-1, fold:2 * fold]], dim=1)
    mid = x[:, :, 2 * fold:]
    return torch.cat([left, right, mid], dim=2).reshape(nt, c, h, w)


@op
def npair_loss_dummy(x):
    return x
