"""Pooling. Port of ``paddle_tpu/nn/functional/pooling.py``.

The reference pools with ``lax.reduce_window``; here torch's pooling ops,
with the reference's rules kept:

- ``padding`` an int, one int a spatial dim, nested (low, high) pairs, or
  ``'SAME'`` / ``'VALID'`` by XLA's rule (the odd element high);
  asymmetric or wide pads go through ``F.pad`` first;
- max pooling pads with -inf (the dtype's least value for integers,
  which pool exactly through float64);
- average pooling divides by the count of real cells only for numeric
  padding with ``exclusive`` (the default); with string padding, or
  ``exclusive=False``, by the kernel size;
- ``ceil_mode``, ``return_mask`` and ``divisor_override`` are accepted
  and ignored, as the reference ignores them;
- adaptive pooling over the bins ``floor(i·in/out) .. ceil((i+1)·in/out)``,
  which are torch's; ``None`` in ``output_size`` keeps that dim; the
  adaptive max pools take channels-first input only, as the reference's.
"""
import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import op

__all__ = ['adaptive_avg_pool1d', 'adaptive_avg_pool2d',
           'adaptive_avg_pool3d', 'adaptive_max_pool1d',
           'adaptive_max_pool2d', 'adaptive_max_pool3d', 'avg_pool1d',
           'avg_pool2d', 'avg_pool3d', 'max_pool1d', 'max_pool2d',
           'max_pool3d']

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {('avg', 1): TF.adaptive_avg_pool1d,
             ('avg', 2): TF.adaptive_avg_pool2d,
             ('avg', 3): TF.adaptive_avg_pool3d,
             ('max', 1): TF.adaptive_max_pool1d,
             ('max', 2): TF.adaptive_max_pool2d,
             ('max', 3): TF.adaptive_max_pool3d}


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(int(x) for x in v)


def _pads(padding, sizes, kernel, stride, nd):
    """(low, high) pairs a spatial dim."""
    if isinstance(padding, str):
        if padding.upper() == 'VALID':
            return [(0, 0)] * nd
        out = []
        for n, k, s in zip(sizes, kernel, stride):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    return [(int(q), int(q)) if isinstance(q, int) else tuple(q)
            for q in padding]


def _pad_spatial(x, pairs, value):
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return TF.pad(x, flat, value=value)


def _pool(x, kind, kernel, stride, padding, nd, data_format,
          exclusive=True):
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride if stride is not None else kernel, nd)
    last = not data_format.startswith('NC')
    if last:
        # contiguous: torch's CUDA avg_pool2d backward over the permuted
        # (channels-last) view gave wrong gradients with
        # count_include_pad=False
        x = torch.movedim(x, -1, 1).contiguous()
    pads = _pads(padding, x.shape[2:], kernel, stride, nd)
    # torch pads implicitly only symmetric pads of at most half a kernel
    implicit = all(lo == hi and 0 <= lo <= k // 2
                   for (lo, hi), k in zip(pads, kernel))
    if kind == 'max':
        dtype = x.dtype
        if not dtype.is_floating_point:
            x = x.to(torch.float64)
        if implicit:
            out = _MAX[nd](x, kernel, stride, [lo for lo, _ in pads])
        else:
            out = _MAX[nd](_pad_spatial(x, pads, -math.inf), kernel, stride)
        out = out.to(dtype)
    else:
        if not x.dtype.is_floating_point:
            x = x.to(torch.float32)
        counted = exclusive and not isinstance(padding, str)
        if implicit:
            out = _AVG[nd](x, kernel, stride, [lo for lo, _ in pads],
                           count_include_pad=not counted)
        elif not counted:
            out = _AVG[nd](_pad_spatial(x, pads, 0.0), kernel, stride)
        else:
            # the mean over the kernel, over the share of real cells
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = (_AVG[nd](_pad_spatial(x, pads, 0.0), kernel, stride)
                   / _AVG[nd](_pad_spatial(ones, pads, 0.0), kernel, stride))
    return torch.movedim(out, 1, -1) if last else out


def _format_1d(data_format):
    return 'NC' if data_format == 'NCL' else 'NLC'


@op
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCL', name=None):
    return _pool(x, 'max', kernel_size, stride, padding, 1,
                 _format_1d(data_format))


@op
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCHW', name=None):
    return _pool(x, 'max', kernel_size, stride, padding, 2, data_format)


@op
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCDHW', name=None):
    return _pool(x, 'max', kernel_size, stride, padding, 3, data_format)


@op
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format='NCL', name=None):
    return _pool(x, 'avg', kernel_size, stride, padding, 1,
                 _format_1d(data_format), exclusive=exclusive)


@op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCHW',
               name=None):
    return _pool(x, 'avg', kernel_size, stride, padding, 2, data_format,
                 exclusive=exclusive)


@op
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCDHW',
               name=None):
    return _pool(x, 'avg', kernel_size, stride, padding, 3, data_format,
                 exclusive=exclusive)


def _adaptive(x, out_size, nd, data_format, kind):
    last = not data_format.startswith('NC')
    if last:
        x = torch.movedim(x, -1, 1)
    out_size = tuple(s if o is None else int(o) for o, s in zip(
        (out_size,) * nd if isinstance(out_size, int) or out_size is None
        else out_size, x.shape[2:]))
    dtype = x.dtype
    if not dtype.is_floating_point:
        x = x.to(torch.float64 if kind == 'max' else torch.float32)
    out = _ADAPTIVE[kind, nd](x, out_size)
    if kind == 'max':
        out = out.to(dtype)
    return torch.movedim(out, 1, -1) if last else out


@op
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, 'NCL', 'avg')


@op
def adaptive_avg_pool2d(x, output_size, data_format='NCHW', name=None):
    return _adaptive(x, output_size, 2, data_format, 'avg')


@op
def adaptive_avg_pool3d(x, output_size, data_format='NCDHW', name=None):
    return _adaptive(x, output_size, 3, data_format, 'avg')


@op
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, 'NCL', 'max')


@op
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, 'NCHW', 'max')


@op
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, 'NCDHW', 'max')
