"""Convolutions. Port of ``paddle_tpu/nn/functional/conv.py``.

The reference lowers each call to one ``lax.conv_general_dilated``; here
it is ``torch.ops.aten.convolution`` (cuDNN on the card). What the port
keeps of the reference's rules:

- weight layout ``[out_c, in_c/groups, *k]``; ``[in_c, out_c/groups, *k]``
  for the transposed convs;
- ``padding`` as an int, one int a spatial dim, ``2·n`` ints (low, high
  per dim), nested pairs (the last ``n`` taken, as the reference does),
  or ``'SAME'`` / ``'VALID'`` by XLA's rule: total padding
  ``max((ceil(in/s) - 1)·s + (k - 1)·d + 1 - in, 0)``, the odd element
  on the high side. Asymmetric pads go through ``F.pad`` first;
- channels-last formats (``NLC``, ``NHWC``, ``NDHWC``) by permuting
  around the call;
- the bias added after the product, in the product's dtype (a bfloat16
  input gives a bfloat16 result, ``preferred_element_type``);
- the transposed conv is the reference's dilated-input conv: effective
  padding ``d·(k - 1) - p`` a side with ``output_padding`` on the high
  side (as a crop of torch's full transposed conv), ``output_size``
  ignored, string padding refused (as ``lax`` refuses it there), and
  groups through the reference's block split of the weight
  (``:96-106``), which is not Paddle's grouping.

float32 stays float32 on the card: cuDNN takes TF32 for float32 convs
under torch's default flags (``torch.backends.cudnn.allow_tf32``), so a
CUDA float32 conv runs, forward and backward, with that flag off.
"""
import contextlib
import math

import torch

from ...core.dispatch import op, promote_all

__all__ = ['conv1d', 'conv2d', 'conv3d', 'conv1d_transpose',
           'conv2d_transpose', 'conv3d_transpose']


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding(padding, n):
    """'SAME' / 'VALID', or n (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding[-n:]]


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's 'SAME' padding: (low, high) a spatial dim."""
    out = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _channels_last(nd, data_format):
    if nd == 1:
        return data_format not in ('NCL', 'NCHW')
    return data_format != ('NCHW' if nd == 2 else 'NCDHW')


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ConvF32(torch.autograd.Function):
    """``aten.convolution`` with cuDNN's TF32 off in the forward and in
    the backward (the backward reads the flag when it runs)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, opad,
                groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, dilation, transposed, opad, groups)
        with _no_tf32():
            return torch.ops.aten.convolution(x, w, None, stride, padding,
                                              dilation, transposed, opad,
                                              groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, opad, groups = ctx.args
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, transposed, opad,
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None, None, None, None, None, None


def _convolution(x, w, stride, padding, dilation, transposed, opad, groups):
    args = (list(stride), list(padding), list(dilation), transposed,
            list(opad), groups)
    if x.is_cuda and x.dtype == torch.float32:
        return _ConvF32.apply(x, w, *args)
    return torch.ops.aten.convolution(x, w, None, *args)


def _add_bias(out, bias, nd):
    """out + bias over the channel dim (channels first here)."""
    if bias is None:
        return out
    return out + bias.reshape((1, -1) + (1,) * nd)


def _pad_spatial(x, pairs):
    """F.pad of the spatial dims of a channels-first tensor by (low,
    high) pairs; negative values crop."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat)


def _prepare(x, weight, bias, data_format, nd):
    ts = [x, weight] + ([bias] if bias is not None else [])
    if len({t.dtype for t in ts}) > 1:
        ts = promote_all(ts)
    x, weight = ts[0], ts[1]
    bias = ts[2] if bias is not None else None
    last = _channels_last(nd, data_format)
    if last:
        x = torch.movedim(x, -1, 1)
    return x, weight, bias, last


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nd):
    stride = _tuplize(stride, nd)
    dilation = _tuplize(dilation, nd)
    x, weight, bias, last = _prepare(x, weight, bias, data_format, nd)
    pad = _padding(padding, nd)
    if isinstance(pad, str):
        pad = (_same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
               if pad == 'SAME' else [(0, 0)] * nd)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        sym = [lo for lo, _ in pad]
    else:
        x = _pad_spatial(x, pad)
        sym = [0] * nd
    out = _convolution(x, weight, stride, sym, dilation, False, [0] * nd,
                       groups)
    out = _add_bias(out, bias, nd)
    return torch.movedim(out, 1, -1) if last else out


@op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCL', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1)


@op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


@op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, nd):
    stride = _tuplize(stride, nd)
    dilation = _tuplize(dilation, nd)
    x, weight, bias, last = _prepare(x, weight, bias, data_format, nd)
    ks = weight.shape[2:]
    pad = _padding(padding, nd)
    if isinstance(pad, str):
        raise ValueError('string padding is not implemented for the '
                         'transposed convolutions: give the padding')
    opad = _tuplize(output_padding, nd) if output_padding else (0,) * nd
    crop = [(lo, hi - o) for (lo, hi), o in zip(pad, opad)]
    if groups > 1:
        # the reference's block split: its [out/g, in, *k] kernel (swapped
        # and flipped) reshaped to [g, out/g, in/g, *k], group i's inputs
        # through block i; as torch's grouped transposed weight
        sp = tuple(range(2, 2 + nd))
        in_c, og = weight.shape[0], weight.shape[1]
        w = weight.transpose(0, 1).flip(sp).reshape(
            (groups, og, in_c // groups) + tuple(ks))
        weight = w.transpose(1, 2).flip(tuple(d + 1 for d in sp)).reshape(
            (in_c, og) + tuple(ks))
    # torch's transposed conv with padding p crops p low and p - opad high
    if all(lo >= 0 and 0 <= lo - hi < max(s, d) for (lo, hi), s, d in
           zip(crop, stride, dilation)):
        out = _convolution(x, weight, stride, [lo for lo, _ in crop],
                           dilation, True, [lo - hi for lo, hi in crop],
                           groups)
    else:
        out = _convolution(x, weight, stride, [0] * nd, dilation, True,
                           [0] * nd, groups)
        out = _pad_spatial(out, [(-lo, -hi) for lo, hi in crop])
    out = _add_bias(out, bias, nd)
    return torch.movedim(out, 1, -1) if last else out


@op
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCL', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1)


@op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCHW', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


@op
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCDHW', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)
