"""Greedy NMS with a fixed-size output, as one PyTorch operator.

``torch.ops.paddle_tpu_torch.nms_static`` (``nms_op``) is the counterpart
of ``paddle_tpu/vision/ops.py`` ``nms_static``: boxes are offset by
category, sorted by score (descending, stable: the reference's
``jnp.argsort(-s)``, which keeps ties in index order and takes -0 == 0),
and swept greedily over their IoU matrix, a box suppressing every later
box whose IoU with it exceeds the threshold. The result is ``keep``
([max_out] int32, the original indices in score order, -1 past the
count) and ``valid`` (the kept count, a 0-d int32).

Being an operator with a fake (shape) implementation, it is one node of a
``torch.export`` program whatever the number of boxes; the reference's
``unroll`` only shaped its own graph and is not an argument here.

A CPU tensor runs the twin, ``nms_static_reference``: the IoU matrix of
``vision/detection.pairwise_iou`` and the plain sweep over its rows. A CUDA
tensor launches ``csrc/nms.cu`` (a bitmask pass and a one-block sweep that
stops at ``max_out``; ``nms_static_cuda``, whose ``launches`` counts its
launches), or the wrapper raises. Anything else raises. The boxes are
taken in float32 on both routes.
"""
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

EPS = 1e-9                 # pairwise_iou's eps, in the kernel too
_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load('nms')
        lib.nms_static.argtypes = [_P] * 5 + [_I32, _I32, _F32, _F32, _P]
        lib.nms_static.restype = _I32
        lib.nms_error_string.argtypes = [_I32]
        lib.nms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def sorted_boxes(boxes, scores, category_idxs=None):
    """(boxes offset by category and sorted by score, float32 [n, 4]
    contiguous; the sort's order, int64 [n]). Both routes start here."""
    b = boxes.to(torch.float32)
    if category_idxs is not None:
        cat = category_idxs.to(device=b.device, dtype=b.dtype)
        # cross-category boxes never overlap once offset apart
        b = b + (cat * (torch.max(b) + 1.0))[:, None]
    order = torch.sort(-scores.to(torch.float32).reshape(-1),
                       stable=True).indices
    return b[order].contiguous(), order


def _empty(max_out, device):
    return (torch.full((max_out,), -1, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def nms_static_reference(boxes, scores, iou_threshold, max_out,
                         category_idxs=None):
    """The twin: the reference's IoU matrix over the sorted boxes
    (``pairwise_iou``, on the boxes' device) and its greedy sweep (on the
    host), stopping once ``max_out`` boxes are kept."""
    from ..vision.detection import pairwise_iou
    n = boxes.shape[0]
    if n == 0:
        return _empty(max_out, boxes.device)
    b, order = sorted_boxes(boxes, scores, category_idxs)
    over = (pairwise_iou(b, b) > iou_threshold).cpu().numpy()
    order_np = order.cpu().numpy()
    keep = np.full((max_out,), -1, np.int32)
    suppressed = np.zeros(n, bool)
    count = 0
    for i in range(n):
        if count == max_out:
            break
        if suppressed[i]:
            continue
        keep[count] = order_np[i]
        count += 1
        suppressed |= over[i]
    return (torch.from_numpy(keep).to(boxes.device),
            torch.tensor(count, dtype=torch.int32, device=boxes.device))


def nms_static_cuda(boxes, scores, iou_threshold, max_out,
                    category_idxs=None):
    """``csrc/nms.cu`` on the card: the bitmask pass and the sweep, on the
    current stream without synchronising. ``nms_static_cuda.launches``
    counts its launches (the two kernels of one call count once)."""
    dev = boxes.device
    if dev.type != 'cuda' or scores.device != dev:
        raise ValueError('nms_static_cuda takes boxes and scores on one '
                         'CUDA device')
    n = boxes.shape[0]
    if n == 0:
        return _empty(max_out, dev)
    b, order = sorted_boxes(boxes, scores, category_idxs)
    order32 = order.to(torch.int32)
    words = (n + 63) // 64
    mask = torch.empty((n, words), dtype=torch.int64, device=dev)
    keep = torch.empty((max_out,), dtype=torch.int32, device=dev)
    valid = torch.empty((), dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    err = lib.nms_static(b.data_ptr(), order32.data_ptr(), mask.data_ptr(),
                         keep.data_ptr(), valid.data_ptr(), n, max_out,
                         float(iou_threshold), EPS,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.nms_error_string(err).decode()
        raise RuntimeError(f'nms_static launch failed ({err}): {msg}')
    nms_static_cuda.launches += 1
    return keep, valid


nms_static_cuda.launches = 0


@torch.library.custom_op('paddle_tpu_torch::nms_static', mutates_args=())
def nms_op(boxes: torch.Tensor, scores: torch.Tensor,
           category_idxs: Optional[torch.Tensor], iou_threshold: float,
           max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [n, 4] xyxy, scores [n], category_idxs [n] or None ->
    (keep [max_out] int32, valid 0-d int32). CPU: the twin; CUDA: the
    kernel."""
    if boxes.dim() != 2 or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be [n, 4], got {list(boxes.shape)}')
    if max_out < 1:
        raise ValueError(f'max_out must be at least 1, got {max_out}')
    if boxes.device.type == 'cuda':
        return nms_static_cuda(boxes, scores, iou_threshold, max_out,
                               category_idxs)
    if boxes.device.type == 'cpu':
        return nms_static_reference(boxes, scores, iou_threshold, max_out,
                                    category_idxs)
    raise ValueError(f'nms_static runs on cuda or cpu, not {boxes.device}')


@nms_op.register_fake
def _nms_op_shapes(boxes, scores, category_idxs, iou_threshold, max_out):
    return (boxes.new_empty((max_out,), dtype=torch.int32),
            boxes.new_empty((), dtype=torch.int32))
