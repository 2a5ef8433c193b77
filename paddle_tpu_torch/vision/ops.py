"""Vision ops: NMS, ROI align and pooling, YOLO decode and loss, box coding,
deformable convolution and the image file ops. Port of
``paddle_tpu/vision/ops.py``.

``nms_static`` is the operator ``torch.ops.paddle_tpu_torch.nms_static``
(``ops/nms.py``): one node of an exported program, the hand-written kernel
``csrc/nms.cu`` on the card, the plain sweep on the CPU. The eager ``nms``
runs the same operator and cuts its result to the kept count. The rest
are static-shape PyTorch over the reference's arithmetic, with torch's
autograd. ``decode_jpeg`` needs Pillow, imported when it is called.
"""
import numpy as np
import torch

from ..core.dispatch import op
from ..core.tensor import Tensor, wrap
from ..ops.nms import nms_op
from .detection import as_torch as _val, sig_xent

__all__ = ['nms', 'nms_static', 'roi_align', 'psroi_pool', 'yolo_box',
           'box_coder', 'yolo_loss', 'deform_conv2d', 'DeformConv2D',
           'read_file', 'decode_jpeg']


def _tracing(t):
    """True while ``torch.export`` (or another fake-tensor trace) runs."""
    from torch._subclasses.fake_tensor import FakeTensor
    exporting = getattr(torch.compiler, 'is_exporting', None)
    return isinstance(t, FakeTensor) or bool(exporting and exporting())


def nms_static(boxes, scores, iou_threshold=0.3, max_out=None,
               category_idxs=None, unroll=False):
    """Greedy NMS for served detector graphs -> (keep, valid): ``keep`` a
    FIXED-size [max_out] int32 index array (score-descending, padded with
    -1) and ``valid`` the kept count (0-d int32). One operator, whatever n:
    ``unroll`` is accepted and changes nothing (it only shaped the
    reference's traced graph)."""
    b = _val(boxes)
    s = _val(scores, b)
    n = b.shape[0]
    max_out = n if max_out is None else int(max_out)
    if max_out == 0:
        return (wrap(torch.empty((0,), dtype=torch.int32, device=b.device)),
                wrap(torch.zeros((), dtype=torch.int32, device=b.device)))
    cat = None if category_idxs is None else _val(category_idxs, b)
    keep, valid = nms_op(b, s, cat, float(iou_threshold), max_out)
    return wrap(keep), wrap(valid)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Kept indices (int32) sorted by score, at most ``top_k``. Eager: the
    operator's result cut to its count (one read of the count). Ties in
    the score are ordered as the reference's eager ``nms`` orders them
    (numpy's default argsort of -scores, on the host; it is not stable),
    by handing the operator each box's rank in that order as its score.
    Under a trace it returns ``nms_static``'s fixed-size ``keep`` padded
    with -1, as the reference does."""
    b = _val(boxes)
    n = b.shape[0]
    s = (torch.ones((n,), dtype=torch.float32, device=b.device)
         if scores is None else _val(scores, b))
    limit = n if top_k is None else min(int(top_k), n)
    if _tracing(b):
        keep, _ = nms_static(b, s, iou_threshold, max_out=top_k or n,
                             category_idxs=category_idxs)
        return keep
    if limit == 0:
        return wrap(torch.empty((0,), dtype=torch.int32, device=b.device))
    order = np.argsort(-s.detach().cpu().numpy())
    rank = np.empty((n,), np.float32)
    rank[order] = np.arange(n, 0, -1, dtype=np.float32)
    rank = torch.from_numpy(rank).to(b.device)
    cat = None if category_idxs is None else _val(category_idxs, b)
    keep, valid = nms_op(b, rank, cat, float(iou_threshold), limit)
    return wrap(keep[:int(valid)])


def _box_batch(boxes_num, n, r, device):
    """The image of each ROI: image i repeated boxes_num[i] times."""
    if isinstance(boxes_num, torch.Tensor):
        boxes_num = boxes_num.cpu()
    counts = torch.as_tensor(np.asarray(boxes_num), dtype=torch.long)
    idx = torch.repeat_interleave(torch.arange(n), counts, output_size=r)
    return idx.to(device)


@op
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """x: [N,C,H,W]; boxes: [R,4] in (x1,y1,x2,y2); boxes_num: [N]. One
    bilinear sample at each bin's center (``sampling_ratio`` is ignored, as
    the reference ignores it) -> [R, C, oh, ow]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    R = boxes.shape[0]
    box_batch = _box_batch(boxes_num, N, R, x.device)

    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    rw = torch.clamp(x2 - x1, min=1e-3 if aligned else 1.0)
    rh = torch.clamp(y2 - y1, min=1e-3 if aligned else 1.0)
    bin_h = rh / oh
    bin_w = rw / ow
    ar_h = torch.arange(oh, device=x.device) + 0.5
    ar_w = torch.arange(ow, device=x.device) + 0.5
    ys = y1[:, None] + ar_h[None, :] * bin_h[:, None]               # [R,oh]
    xs = x1[:, None] + ar_w[None, :] * bin_w[:, None]               # [R,ow]

    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    wy1 = ys - y0
    wx1 = xs - x0
    y0c, y1c = torch.clamp(y0, 0, H - 1), torch.clamp(y0 + 1, 0, H - 1)
    x0c, x1c = torch.clamp(x0, 0, W - 1), torch.clamp(x0 + 1, 0, W - 1)
    feat = x[box_batch]                                             # [R,C,H,W]
    rows = torch.arange(R, device=x.device)[:, None, None]

    def at(yy, xx):          # [R, C, oh, ow]
        return feat[rows, :, yy[:, :, None], xx[:, None, :]].permute(
            0, 3, 1, 2)

    wy0 = (1 - wy1)[:, None, :, None]
    wyy = wy1[:, None, :, None]
    wx0 = (1 - wx1)[:, None, None, :]
    wxx = wx1[:, None, None, :]
    return (at(y0c, x0c) * wy0 * wx0 + at(y0c, x1c) * wy0 * wxx
            + at(y1c, x0c) * wyy * wx0 + at(y1c, x1c) * wyy * wxx)


@op
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio=32,
             clip_bbox=True, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """x: [N, na*(5+cls), H, W] -> (boxes [N, na*H*W, 4], scores
    [N, na*H*W, cls])."""
    N, _, H, W = x.shape
    dev = x.device
    na = len(anchors) // 2
    an = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                         device=dev)
    pred = x.reshape(N, na, 5 + class_num, H, W)
    gx = torch.arange(W, device=dev)[None, None, None, :]
    gy = torch.arange(H, device=dev)[None, None, :, None]
    sig = torch.sigmoid
    bx = (sig(pred[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2 + gx) / W
    by = (sig(pred[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2 + gy) / H
    bw = (torch.exp(pred[:, :, 2]) * an[None, :, 0, None, None]
          / (W * downsample_ratio))
    bh = (torch.exp(pred[:, :, 3]) * an[None, :, 1, None, None]
          / (H * downsample_ratio))
    conf = sig(pred[:, :, 4])
    probs = sig(pred[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] > conf_thresh, probs,
                        torch.zeros_like(probs))
    imgs = _val(img_size, x).to(torch.float32).reshape(N, 2)
    ih = imgs[:, 0][:, None, None, None]
    iw = imgs[:, 1][:, None, None, None]
    x1 = (bx - bw / 2) * iw
    y1 = (by - bh / 2) * ih
    x2 = (bx + bw / 2) * iw
    y2 = (by + bh / 2) * ih
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), iw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), ih - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), iw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = torch.movedim(probs, 2, -1).reshape(N, -1, class_num)
    return boxes, scores


@op
def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True, axis=0):
    pb = prior_box
    one = 0 if box_normalized else 1
    pw = pb[:, 2] - pb[:, 0] + one
    ph = pb[:, 3] - pb[:, 1] + one
    px = pb[:, 0] + pw * 0.5
    py = pb[:, 1] + ph * 0.5
    var = (torch.ones_like(pb) if prior_box_var is None
           else _val(prior_box_var, pb))
    if code_type == 'encode_center_size':
        tw = target_box[:, 2] - target_box[:, 0] + one
        th = target_box[:, 3] - target_box[:, 1] + one
        tx = target_box[:, 0] + tw * 0.5
        ty = target_box[:, 1] + th * 0.5
        ox = (tx[:, None] - px[None, :]) / pw[None, :] / var[None, :, 0]
        oy = (ty[:, None] - py[None, :]) / ph[None, :] / var[None, :, 1]
        ow = torch.log(tw[:, None] / pw[None, :]) / var[None, :, 2]
        oh = torch.log(th[:, None] / ph[None, :]) / var[None, :, 3]
        return torch.stack([ox, oy, ow, oh], dim=-1)
    # decode_center_size, axis=0 layout [N, M, 4]
    t = target_box
    dw = torch.exp(var[None, :, 2] * t[:, :, 2]) * pw[None, :]
    dh = torch.exp(var[None, :, 3] * t[:, :, 3]) * ph[None, :]
    dcx = var[None, :, 0] * t[:, :, 0] * pw[None, :] + px[None, :]
    dcy = var[None, :, 1] * t[:, :, 1] * ph[None, :] + py[None, :]
    x1 = dcx - dw * 0.5
    y1 = dcy - dh * 0.5
    x2 = dcx + dw * 0.5 - one
    y2 = dcy + dh * 0.5 - one
    return torch.stack([x1, y1, x2, y2], dim=-1)


@op
def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive ROI pooling (R-FCN): rounded ROI corners,
    [floor, ceil) integer bin extents, the average over the cells of input
    channel (c*oh + i)*ow + j, by separable membership masks over H and W
    (one einsum, static shapes). x: [N, C, H, W] with C =
    output_channels*oh*ow; boxes: [R, 4]; boxes_num: [N] -> [R,
    output_channels, oh, ow]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    assert C % (oh * ow) == 0, 'channels must be divisible by oh*ow'
    C0 = C // (oh * ow)
    R = boxes.shape[0]
    dev = x.device
    box_batch = _box_batch(boxes_num, N, R, dev)

    x1 = torch.round(boxes[:, 0]) * spatial_scale
    y1 = torch.round(boxes[:, 1]) * spatial_scale
    x2 = (torch.round(boxes[:, 2]) + 1.0) * spatial_scale
    y2 = (torch.round(boxes[:, 3]) + 1.0) * spatial_scale
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    bin_h = (rh / oh)[:, None]                                      # [R, 1]
    bin_w = (rw / ow)[:, None]
    ih = torch.arange(oh, device=dev)[None, :]
    iw = torch.arange(ow, device=dev)[None, :]
    hstart = torch.clamp(torch.floor(ih * bin_h + y1[:, None]), 0, H)
    hend = torch.clamp(torch.ceil((ih + 1) * bin_h + y1[:, None]), 0, H)
    wstart = torch.clamp(torch.floor(iw * bin_w + x1[:, None]), 0, W)
    wend = torch.clamp(torch.ceil((iw + 1) * bin_w + x1[:, None]), 0, W)
    hh = torch.arange(H, device=dev)[None, None, :]
    ww = torch.arange(W, device=dev)[None, None, :]
    my = ((hh >= hstart[..., None]) & (hh < hend[..., None])).to(x.dtype)
    mx = ((ww >= wstart[..., None]) & (ww < wend[..., None])).to(x.dtype)
    feat = x[box_batch].reshape(R, C0, oh, ow, H, W)
    total = torch.einsum('rcijhw,rih,rjw->rcij', feat, my, mx)
    cnt = my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]          # [R,oh,ow]
    cnt = cnt[:, None]
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(total))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@op
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (mask=None) / v2 (modulated): the deformed
    im2col columns by one batched bilinear gather (zero outside the
    image), contracted with the filter as one grouped product.

    x: [N, C, H, W]; offset: [N, 2*dg*kh*kw, Ho, Wo] ((dy, dx) interleaved
    per kernel point); mask: [N, dg*kh*kw, Ho, Wo]; weight: [Co, C/g, kh,
    kw]."""
    N, C, H, W = x.shape
    Co, Cg, kh, kw = weight.shape
    dg = deformable_groups
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    K = kh * kw
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev, dt = x.device, x.dtype

    # sampling positions: base grid + kernel-point offset + learned offset
    base_y = (torch.arange(Ho, device=dev) * sh - ph).to(dt)
    base_x = (torch.arange(Wo, device=dev) * sw - pw).to(dt)
    ky = (torch.arange(kh, device=dev) * dh).to(dt)
    kx = (torch.arange(kw, device=dev) * dw).to(dt)
    kyx = torch.stack(torch.meshgrid(ky, kx, indexing='ij'), -1).reshape(K, 2)
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    py = (base_y[None, None, None, :, None]
          + kyx[None, None, :, 0, None, None] + off[:, :, :, 0])
    px = (base_x[None, None, None, None, :]
          + kyx[None, None, :, 1, None, None] + off[:, :, :, 1])

    xg = x.reshape(N, dg, C // dg, H * W)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = py - y0
    wx = px - x0
    cols = 0.
    for yy, wyy in ((y0, 1 - wy), (y0 + 1, wy)):
        for xx, wxx in ((x0, 1 - wx), (x0 + 1, wx)):
            valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            yi = torch.clamp(yy, 0, H - 1).long()
            xi = torch.clamp(xx, 0, W - 1).long()
            idx = (yi * W + xi).reshape(N, dg, 1, K * Ho * Wo)
            v = torch.gather(
                xg, 3, idx.expand(N, dg, C // dg, K * Ho * Wo)).reshape(
                    N, dg, C // dg, K, Ho, Wo)
            w = (wyy * wxx * valid.to(dt))[:, :, None]
            cols = cols + v * w

    if mask is not None:
        cols = cols * mask.reshape(N, dg, 1, K, Ho, Wo)

    # grouped contraction: cols [N, g, C/g, K, Ho, Wo] x w [g, Co/g, C/g, K]
    cols = cols.reshape(N, groups, C // groups, K, Ho, Wo)
    wg = weight.reshape(groups, Co // groups, Cg, K)
    out = torch.einsum('ngckhw,gock->ngohw', cols, wg).reshape(N, Co, Ho, Wo)
    if bias is not None:
        out = out + _val(bias, out)[None, :, None, None]
    return out


from ..nn.layer_base import Layer as _Layer  # noqa: E402 (after the ops)


class DeformConv2D(_Layer):
    """Deformable conv layer: forward(x, offset, mask=None)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from ..nn import initializer as I
        ks = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups, groups=groups)
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + ks, weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter((out_channels,), bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             mask=mask, **self._attrs)


# ---- file IO ops: host-side by nature --------------------------------

def read_file(filename, name=None):
    """A file's raw bytes as a 1-D uint8 tensor (on the current device)."""
    with open(filename, 'rb') as f:
        data = np.frombuffer(f.read(), np.uint8)
    return Tensor(data.copy())


def decode_jpeg(x, mode='unchanged', name=None):
    """Decode a JPEG byte tensor (from ``read_file``) to a CHW uint8 tensor.
    mode: 'unchanged' | 'gray' | 'rgb'. Needs Pillow."""
    import io

    from PIL import Image

    raw = np.asarray(x._value.cpu() if isinstance(x, Tensor) else x,
                     dtype=np.uint8).tobytes()
    img = Image.open(io.BytesIO(raw))
    norm = str(mode).lower()
    if norm == 'gray':
        img = img.convert('L')
    elif norm == 'rgb':
        img = img.convert('RGB')
    elif norm != 'unchanged':
        raise ValueError(f"decode_jpeg: mode must be 'unchanged', 'gray' "
                         f"or 'rgb', got {mode!r}")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return Tensor(np.ascontiguousarray(arr))


# ---- YOLOv3 loss -------------------------------------------------------

def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """-> [N] loss. x: [N, S*(5+C), H, W]; gt_box: [N, B, 4] (cx, cy, w, h
    normalized to [0, 1]); gt_label: [N, B] int; anchors: flat (w, h) pairs
    in input pixels; anchor_mask: indices of this scale's anchors.
    Sigmoid cross-entropy on (x, y), objectness and classes, L1 on (w, h),
    box terms scaled by (2 - w*h), each gt on its best anchor (the first gt
    wins a cell), negatives whose decoded IoU with a gt exceeds
    ``ignore_thresh`` exempt from the objectness loss."""
    xv = _val(x)
    dev = xv.device
    gb = _val(gt_box, xv).to(torch.float32)
    gl = _val(gt_label, xv).to(torch.long)
    gs = (torch.ones(gl.shape, dtype=torch.float32, device=dev)
          if gt_score is None else _val(gt_score, xv).to(torch.float32))
    N, _, H, W = xv.shape
    S = len(anchor_mask)
    C = int(class_num)
    xv = xv.reshape(N, S, 5 + C, H, W).to(torch.float32)
    tx, ty = xv[:, :, 0], xv[:, :, 1]          # [N,S,H,W]
    tw, th = xv[:, :, 2], xv[:, :, 3]
    tobj = xv[:, :, 4]
    tcls = xv[:, :, 5:]                        # [N,S,C,H,W]
    input_w = W * downsample_ratio
    input_h = H * downsample_ratio
    all_anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask_anchors = all_anchors[np.asarray(anchor_mask)]

    def dev_t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- ignore mask: decoded pred boxes vs every gt ----
    sig = torch.sigmoid
    gx_grid = torch.arange(W, dtype=torch.float32, device=dev)[
        None, None, None, :]
    gy_grid = torch.arange(H, dtype=torch.float32, device=dev)[
        None, None, :, None]
    bx = (sig(tx) * scale_x_y - 0.5 * (scale_x_y - 1) + gx_grid) / W
    by = (sig(ty) * scale_x_y - 0.5 * (scale_x_y - 1) + gy_grid) / H
    aw = dev_t(mask_anchors[:, 0])[None, :, None, None]
    ah = dev_t(mask_anchors[:, 1])[None, :, None, None]
    bw = torch.exp(tw) * aw / input_w
    bh = torch.exp(th) * ah / input_h

    def iou_xywh(ax, ay, aw_, ah_, bx_, by_, bw_, bh_):
        x1 = torch.maximum(ax - aw_ / 2, bx_ - bw_ / 2)
        x2 = torch.minimum(ax + aw_ / 2, bx_ + bw_ / 2)
        y1 = torch.maximum(ay - ah_ / 2, by_ - bh_ / 2)
        y2 = torch.minimum(ay + ah_ / 2, by_ + bh_ / 2)
        inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
        return inter / torch.clamp(aw_ * ah_ + bw_ * bh_ - inter, min=1e-10)

    g = gb[:, None, None, None]                               # [N,1,1,1,B,4]
    iou_all = iou_xywh(bx[..., None], by[..., None], bw[..., None],
                       bh[..., None], g[..., 0], g[..., 1], g[..., 2],
                       g[..., 3])                             # [N,S,H,W,B]
    gt_valid = (gb[..., 2] > 0) & (gb[..., 3] > 0)            # [N, B]
    iou_all = torch.where(gt_valid[:, None, None, None, :], iou_all,
                          torch.zeros_like(iou_all))
    ignore = torch.amax(iou_all, dim=-1) > ignore_thresh      # [N,S,H,W]

    # ---- positive assignment, vectorized over all B gt slots ----
    B = gb.shape[1]
    gw_pix = gb[..., 2] * input_w       # [N, B]
    gh_pix = gb[..., 3] * input_h
    aw_all = dev_t(all_anchors[:, 0])[None, None, :]
    ah_all = dev_t(all_anchors[:, 1])[None, None, :]
    inter = (torch.minimum(gw_pix[..., None], aw_all)
             * torch.minimum(gh_pix[..., None], ah_all))
    union = gw_pix[..., None] * gh_pix[..., None] + aw_all * ah_all - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=-1)

    mask_vec = dev_t(np.asarray(anchor_mask), torch.long)
    in_mask = best[..., None] == mask_vec[None, None, :]           # [N,B,S]
    slot = torch.where(in_mask.any(-1), torch.argmax(in_mask.to(torch.int8),
                                                     -1),
                       torch.full_like(best, -1))
    use = gt_valid & (slot >= 0)                                   # [N,B]
    gx, gy = gb[..., 0], gb[..., 1]
    gw, gh = gb[..., 2], gb[..., 3]
    gi = torch.clamp((gx * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gy * H).to(torch.int32), 0, H - 1).long()
    s_ = torch.clamp(slot, min=0)
    # deterministic first-wins on cell collisions (the C++ op walks the gt
    # boxes in order)
    cell = (s_ * H + gj) * W + gi                                  # [N,B]
    ar = torch.arange(B, device=dev)
    earlier_same = ((cell[:, None, :] == cell[:, :, None])
                    & use[:, None, :]
                    & (ar[None, :] < ar[:, None])[None])
    use = use & ~earlier_same.any(-1)

    sel_aw = dev_t(mask_anchors[:, 0])[s_]
    sel_ah = dev_t(mask_anchors[:, 1])[s_]
    fx = (gx * W - gi + 0.5 * (scale_x_y - 1)) / scale_x_y
    fy = (gy * H - gj + 0.5 * (scale_x_y - 1)) / scale_x_y
    onehot = (torch.arange(C, device=dev)[None, None, :]
              == gl[..., None]).to(torch.float32)                  # [N,B,C]
    if use_label_smooth and C > 1:
        onehot = onehot * (1.0 - 1.0 / C) + (1.0 - onehot) * (1.0 / C)

    # one scatter a target: inactive slots write into a dump column (gi =
    # W) that is sliced off, so the active indices are unique
    n_idx = torch.arange(N, device=dev)[:, None].expand(N, B)
    gi_s = torch.where(use, gi, torch.full_like(gi, W))
    idx = (n_idx, s_, gj, gi_s)

    def put(vals):
        z = torch.zeros((N, S, H, W + 1), dtype=torch.float32, device=dev)
        return z.index_put(idx, vals.to(torch.float32))[..., :W]

    usef = use.to(torch.float32)
    obj_t = put(usef)
    txt, tyt = put(fx), put(fy)
    twt = put(torch.log(torch.clamp(gw * input_w / sel_aw, min=1e-9)))
    tht = put(torch.log(torch.clamp(gh * input_h / sel_ah, min=1e-9)))
    wgt = put(2.0 - gw * gh)
    scr = put(gs)
    cls_t = torch.zeros((N, S, C, H, W + 1), dtype=torch.float32, device=dev)
    cls_t[n_idx, s_, :, gj, gi_s] = onehot
    cls_t = cls_t[..., :W]

    pos = obj_t                                            # [N,S,H,W] 0/1
    score = torch.where(pos > 0, scr, torch.ones_like(scr))
    loss_xy = (sig_xent(tx, txt) + sig_xent(ty, tyt)) * pos * wgt * score
    loss_wh = (torch.abs(tw - twt) + torch.abs(th - tht)) * pos * wgt * score
    # objectness: positives regress onto the gt (mixup) score; negatives
    # target 0 unless their best decoded IoU exceeds ignore_thresh
    loss_obj = (sig_xent(tobj, scr) * pos
                + sig_xent(tobj, torch.zeros_like(tobj))
                * (1 - pos) * (1 - ignore.to(torch.float32)))
    loss_cls = torch.sum(sig_xent(tcls, cls_t), dim=2) * pos * score
    total = (loss_xy + loss_wh + loss_obj + loss_cls).sum(dim=(1, 2, 3))
    return wrap(total)
