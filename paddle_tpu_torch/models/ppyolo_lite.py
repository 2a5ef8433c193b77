"""PP-YOLOE-class anchor-free detector: CSP backbone + FPN + decoupled
ET-head with DFL box regression, trained by TAL assignment + VFL/GIoU/DFL.
Port of ``paddle_tpu/models/ppyolo_lite.py``.

The head is anchor-free (one cell, one prediction); regression is a
distribution over reg_max+1 integer bins decoded by a softmax expectation;
the loss (``vision/detection.py``) assigns the whole batch at once with
static shapes. ``decode`` composes with ``vision.ops.nms_static`` into a
served graph that ``jit.save`` exports with NMS as one operator.

The legacy anchor-based lite head stays as ``PPYOLOELite`` (``yolo_box``
decode).
"""
import torch

from .. import nn
from ..core.dispatch import apply_op
from ..nn.functional import interpolate
from ..tensor.manipulation import concat
from ..vision import detection as D


class ConvBNAct(nn.Layer):
    def __init__(self, cin, cout, k=3, s=1):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=k // 2,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.Silu()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class CSPBlock(nn.Layer):
    def __init__(self, c, n=1):
        super().__init__()
        self.cv1 = ConvBNAct(c, c // 2, 1)
        self.cv2 = ConvBNAct(c, c // 2, 1)
        self.m = nn.Sequential(*[ConvBNAct(c // 2, c // 2) for _ in range(n)])
        self.cv3 = ConvBNAct(c, c, 1)

    def forward(self, x):
        return self.cv3(concat([self.m(self.cv1(x)), self.cv2(x)], axis=1))


class CSPBackbone(nn.Layer):
    """Shared stem + c2..c5 CSP pyramid (strides 2..32) of both the
    anchor-free PPYOLOE and the legacy lite head."""

    def __init__(self, w):
        super().__init__()
        self.stem = ConvBNAct(3, w, 3, 2)                               # /2
        self.c2 = nn.Sequential(ConvBNAct(w, w * 2, 3, 2),
                                CSPBlock(w * 2))                        # /4
        self.c3 = nn.Sequential(ConvBNAct(w * 2, w * 4, 3, 2),
                                CSPBlock(w * 4))                        # /8
        self.c4 = nn.Sequential(ConvBNAct(w * 4, w * 8, 3, 2),
                                CSPBlock(w * 8))                        # /16
        self.c5 = nn.Sequential(ConvBNAct(w * 8, w * 16, 3, 2),
                                CSPBlock(w * 16))                       # /32

    def forward(self, x):
        x = self.c2(self.stem(x))
        c3 = self.c3(x)
        c4 = self.c4(c3)
        c5 = self.c5(c4)
        return c3, c4, c5


class ETHead(nn.Layer):
    """Decoupled per-level head: cls [B, C, H, W] + DFL reg
    [B, 4*(reg_max+1), H, W]."""

    def __init__(self, cin, num_classes, reg_max):
        super().__init__()
        self.cls_stem = ConvBNAct(cin, cin, 3)
        self.reg_stem = ConvBNAct(cin, cin, 3)
        self.cls = nn.Conv2D(cin, num_classes, 1)
        self.reg = nn.Conv2D(cin, 4 * (reg_max + 1), 1)

    def forward(self, x):
        return self.cls(self.cls_stem(x)), self.reg(self.reg_stem(x))


class PPYOLOE(nn.Layer):
    """Anchor-free PP-YOLOE-class detector over strides (8, 16, 32).

    forward(x [B,3,H,W]) -> per-level (cls_logits, reg_dist) pairs.
    loss(outs, gt_boxes [B,M,4] xyxy px, gt_labels [B,M], gt_mask [B,M])
    decode(outs, conf_thresh) -> (boxes [B,A,4], scores [B,A,C])
    """

    strides = (8, 16, 32)

    def __init__(self, num_classes=80, width=32, reg_max=16):
        super().__init__()
        w = width
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.backbone = CSPBackbone(w)
        self.lat5 = ConvBNAct(w * 16, w * 8, 1)
        self.lat4 = ConvBNAct(w * 16, w * 4, 1)        # cat(up(p5), c4)
        self.lat3 = ConvBNAct(w * 8, w * 2, 1)         # cat(up(p4), c3)
        self.head8 = ETHead(w * 2, num_classes, reg_max)
        self.head16 = ETHead(w * 4, num_classes, reg_max)
        self.head32 = ETHead(w * 8, num_classes, reg_max)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        p5 = self.lat5(c5)
        p4 = self.lat4(concat([interpolate(p5, scale_factor=2,
                                           mode='nearest'), c4], axis=1))
        p3 = self.lat3(concat([interpolate(p4, scale_factor=2,
                                           mode='nearest'), c3], axis=1))
        return (self.head8(p3), self.head16(p4), self.head32(p5))

    # ---- the functional core of loss and decode, over torch tensors ----

    def _flatten_raw(self, raw):
        """raw: [cls1, reg1, cls2, reg2, cls3, reg3] -> (cls_logits [B, A,
        C], reg_dist [B, A, 4, reg_max+1], points [A, 2],
        stride_per_anchor [A])."""
        cls_l, reg_l, sizes = [], [], []
        for i in range(0, len(raw), 2):
            cv, rv = raw[i], raw[i + 1]
            B, C, H, W = cv.shape
            sizes.append((H, W))
            cls_l.append(cv.reshape(B, C, H * W).permute(0, 2, 1))
            reg_l.append(rv.reshape(B, 4, self.reg_max + 1,
                                    H * W).permute(0, 3, 1, 2))
        pts, sts = D.anchor_points(sizes, self.strides,
                                   device=raw[0].device)
        return torch.cat(cls_l, 1), torch.cat(reg_l, 1), pts, sts

    def _boxes(self, reg_dist, pts, sts):
        """DFL distances -> xyxy boxes in input pixels."""
        ltrb = D.dfl_decode(reg_dist) * sts[None, :, None]
        return torch.cat([pts[None] - ltrb[..., :2],
                          pts[None] + ltrb[..., 2:]], -1)

    def loss(self, outs, gt_boxes, gt_labels, gt_mask,
             loss_weights=(1.0, 2.5, 0.5)):
        """TAL-assigned VFL + GIoU + DFL total loss (a scalar Tensor).
        gt_boxes: [B, M, 4] xyxy px (padded); gt_labels: [B, M] int;
        gt_mask: [B, M] bool (False rows are padding). Each image's terms
        are divided by its own quality mass, then averaged over the
        batch."""
        num_classes = self.num_classes
        flatten, boxes_of = self._flatten_raw, self._boxes

        def pure(gb, gl, gm, *raw):
            cls_logits, reg_dist, pts, sts = flatten(raw)
            pred_boxes = boxes_of(reg_dist, pts, sts)
            scores = torch.sigmoid(cls_logits)
            gb = D.as_torch(gb, cls_logits).to(torch.float32)
            fg, lab, abox, ascore = D.task_aligned_assign(
                scores.detach(), pred_boxes.detach(), pts, gb, gl, gm)
            # VFL target: the assigned quality on the assigned class row
            fgf = fg.to(torch.float32)
            onehot = torch.nn.functional.one_hot(
                torch.clamp(lab.long(), 0, num_classes - 1),
                num_classes).to(torch.float32)
            tgt = onehot * ascore[..., None] * fgf[..., None]
            l_vfl = D.varifocal_loss(cls_logits, tgt)            # [B]
            w = ascore * fgf                       # quality-weighted reg
            l_iou = torch.sum(D.giou_loss(pred_boxes, abox) * w, -1)
            # DFL target: the gt box as l/t/r/b bin distances at the cell
            ltrb_t = torch.cat([pts - abox[..., :2], abox[..., 2:] - pts],
                               -1) / sts[:, None]
            l_dfl = torch.sum(D.distribution_focal_loss(reg_dist, ltrb_t)
                              * w[..., None], dim=(-2, -1))
            denom = torch.clamp(torch.sum(w, -1), min=1.0)
            wv, wi, wd = loss_weights
            return (wv * torch.mean(l_vfl / denom)
                    + wi * torch.mean(l_iou / denom)
                    + wd * torch.mean(l_dfl / (denom * 4.0)))

        flat_outs = [t for pair in outs for t in pair]
        return apply_op(pure, gt_boxes, gt_labels, gt_mask, *flat_outs)

    def decode(self, outs, conf_thresh=0.0):
        """-> (boxes [B, A, 4] xyxy px, scores [B, A, C]); traceable
        (compose with ``vision.ops.nms_static`` for a served graph).

        Sub-threshold scores are attenuated (x1e-4), not zeroed: zeroing
        would make mass ties in the NMS sort, while suppressed boxes still
        sort behind every real detection."""
        flatten, boxes_of = self._flatten_raw, self._boxes

        def pure(*raw):
            cl, rd, pts, sts = flatten(raw)
            boxes = boxes_of(rd, pts, sts)
            scores = torch.sigmoid(cl)
            if conf_thresh:
                scores = torch.where(scores >= conf_thresh, scores,
                                     scores * 1e-4)
            return boxes, scores

        flat_outs = [t for pair in outs for t in pair]
        return apply_op(pure, *flat_outs)


class PPYOLOELite(nn.Layer):
    """Legacy anchor-based lite detector (the ``yolo_box`` decode path; the
    full model is PPYOLOE)."""

    def __init__(self, num_classes=80, width=32, num_anchors=3):
        super().__init__()
        w = width
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.backbone = CSPBackbone(w)
        self.lat5 = ConvBNAct(w * 16, w * 8, 1)
        self.lat4 = ConvBNAct(w * 16, w * 4, 1)
        out_ch = num_anchors * (5 + num_classes)
        self.head32 = nn.Conv2D(w * 8, out_ch, 1)
        self.head16 = nn.Conv2D(w * 4, out_ch, 1)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        p5 = self.lat5(c5)
        up = interpolate(p5, scale_factor=2, mode='nearest')
        p4 = self.lat4(concat([up, c4], axis=1))
        return self.head32(p5), self.head16(p4)

    def decode(self, outs, img_size, conf_thresh=0.25):
        from ..vision.ops import yolo_box
        anchors32 = [116, 90, 156, 198, 373, 326]
        anchors16 = [30, 61, 62, 45, 59, 119]
        b32, s32 = yolo_box(outs[0], img_size, anchors32, self.num_classes,
                            conf_thresh, downsample_ratio=32)
        b16, s16 = yolo_box(outs[1], img_size, anchors16, self.num_classes,
                            conf_thresh, downsample_ratio=16)
        return concat([b32, b16], axis=1), concat([s32, s16], axis=1)
