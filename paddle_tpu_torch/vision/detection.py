"""PP-YOLOE-class detection machinery: TAL assignment, VFL/DFL/GIoU losses.
Port of ``paddle_tpu/vision/detection.py``.

Every stage has static shapes, as the reference's: ground truths ride as
a padded [M, ...] block with a validity mask, and assignment is a dense
[M, A] metric matrix, a top-k and an argmax (no per-gt loops, no boolean
gathers). The functions take and return plain torch tensors (a port
``Tensor`` or host data is taken too) and keep torch's autograd.
``pairwise_iou`` and ``task_aligned_assign`` also take leading batch
dims (``[..., N, 4]``), which the reference reaches through ``vmap``: the
detector's loss assigns a whole batch at once. Boxes are xyxy in input
pixels unless stated.
"""
import numpy as np
import torch

__all__ = ['pairwise_iou', 'giou_loss', 'varifocal_loss',
           'distribution_focal_loss', 'task_aligned_assign', 'dfl_decode',
           'anchor_points']


def as_torch(x, like=None):
    """``x`` as a torch tensor: a port Tensor's value, a torch tensor as it
    is, host data copied (float64 as float32) onto ``like``'s device, else
    the current device."""
    if isinstance(x, torch.Tensor):
        return x
    v = getattr(x, '_value', None)
    if isinstance(v, torch.Tensor):
        return v
    if like is not None:
        dev = like.device
    else:
        from ..device import current_device
        dev = current_device()
    t = torch.as_tensor(np.asarray(x), device=dev)
    return t.float() if t.dtype == torch.float64 else t


def sig_xent(logit, target):
    """Elementwise sigmoid cross-entropy, numerically stable (the one
    implementation behind VFL and ``vision.ops.yolo_loss``)."""
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def pairwise_iou(a, b, eps=1e-9):
    """a: [..., N, 4], b: [..., M, 4] xyxy -> IoU [..., N, M]."""
    a, b = as_torch(a), as_torch(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0.0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0.0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + eps)


def giou_loss(pred, target, eps=1e-9):
    """Generalized IoU loss per box pair: pred/target [..., 4] xyxy ->
    [...] in [0, 2]."""
    pred, target = as_torch(pred), as_torch(target)
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = torch.clamp((pred[..., 2] - pred[..., 0])
                         * (pred[..., 3] - pred[..., 1]), min=0.0)
    area_t = torch.clamp((target[..., 2] - target[..., 0])
                         * (target[..., 3] - target[..., 1]), min=0.0)
    union = area_p + area_t - inter + eps
    iou = inter / union
    # smallest enclosing box
    clt = torch.minimum(pred[..., :2], target[..., :2])
    crb = torch.maximum(pred[..., 2:], target[..., 2:])
    cwh = torch.clamp(crb - clt, min=0.0)
    c_area = cwh[..., 0] * cwh[..., 1] + eps
    return 1.0 - (iou - (c_area - union) / c_area)


def varifocal_loss(logits, gt_score, alpha=0.75, gamma=2.0):
    """Varifocal loss (PP-YOLOE's classification loss). logits: [..., A,
    C]; gt_score: the assigned quality target (0 off the assigned class).
    Positives are weighted by the target, negatives by alpha * p^gamma.
    -> the sum over the last two dims ([...], a scalar for one image)."""
    logits, gt_score = as_torch(logits), as_torch(gt_score)
    p = torch.sigmoid(logits)
    weight = torch.where(gt_score > 0, gt_score, alpha * torch.pow(p, gamma))
    loss = sig_xent(logits, gt_score) * weight
    return torch.sum(loss, dim=(-2, -1)) if loss.dim() > 2 else loss.sum()


def distribution_focal_loss(pred_dist, target):
    """DFL: pred_dist [..., reg_max+1] logits over integer bins; target
    [...] continuous in [0, reg_max]. Cross-entropy on the two adjacent
    bins, linearly weighted -> [...] loss."""
    pred_dist, target = as_torch(pred_dist), as_torch(target)
    reg_max = pred_dist.shape[-1] - 1
    t = torch.clamp(target, 0.0, reg_max - 1e-4)
    tl = torch.floor(t)
    wr = t - tl
    tl_i = tl.long()
    logp = torch.log_softmax(pred_dist, dim=-1)
    ll = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lr = torch.gather(logp, -1, (tl_i + 1)[..., None])[..., 0]
    return -(ll * (1.0 - wr) + lr * wr)


def dfl_decode(pred_dist):
    """[..., 4, reg_max+1] logits -> expected l/t/r/b distances [..., 4]
    (the softmax's expectation over the bin grid)."""
    pred_dist = as_torch(pred_dist)
    reg_max = pred_dist.shape[-1] - 1
    bins = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=pred_dist.device)
    return torch.softmax(pred_dist, -1) @ bins


def anchor_points(feat_sizes, strides, offset=0.5, device=None):
    """-> (points [A, 2] cell centers in input pixels, stride_per_anchor
    [A]) for a list of (H, W) feature sizes, on ``device`` (default the
    CPU)."""
    pts, sts = [], []
    for (h, w), s in zip(feat_sizes, strides):
        xs = (torch.arange(w, dtype=torch.float32, device=device) + offset) * s
        ys = (torch.arange(h, dtype=torch.float32, device=device) + offset) * s
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        sts.append(torch.full((h * w,), float(s), dtype=torch.float32,
                              device=device))
    return torch.cat(pts, 0), torch.cat(sts, 0)


def task_aligned_assign(cls_scores, pred_boxes, points, gt_boxes, gt_labels,
                        gt_mask, topk=9, alpha=1.0, beta=6.0, eps=1e-9):
    """Task-Aligned Assigner, static shapes (one image, or a batch over
    leading dims).

    cls_scores: [..., A, C] sigmoid scores; pred_boxes: [..., A, 4] xyxy;
    points: [A, 2] anchor centers; gt_boxes: [..., M, 4] xyxy (padded);
    gt_labels: [..., M] int; gt_mask: [..., M] bool (False = padding row).

    Returns (fg_mask [..., A] bool, assigned_label [..., A] int32 (-1 bg),
    assigned_box [..., A, 4], assigned_score [..., A]: the
    alignment-normalized quality target for VFL).

    Metric t = score^alpha * iou^beta over anchors whose center lies inside
    the gt; the top-k anchors of each gt are candidates; an anchor claimed
    by several gts goes to the one with the highest metric (dense argmax).
    """
    cls_scores, pred_boxes = as_torch(cls_scores), as_torch(pred_boxes)
    points = as_torch(points, cls_scores)
    gt_boxes = as_torch(gt_boxes, cls_scores).float()
    gt_labels = as_torch(gt_labels, cls_scores).long()
    gt_mask = as_torch(gt_mask, cls_scores).bool()
    A, C = cls_scores.shape[-2:]
    iou = pairwise_iou(gt_boxes, pred_boxes)                     # [.., M, A]
    safe = torch.clamp(gt_labels, 0, C - 1)
    scores_t = cls_scores.transpose(-1, -2)                      # [.., C, A]
    score_g = torch.gather(
        scores_t, -2, safe[..., None].expand(*safe.shape, A))    # [.., M, A]
    metric = torch.pow(score_g, alpha) * torch.pow(iou, beta)

    px, py = points[:, 0], points[:, 1]
    inside = ((px >= gt_boxes[..., :, None, 0])
              & (px <= gt_boxes[..., :, None, 2])
              & (py >= gt_boxes[..., :, None, 1])
              & (py <= gt_boxes[..., :, None, 3]))                # [.., M, A]
    valid = inside & gt_mask[..., None]
    metric = torch.where(valid, metric, torch.zeros_like(metric))

    k = min(int(topk), A)
    topv, topi = torch.topk(metric, k, dim=-1)                   # [.., M, k]
    cand = torch.zeros(metric.shape, dtype=torch.bool,
                       device=metric.device).scatter(-1, topi, topv > eps)
    metric_c = torch.where(cand, metric, torch.zeros_like(metric))

    # conflict resolution: each anchor belongs to the gt with max metric
    best_metric, best_gt = torch.max(metric_c, dim=-2)           # [.., A]
    fg = best_metric > eps

    assigned_label = torch.where(
        fg, torch.gather(gt_labels, -1, best_gt),
        torch.full_like(best_gt, -1)).to(torch.int32)
    assigned_box = torch.gather(
        gt_boxes, -2, best_gt[..., None].expand(*best_gt.shape, 4))

    # normalized quality target: each gt's best candidate carries its best
    # IoU
    iou_c = torch.where(cand, iou, torch.zeros_like(iou))
    per_gt_max_metric = torch.amax(metric_c, dim=-1, keepdim=True)
    per_gt_max_iou = torch.amax(iou_c, dim=-1, keepdim=True)
    norm = metric_c / torch.clamp(per_gt_max_metric, min=eps) * per_gt_max_iou
    picked = torch.gather(norm, -2, best_gt[..., None, :])[..., 0, :]
    assigned_score = torch.where(fg, picked, torch.zeros_like(picked))
    return fg, assigned_label, assigned_box, assigned_score
