"""Loss functionals. Port of ``paddle_tpu/nn/functional/loss.py``: the
reference's formulas over torch tensors (labels index with their value
modulo the class count, as ``jnp.take_along_axis`` does, and ignored
entries are masked after)."""
import torch

from ...core.dispatch import apply_op, op
from ...core.tensor import Tensor

__all__ = ['cross_entropy', 'softmax_with_cross_entropy', 'mse_loss',
           'l1_loss', 'smooth_l1_loss', 'nll_loss', 'binary_cross_entropy',
           'binary_cross_entropy_with_logits', 'kl_div',
           'margin_ranking_loss', 'hinge_embedding_loss',
           'cosine_embedding_loss', 'triplet_margin_loss',
           'square_error_cost', 'sigmoid_focal_loss', 'npair_loss',
           'ctc_loss_fn', 'ctc_loss', 'dice_loss', 'log_loss']


def _reduce(out, reduction):
    if reduction == 'mean':
        return torch.mean(out)
    if reduction == 'sum':
        return torch.sum(out)
    return out


def _pick(logp, lbl, axis):
    """logp's entry at each label along ``axis`` (label modulo the class
    count), the axis dropped."""
    n = logp.shape[axis]
    idx = torch.remainder(lbl.long(), n).unsqueeze(axis)
    return torch.gather(logp, axis, idx).squeeze(axis)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@op
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    axis = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis)
        return _reduce(loss, reduction)
    lbl = label.to(torch.int32)
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    loss = -_pick(logp, lbl, axis)
    valid = lbl != ignore_index
    loss = torch.where(valid, loss, _zero(loss))
    if weight is not None:
        w = weight[torch.remainder(lbl.long(), logp.shape[axis])]
        w = torch.where(valid, w, _zero(w))
        loss = loss * w
        if reduction == 'mean':
            return torch.sum(loss) / torch.clamp_min(torch.sum(w), 1e-9)
    if reduction == 'mean':
        return torch.sum(loss) / torch.clamp_min(
            torch.sum(valid.to(loss.dtype)), 1.0)
    return _reduce(loss, reduction)


@op
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label.to(torch.int32)
        if lbl.dim() == logp.dim():
            lbl = lbl.squeeze(axis)
        loss = -_pick(logp, lbl, axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@op
def mse_loss(input, label, reduction='mean', name=None):
    return _reduce(torch.square(input - label), reduction)


@op
def l1_loss(input, label, reduction='mean', name=None):
    return _reduce(torch.abs(input - label), reduction)


@op
def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    d = input - label
    loss = torch.where(torch.abs(d) < delta, 0.5 * d * d,
                       delta * (torch.abs(d) - 0.5 * delta))
    return _reduce(loss, reduction)


@op
def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean',
             name=None):
    lbl = label.to(torch.int32)
    loss = -_pick(input, lbl, 1)
    valid = lbl != ignore_index
    if weight is not None:
        w = weight[torch.remainder(lbl.long(), input.shape[1])]
        loss = loss * w
        if reduction == 'mean':
            return (torch.sum(torch.where(valid, loss, _zero(loss)))
                    / torch.clamp_min(torch.sum(torch.where(valid, w,
                                                            _zero(w))),
                                      1e-9))
    loss = torch.where(valid, loss, _zero(loss))
    return _reduce(loss, reduction)


@op
def binary_cross_entropy(input, label, weight=None, reduction='mean',
                         name=None):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None,
                                     name=None):
    max_val = torch.clamp_min(-logit, 0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1 - label) * logit + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def kl_div(input, label, reduction='mean', name=None):
    loss = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == 'batchmean':
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op
def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean',
                        name=None):
    loss = torch.clamp_min(-label * (input - other) + margin, 0)
    return _reduce(loss, reduction)


@op
def hinge_embedding_loss(input, label, margin=1.0, reduction='mean',
                         name=None):
    loss = torch.where(label == 1, input, torch.clamp_min(margin - input, 0))
    return _reduce(loss, reduction)


@op
def cosine_embedding_loss(input1, input2, label, margin=0, reduction='mean',
                          name=None):
    cos = torch.sum(input1 * input2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0))
    return _reduce(loss, reduction)


@op
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction='mean',
                        name=None):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                                   -1), 1 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


@op
def square_error_cost(input, label):
    return torch.square(input - label)


@op
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction='sum', name=None):
    p = torch.sigmoid(logit)
    ce = (torch.clamp_min(logit, 0) - logit * label
          + torch.log1p(torch.exp(-torch.abs(logit))))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * torch.pow(1 - p_t, gamma)
    if alpha >= 0:
        loss = loss * (alpha * label + (1 - alpha) * (1 - label))
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@op
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = torch.matmul(anchor, positive.T)
    lbl = labels.reshape(-1, 1)
    tgt = (lbl == lbl.T).to(anchor.dtype)
    tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
    logp = torch.log_softmax(sim, dim=1)
    ce = -torch.mean(torch.sum(tgt * logp, dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1))
                    + torch.mean(torch.sum(torch.square(positive), 1))) * 0.25
    return ce + reg


@op
def ctc_loss_fn(log_probs, labels, input_lengths, label_lengths, blank=0):
    """CTC forward (the log-alpha recursion). log_probs: [T, B, C]
    log-softmax scores."""
    T, B, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = torch.full((), -1e30, dtype=log_probs.dtype, device=dev)

    emit0 = torch.gather(log_probs[0], 1, ext)                     # [B, S]
    alpha = torch.cat([emit0[:, :2], neg_inf.expand(B, S - 2)], dim=1)
    same = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        emit = torch.gather(log_probs[t], 1, ext)
        a1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], dim=1)
        a2 = torch.where(same, neg_inf, a2)
        alpha = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + emit
        alphas.append(alpha)
    alphas = torch.stack(alphas)                                    # [T,B,S]
    t_idx = input_lengths.long() - 1
    a_final = alphas[t_idx, torch.arange(B, device=dev)]            # [B, S]
    s_last = 2 * label_lengths.long()
    ll_blank = torch.gather(a_final, 1, s_last[:, None])[:, 0]
    ll_label = torch.gather(a_final, 1, torch.clamp_min(s_last - 1, 0)[:, None])[:, 0]
    return -torch.logaddexp(ll_blank, ll_label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean'):
    from .activation import log_softmax
    lp = log_softmax(log_probs, axis=-1)
    loss = ctc_loss_fn(lp, labels, input_lengths, label_lengths, blank=blank)
    if reduction == 'mean':
        ll = (label_lengths._value if isinstance(label_lengths, Tensor)
              else torch.as_tensor(label_lengths))
        return apply_op(lambda l: torch.mean(
            l / torch.clamp_min(ll.to(device=l.device, dtype=l.dtype), 1)),
            loss)
    if reduction == 'sum':
        return apply_op(torch.sum, loss)
    return loss


@op
def dice_loss(input, label, epsilon=1e-05, name=None):
    lbl = torch.nn.functional.one_hot(label.squeeze(-1).long(),
                                      input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = 2 * torch.sum(input * lbl, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(lbl, dim=dims)
    return torch.mean(1 - (inter + epsilon) / (union + epsilon))


@op
def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))
