"""fleet.metrics: metrics reduced over the world's ranks.

Port of ``paddle_tpu/distributed/fleet/metrics.py:1-74`` (reference:
python/paddle/distributed/fleet/metrics/metric.py). Each statistic is
all-reduced over the world in float64 on the host (a CPU tensor over the
default group: gloo carries float64 there), so counts above 2^24 stay
exact; one process is the identity.
"""
import numpy as np
import torch

__all__ = ['sum', 'max', 'min', 'auc', 'mae', 'rmse', 'mse', 'acc']


def _reduce(value, mode):
    from .. import collective
    if hasattr(value, 'numpy'):
        value = value.numpy()
    arr = np.asarray(value, dtype='float64')
    grp = collective.world_group()
    if grp is None or grp.nranks == 1:
        return arr
    t = torch.from_numpy(np.array(arr, dtype='float64', ndmin=1))
    if grp.backend != 'gloo':
        # NCCL carries CUDA tensors only
        t = t.cuda()
    out = collective.reduce_tensor(t, grp, mode).cpu().numpy()
    return out.reshape(arr.shape)


def sum(input, scope=None, util=None):
    return _reduce(input, 'sum')


def max(input, scope=None, util=None):
    return _reduce(input, 'max')


def min(input, scope=None, util=None):
    return _reduce(input, 'min')


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from per-worker positive/negative score histograms."""
    pos = _reduce(stat_pos, 'sum').astype('float64')
    neg = _reduce(stat_neg, 'sum').astype('float64')
    # trapezoidal accumulation over score buckets, highest bucket first
    area = 0.0
    tp = fp = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + float(pos[i])
        new_fp = fp + float(neg[i])
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    if tp == 0 or fp == 0:
        return 0.5
    return area / (tp * fp)


def mae(abserr, total_ins_num, scope=None, util=None):
    return float(_reduce(abserr, 'sum').sum()) / float(
        _reduce(total_ins_num, 'sum').sum())


def mse(sqrerr, total_ins_num, scope=None, util=None):
    return float(_reduce(sqrerr, 'sum').sum()) / float(
        _reduce(total_ins_num, 'sum').sum())


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def acc(correct, total, scope=None, util=None):
    return float(_reduce(correct, 'sum').sum()) / float(
        _reduce(total, 'sum').sum())

