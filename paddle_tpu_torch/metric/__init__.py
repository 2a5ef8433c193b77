"""Metrics (port of ``paddle_tpu/metric/__init__.py``): the same values
as the reference's, computed on torch tensors where the inputs lie; the
running totals are host numbers, as the reference keeps them."""
import numpy as np
import torch

from ..core.dispatch import as_tensor
from ..core.tensor import Tensor, wrap


def _t(x):
    """A metric input as a torch tensor (Tensor, torch tensor or host
    data)."""
    return x._value if isinstance(x, Tensor) else as_tensor(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


def _topk_hits(pred, label, k):
    """[..., k] bool: whether each of the k largest predictions (ties to
    the lower index) is the label."""
    if label.dim() == pred.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    idx = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
    return idx == label.to(idx.dtype).unsqueeze(-1)


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or 'acc'
        self.reset()

    def compute(self, pred, label, *args):
        return wrap(_topk_hits(_t(pred), _t(label), self.maxk)
                    .to(torch.float32))

    def update(self, correct, *args):
        c = _t(correct)
        num = c.shape[0] if c.dim() > 0 else 1
        for i, k in enumerate(self.topk):
            # float32 totals, as the reference's numpy sums
            self.total[i] += np.float32(float(c[..., :k].sum()))
            self.count[i] += num
        res = [t / max(c_, 1e-12) for t, c_ in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0.0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f'{self._name}_top{k}' for k in self.topk]


def _binary(preds, labels):
    """(predicted positive, label positive) as flat bool tensors."""
    return (_t(preds) > 0.5).reshape(-1), \
        _t(labels).to(torch.int32).reshape(-1) == 1


def _positives(preds, labels):
    """[true positives, false positives, false negatives] as host ints, one
    read."""
    p, lab = _binary(preds, labels)
    return torch.stack([(p & lab).sum(), (p & ~lab).sum(),
                        (~p & lab).sum()]).tolist()


class Precision(Metric):
    def __init__(self, name='precision'):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        tp, fp, _ = _positives(preds, labels)
        self.tp += tp
        self.fp += fp

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name='recall'):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        tp, _, fn = _positives(preds, labels)
        self.tp += tp
        self.fn += fn

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve='ROC', num_thresholds=4095, name='auc'):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _t(preds)
        if p.dim() == 2:
            p = p[:, 1]
        lab = _t(labels).reshape(-1) != 0
        bins = (p * self.num_thresholds).to(torch.int64).clamp(
            0, self.num_thresholds)
        n = self.num_thresholds + 1
        self._stat_pos += torch.bincount(bins[lab], minlength=n).cpu() \
            .numpy()
        self._stat_neg += torch.bincount(bins[~lab], minlength=n).cpu() \
            .numpy()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the k largest predictions,
    as a float32 Tensor."""
    hit = _topk_hits(_t(input), _t(label), k).any(dim=-1)
    return wrap(hit.to(torch.float64).mean().to(torch.float32))
