"""paddle.metric (port of ``paddle_tpu/metric/__init__.py``): ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.
They count on the host in numpy, as the reference's do: a tensor argument
is read back (``numpy(force=True)``) once a call."""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.numpy(force=True) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _like(arr, ref):
    """``arr`` as a tensor on ``ref``'s device (the CPU for an array)."""
    t = torch.from_numpy(arr)
    return t.to(ref.device) if isinstance(ref, torch.Tensor) else t


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``: ``compute`` marks which of
    the ``max(topk)`` best classes is the label, ``update`` adds a batch."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = (idx == label_np[..., None])
        return _like(correct.astype(np.float32), pred)

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += c.shape[0] if c.ndim > 1 else 1
            accs.append(self.total[i] / max(self.count[i], 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    """Binary precision over predictions and labels thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, lab = _np(preds) > 0.5, _np(labels) > 0.5
        self.tp += int(np.sum(p & lab))
        self.fp += int(np.sum(p & ~lab))

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    """Binary recall over predictions and labels thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, lab = _np(preds) > 0.5, _np(labels) > 0.5
        self.tp += int(np.sum(p & lab))
        self.fn += int(np.sum(~p & lab))

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` buckets of the positive class's
    score."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p, lab = _np(preds), _np(labels)
        if p.ndim == 2:
            p = p[:, -1]
        lab = lab.reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` best classes, an
    fp32 scalar tensor on ``input``'s device."""
    pred, lab = _np(input), _np(label)
    if lab.ndim == 2 and lab.shape[1] == 1:
        lab = lab[:, 0]
    topk_idx = np.argsort(-pred, axis=-1)[:, :k]
    correct_ = (topk_idx == lab[:, None]).any(axis=1)
    return _like(np.asarray(correct_.mean(), np.float32), input)


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
