"""paddle_tpu.metric (reference python/paddle/metric/metrics.py)."""

import numpy as np


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return type(self).__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()
        self._name = name or "acc"

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        pred = np.asarray(pred)
        label = np.asarray(label)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        topk_idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        correct = topk_idx == label[..., None]
        return correct

    def update(self, correct):
        correct = np.asarray(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = correct[..., :k].sum()
            self.total[i] += float(num)
            self.count[i] += int(np.prod(correct.shape[:-1]))
            accs.append(float(num) / max(int(np.prod(correct.shape[:-1])), 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        self.reset()
        self._name = name or "precision"

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds) > 0.5).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self.reset()
        self._name = name or "recall"

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds) > 0.5).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        self.reset()
        self._name = name or "auc"

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        if preds.ndim == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = (pos_prob * self.num_thresholds).astype(int)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, l in zip(bins, labels):
            if l:
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
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    from ..core.tensor import Tensor
    pred = np.asarray(input)   # a Tensor's host copy, bf16 as float32
    lab = np.asarray(label)
    if lab.ndim == pred.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    topk_idx = np.argsort(-pred, axis=-1)[..., :k]
    correct = (topk_idx == lab[..., None]).any(-1).mean()
    return Tensor(np.asarray(correct, dtype=np.float32))
