"""Loss layers (port of ``paddle_tpu/nn/layers/loss.py``): each calls its
functional with the options it was made with."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index, self.reduction = ignore_index, reduction
        self.soft_label, self.axis = soft_label, axis
        self.use_softmax, self.label_smoothing = use_softmax, label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)


class _Reduced(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class MSELoss(_Reduced):
    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Reduced):
    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(_Reduced):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction)
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class HuberLoss(_Reduced):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction)
        self.delta = delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self.delta, self.reduction)


class GaussianNLLLoss(_Reduced):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__(reduction)
        self.full, self.epsilon = full, epsilon

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class NLLLoss(_Reduced):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.weight, self.ignore_index = weight, ignore_index

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(_Reduced):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(_Reduced):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(reduction)
        self.weight, self.pos_weight = weight, pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(_Reduced):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction)
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class MarginRankingLoss(_Reduced):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(_Reduced):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class HingeEmbeddingLoss(_Reduced):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax over frequency-sorted classes; ``forward`` returns
    ``(output, loss)``. ``cutoffs`` are unique increasing ints in ``(0,
    n_classes]`` (``n_classes`` is appended when missing); cluster ``k``'s
    projection is ``in_features // div_value ** (k + 1)`` wide."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = [int(c) for c in cutoffs]
        if (not cutoffs or cutoffs != sorted(set(cutoffs))
                or cutoffs[0] <= 0 or cutoffs[-1] > n_classes):
            raise ValueError(
                "cutoffs must be unique increasing ints in (0, n_classes]")
        if cutoffs[-1] != n_classes:
            cutoffs = cutoffs + [n_classes]
        self.in_features, self.n_classes = in_features, n_classes
        self.cutoffs, self.div_value = cutoffs, div_value
        n_clusters = len(cutoffs) - 1
        self.head_weight = self.create_parameter(
            (in_features, cutoffs[0] + n_clusters))
        self.head_bias = self.create_parameter(
            (cutoffs[0] + n_clusters,), is_bias=True) if head_bias else None
        self.tail_weights = []
        for k in range(n_clusters):
            hsz = max(1, int(in_features // (div_value ** (k + 1))))
            pair = [self.create_parameter((in_features, hsz)),
                    self.create_parameter((hsz, cutoffs[k + 1] - cutoffs[k]))]
            self.tail_weights.append(pair)
            self.add_parameter(f"tail_{k}_proj", pair[0])
            self.add_parameter(f"tail_{k}_out", pair[1])

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            head_bias=self.head_bias)

    def log_prob(self, input):
        return F.adaptive_log_softmax_log_prob(
            input, self.head_weight, self.tail_weights, self.cutoffs,
            head_bias=self.head_bias)

    def predict(self, input):
        return self.log_prob(input).argmax(dim=-1)


__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "MarginRankingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
           "HingeEmbeddingLoss", "HuberLoss", "GaussianNLLLoss",
           "AdaptiveLogSoftmaxWithLoss"]
