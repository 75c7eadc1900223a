"""Losses (port of ``paddle_tpu/nn/functional/loss.py``). Each casts its
tensor arguments by the AMP policy under the reference's op name
(``"cross_entropy"``, ``"bce"``, ``"bce_with_logits"``, ...) and
computes the reference's formula; ``reduction`` is ``"mean"``,
``"sum"`` or ``"none"``."""
from __future__ import annotations

import numpy as np
import torch

from ... import amp


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _norm(x, p=2.0, dim=-1, keepdim=False):
    return torch.linalg.vector_norm(x, ord=p, dim=dim, keepdim=keepdim)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis`` in float32 (or the log of
    ``input`` itself with ``use_softmax=False``). Hard labels (``[N]`` or
    ``[N, 1]``) skip ``ignore_index``; the mean divides by the kept
    labels (weighted: by their weights). Soft labels weigh the log
    probabilities directly."""
    logits, lab, *w = amp.amp_cast_inputs(
        "cross_entropy", [input, label] + ([weight] if weight is not None
                                           else []))
    lf = logits.float()
    lp = (torch.log_softmax(lf, dim=axis) if use_softmax
          else torch.log(torch.clamp(lf, min=1e-30)))
    n_classes = logits.shape[axis]
    if soft_label:
        soft = lab
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        if w:
            wshape = [1] * lp.ndim
            wshape[axis % lp.ndim] = -1
            soft = soft * w[0].reshape(wshape)
        return _reduce(-(soft * lp).sum(dim=axis), reduction)
    idx = lab.long()
    if idx.ndim == lp.ndim:
        idx = idx.squeeze(axis)
    ignored = idx == ignore_index
    safe = torch.where(ignored, 0, idx)
    picked = torch.take_along_dim(lp, safe.unsqueeze(-1), dim=axis)[..., 0]
    if label_smoothing > 0:
        loss = (-(1 - label_smoothing) * picked
                - label_smoothing * lp.mean(dim=axis))
    else:
        loss = -picked
    mask = ~ignored
    loss = torch.where(mask, loss, 0.0)
    if w:
        cw = torch.where(mask, w[0][safe], 0.0)
        loss = loss * cw
        if reduction == "mean":
            return loss.sum() / torch.clamp(cw.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(-1)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``input`` holds log-probabilities ``[N, C, d1, ...]`` (class axis
    1)."""
    lp, lab, *w = amp.amp_cast_inputs(
        "nll_loss", [input, label] + ([weight] if weight is not None
                                      else []))
    lp = lp.float()
    idx = lab.long()
    safe = torch.where(idx == ignore_index, 0, idx)
    if lp.ndim > 1:
        loss = -lp.gather(1, safe.unsqueeze(1)).squeeze(1)
    else:
        loss = -lp[safe]
    mask = idx != ignore_index
    loss = torch.where(mask, loss, 0.0)
    if w:
        cw = w[0][safe] * mask.float()
        if reduction == "mean":
            return (loss * cw).sum() / torch.clamp(cw.sum(), min=1e-30)
        loss = loss * cw
    elif reduction == "mean":
        return loss.sum() / torch.clamp(mask.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    a, b = amp.amp_cast_inputs("mse_loss", [input, label])
    return _reduce((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    a, b = amp.amp_cast_inputs("l1_loss", [input, label])
    return _reduce((a - b).abs(), reduction)


def _smooth_l1(a, b, delta, reduction):
    d = (a - b).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    a, b = amp.amp_cast_inputs("smooth_l1_loss", [input, label])
    return _smooth_l1(a, b, delta, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    """Paddle's argument order; the Huber form is ``smooth_l1_loss``."""
    return smooth_l1_loss(input, label, reduction, delta)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    mu, y, var = amp.amp_cast_inputs("gaussian_nll_loss",
                                     [input, label, variance])
    var = torch.clamp(var, min=epsilon)
    loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
    if full:
        loss = loss + 0.5 * float(np.log(2 * np.pi))
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p, y, *w = amp.amp_cast_inputs(
        "bce", [input, label] + ([weight] if weight is not None else []))
    p_ = torch.clamp(p, 1e-12, 1 - 1e-7)
    loss = -(y * torch.log(p_) + (1 - y) * torch.log1p(-p_))
    if w:
        loss = loss * w[0]
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(z, 0) - z y + log(1 + exp(-|z|))``, with
    ``pos_weight`` scaling the positive term."""
    z, y, *rest = amp.amp_cast_inputs(
        "bce_with_logits", [logit, label] + [t for t in (weight, pos_weight)
                                             if t is not None])
    it = iter(rest)
    w = next(it) if weight is not None else None
    pw = next(it) if pos_weight is not None else None
    soft = torch.log1p(torch.exp(-z.abs()))
    if pw is not None:
        loss = (1 - y) * z + ((pw - 1) * y + 1) * (soft + torch.clamp(-z,
                                                                      min=0))
    else:
        loss = torch.clamp(z, min=0) - z * y + soft
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    lp, y = amp.amp_cast_inputs("kl_div", [input, label])
    tgt = torch.exp(y) if log_target else y
    logt = y if log_target else torch.log(torch.clamp(y, min=1e-30))
    loss = tgt * (logt - lp)
    if reduction == "batchmean":
        return loss.sum() / lp.shape[0]
    return _reduce(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    a, b = amp.amp_cast_inputs("cosine_similarity", [x1, x2])
    dot = (a * b).sum(dim=axis)
    return dot / torch.clamp(_norm(a, dim=axis) * _norm(b, dim=axis), min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = amp.amp_cast_inputs("cosine_embedding_loss",
                                  [input1, input2, label])
    cos = (a * b).sum(-1) / torch.clamp(_norm(a) * _norm(b), min=1e-12)
    loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = amp.amp_cast_inputs("margin_ranking_loss", [input, other, label])
    return _reduce(torch.clamp(-y * (a - b) + margin, min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    a, y = amp.amp_cast_inputs("hinge_embedding_loss", [input, label])
    return _reduce(torch.where(y == 1, a, torch.clamp(margin - a, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = amp.amp_cast_inputs("triplet_margin_loss",
                                      [input, positive, negative])
    dp = _norm(a - pos + epsilon, p)
    dn = _norm(a - neg + epsilon, p)
    if swap:
        dn = torch.minimum(dn, _norm(pos - neg + epsilon, p))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, *n = amp.amp_cast_inputs(
        "sigmoid_focal_loss", [logit, label] + ([normalizer] if normalizer
                                                is not None else []))
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if n:
        loss = loss / n[0]
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    a, b = amp.amp_cast_inputs("square_error_cost", [input, label])
    return (a - b).square()


def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = amp.amp_cast_inputs("log_loss", [input, label])
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the log-space forward (alpha) recursion over time, on
    ``log_probs [T, B, C]`` (log-softmaxed again in float32) and
    ``labels [B, L]``; differentiated by autograd. ``"mean"`` divides each
    sample's loss by its label length first, as the reference does."""
    lp, lab, in_len, lab_len = amp.amp_cast_inputs(
        "ctc_loss", [log_probs, labels, input_lengths, label_lengths])
    T, B, _ = lp.shape
    lp = torch.log_softmax(lp.float(), dim=-1)
    L = lab.shape[1]
    S = 2 * L + 1
    lab = lab.long()
    dev = lp.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    skip_ok = torch.zeros((B, S), dtype=torch.bool, device=dev)
    if L > 1:
        skip_ok[:, 3::2] = lab[:, 1:] != lab[:, :-1]
    neg = torch.full((B, 1), -1e30, device=dev)
    rows = torch.arange(B, device=dev)
    first = lp[0].gather(1, ext[:, :2])
    alpha = torch.cat([first, neg.expand(B, S - first.shape[1])], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        prev = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, -1e30)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev), prev2)
        alpha = merged + torch.gather(lp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    tt = torch.clamp(in_len.long() - 1, 0, T - 1)
    at_t = alphas[tt, rows]
    s_last = torch.clamp(2 * lab_len.long(), 0, S - 1)
    s_prev = torch.clamp(2 * lab_len.long() - 1, 0, S - 1)
    loss = -torch.logaddexp(at_t.gather(1, s_last[:, None])[:, 0],
                            at_t.gather(1, s_prev[:, None])[:, 0])
    if norm_by_times:
        loss = loss / torch.clamp(in_len.float(), min=1.0)
    if reduction == "mean":
        loss = loss / torch.clamp(lab_len.float(), min=1.0)
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross entropy over ``anchor @ positive.T`` against the same-label
    distribution, plus ``0.25 * l2_reg`` times the embeddings' mean
    squared norm."""
    a, p, y = amp.amp_cast_inputs("npair_loss", [anchor, positive, labels])
    l2 = 0.25 * l2_reg * ((a * a).sum() + (p * p).sum()) / a.shape[0]
    sim = a @ p.T
    yv = y.reshape(-1)
    same = (yv[:, None] == yv[None, :]).float()
    tgt = same / torch.clamp(same.sum(-1, keepdim=True), min=1)
    logp = torch.log_softmax(sim.float(), dim=-1)
    return -(tgt * logp).sum(-1).mean() + l2


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - Dice``: ``input`` holds class probabilities, ``label`` the
    class ids with a trailing axis of 1."""
    p, y = amp.amp_cast_inputs("dice_loss", [input, label])
    yv = torch.nn.functional.one_hot(
        y.reshape(p.shape[:-1]).long(), p.shape[-1]).to(p.dtype)
    red = tuple(range(1, p.ndim))
    inter = (p * yv).sum(red)
    union = p.sum(red) + yv.sum(red)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The ArcFace family's margin softmax: ``cos(m1 theta + m2) - m3`` on
    the target class, every logit times ``scale``. ``group`` must be
    None (no model-parallel classes)."""
    lg, y = amp.amp_cast_inputs("margin_cross_entropy", [logits, label])
    cos = torch.clamp(lg.float(), -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    yh = torch.nn.functional.one_hot(y.reshape(-1).long(),
                                     lg.shape[-1]).to(cos.dtype)
    adj = scale * torch.where(yh > 0, target, cos)
    ce = -(yh * torch.log_softmax(adj, dim=-1)).sum(-1)
    sm = torch.softmax(adj, dim=-1)
    ce = {"mean": ce.mean, "sum": ce.sum, "none": lambda: ce}[reduction]()
    return (ce, sm) if return_softmax else ce


def _adaptive_args(input_, head_weight, tail_weights, cutoffs, head_bias,
                   label=None):
    if len(tail_weights) != len(cutoffs) - 1:
        raise ValueError(
            f"adaptive softmax: {len(tail_weights)} tail cluster(s) for "
            f"cutoffs {cutoffs} — expected len(cutoffs)-1")
    args = [input_] + ([label] if label is not None else []) + [head_weight]
    if head_bias is not None:
        args.append(head_bias)
    for pair in tail_weights:
        args.extend(pair)
    return args


def _head_and_tails(x, hw, rest, has_bias):
    hb = rest[0] if has_bias else None
    off = 1 if has_bias else 0
    tails = [(rest[j], rest[j + 1]) for j in range(off, len(rest), 2)]
    head = x @ hw
    if hb is not None:
        head = head + hb
    return torch.log_softmax(head.float(), dim=-1), tails


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax: ``head_weight [in, c0 + K]`` scores the first
    ``cutoffs[0]`` classes and K cluster tokens, ``tail_weights[k]`` is a
    ``[[in, h], [h, size]]`` pair for cluster k. Returns ``(output,
    loss)``: each sample's target log-probability and their mean NLL.
    Labels outside ``[0, n_classes)`` raise."""
    cuts = [0] + list(cutoffs)
    c0, n_classes = cuts[1], cuts[-1]
    lv = torch.as_tensor(label).reshape(-1)
    if lv.numel() and (int(lv.min()) < 0 or int(lv.max()) >= n_classes):
        raise ValueError(
            f"adaptive_log_softmax_with_loss: label values must be in "
            f"[0, {n_classes}); got [{int(lv.min())}, {int(lv.max())}]")
    x, y, hw, *rest = amp.amp_cast_inputs(
        "adaptive_log_softmax_with_loss",
        _adaptive_args(input, head_weight, tail_weights, cutoffs, head_bias,
                       label=label))
    head_lp, tails = _head_and_tails(x, hw, rest, head_bias is not None)
    yv = y.reshape(-1).long()
    out = head_lp.gather(1, torch.clamp(yv, 0, c0 - 1)[:, None])[:, 0]
    for k, (w1, w2) in enumerate(tails):
        lo, hi = cuts[k + 1], cuts[k + 2]
        tail_lp = torch.log_softmax(((x @ w1) @ w2).float(), dim=-1)
        t = tail_lp.gather(1, torch.clamp(yv - lo, 0, hi - lo - 1)[:, None])
        out = torch.where((yv >= lo) & (yv < hi),
                          head_lp[:, c0 + k] + t[:, 0], out)
    return out, -out.mean()


def adaptive_log_softmax_log_prob(input, head_weight, tail_weights, cutoffs,
                                  head_bias=None, name=None):
    """The adaptive softmax's full ``[N, n_classes]`` log-distribution."""
    c0 = cutoffs[0]
    x, hw, *rest = amp.amp_cast_inputs(
        "adaptive_log_softmax_log_prob",
        _adaptive_args(input, head_weight, tail_weights, cutoffs, head_bias))
    head_lp, tails = _head_and_tails(x, hw, rest, head_bias is not None)
    parts = [head_lp[:, :c0]]
    for k, (w1, w2) in enumerate(tails):
        tail_lp = torch.log_softmax(((x @ w1) @ w2).float(), dim=-1)
        parts.append(head_lp[:, c0 + k][:, None] + tail_lp)
    return torch.cat(parts, dim=-1)


__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
           "gaussian_nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "cosine_similarity",
           "cosine_embedding_loss", "margin_ranking_loss",
           "hinge_embedding_loss", "triplet_margin_loss",
           "sigmoid_focal_loss", "square_error_cost", "log_loss", "ctc_loss",
           "npair_loss", "dice_loss", "margin_cross_entropy",
           "adaptive_log_softmax_with_loss", "adaptive_log_softmax_log_prob"]
