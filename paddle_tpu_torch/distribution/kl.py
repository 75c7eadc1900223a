"""The KL registry and its closed forms (port of
``paddle_tpu/distribution/kl.py``): ``register_kl`` registers a function
for a pair of types; ``kl_divergence`` picks the registered pair nearest
to the arguments' types along their MROs."""
from __future__ import annotations

import math

import torch

from . import families as F

_REGISTRY = {}


def register_kl(p_cls, q_cls):
    """Decorator: ``fn(p, q) -> Tensor`` for ``(type(p), type(q))``."""
    def deco(fn):
        _REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p, q):
    best, depth = None, None
    for (pc, qc), fn in _REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            d = (type(p).__mro__.index(pc), type(q).__mro__.index(qc))
            if depth is None or d < depth:
                best, depth = fn, d
    if best is None:
        raise NotImplementedError(
            f"no KL registered for ({type(p).__name__}, {type(q).__name__}); "
            "use register_kl to add one")
    return best(p, q)


def _kl_gauss(pl, ps, ql, qs):
    var_ratio = (ps / qs) ** 2
    t1 = ((pl - ql) / qs) ** 2
    return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


@register_kl(F.Normal, F.Normal)
def _kl_normal(p, q):
    return _kl_gauss(p.loc, p.scale, q.loc, q.scale)


@register_kl(F.Uniform, F.Uniform)
def _kl_uniform(p, q):
    pa, pb, qa, qb = p.low, p.high, q.low, q.high
    out = torch.log((qb - qa) / (pb - pa))
    return torch.where((qa <= pa) & (pb <= qb), out,
                       torch.full((), math.inf, device=out.device))


@register_kl(F.Bernoulli, F.Bernoulli)
def _kl_bernoulli(p, q):
    eps = 1e-7
    pp = p.probs_param.clamp(eps, 1 - eps)
    qp = q.probs_param.clamp(eps, 1 - eps)
    return (pp * (torch.log(pp) - torch.log(qp))
            + (1 - pp) * (torch.log1p(-pp) - torch.log1p(-qp)))


@register_kl(F.Categorical, F.Categorical)
def _kl_categorical(p, q):
    plog = torch.log_softmax(p.logits, dim=-1)
    qlog = torch.log_softmax(q.logits, dim=-1)
    return (torch.exp(plog) * (plog - qlog)).sum(-1)


@register_kl(F.Beta, F.Beta)
def _kl_beta(p, q):
    pa, pb, qa, qb = p.alpha, p.beta, q.alpha, q.beta
    dg = torch.digamma
    return (F._lbeta(qa, qb) - F._lbeta(pa, pb)
            + (pa - qa) * dg(pa) + (pb - qb) * dg(pb)
            + (qa - pa + qb - pb) * dg(pa + pb))


@register_kl(F.Gamma, F.Gamma)
def _kl_gamma(p, q):
    pc, pr, qc, qr = p.concentration, p.rate, q.concentration, q.rate
    return ((pc - qc) * torch.digamma(pc) - torch.lgamma(pc)
            + torch.lgamma(qc) + qc * (torch.log(pr) - torch.log(qr))
            + pc * (qr - pr) / pr)


@register_kl(F.Dirichlet, F.Dirichlet)
def _kl_dirichlet(p, q):
    pc, qc = p.concentration, q.concentration
    p0, q0 = pc.sum(-1), qc.sum(-1)
    return (torch.lgamma(p0) - torch.lgamma(q0)
            - (torch.lgamma(pc) - torch.lgamma(qc)).sum(-1)
            + ((pc - qc) * (torch.digamma(pc)
                            - torch.digamma(p0)[..., None])).sum(-1))


@register_kl(F.Exponential, F.Exponential)
def _kl_exponential(p, q):
    ratio = q.rate / p.rate
    return ratio - 1 - torch.log(ratio)


@register_kl(F.Laplace, F.Laplace)
def _kl_laplace(p, q):
    # log(b2/b1) + |u1-u2|/b2 + (b1/b2) exp(-|u1-u2|/b1) - 1
    pl, ps, ql, qs = p.loc, p.scale, q.loc, q.scale
    adiff = torch.abs(pl - ql)
    return (torch.log(qs / ps) + adiff / qs
            + (ps / qs) * torch.exp(-adiff / ps) - 1.0)


@register_kl(F.Geometric, F.Geometric)
def _kl_geometric(p, q):
    pp, qp = p.probs_param, q.probs_param
    return (-(1 - pp) / pp * (torch.log1p(-qp) - torch.log1p(-pp))
            + torch.log(pp) - torch.log(qp))


@register_kl(F.MultivariateNormal, F.MultivariateNormal)
def _kl_mvn(p, q):
    pl, pst, ql, qst = p.loc, p.scale_tril, q.loc, q.scale_tril
    d = pl.shape[-1]
    half_logdet_p = torch.log(torch.diagonal(pst, dim1=-2, dim2=-1)).sum(-1)
    half_logdet_q = torch.log(torch.diagonal(qst, dim1=-2, dim2=-1)).sum(-1)
    batch = torch.broadcast_shapes(tuple(qst.shape[:-2]),
                                   tuple(pst.shape[:-2]))
    qb = qst.broadcast_to(tuple(batch) + tuple(qst.shape[-2:]))
    m = torch.linalg.solve_triangular(
        qb, pst.broadcast_to(tuple(batch) + tuple(pst.shape[-2:])),
        upper=False)
    tr = (m * m).sum((-2, -1))
    diff = ql - pl
    qd = qst.broadcast_to(tuple(diff.shape[:-1]) + tuple(qst.shape[-2:]))
    sol = torch.linalg.solve_triangular(qd, diff[..., None],
                                        upper=False)[..., 0]
    maha = (sol ** 2).sum(-1)
    return 0.5 * (2 * (half_logdet_q - half_logdet_p) - d + tr + maha)


@register_kl(F.LogNormal, F.LogNormal)
def _kl_lognormal(p, q):
    # the shared exp leaves the KL of the underlying Normals
    return _kl_gauss(p.loc, p.scale, q.loc, q.scale)


@register_kl(F.Poisson, F.Poisson)
def _kl_poisson(p, q):
    pr, qr = p.rate, q.rate
    return pr * (torch.log(pr) - torch.log(qr)) - pr + qr
