"""Distribution families (port of ``paddle_tpu/distribution/families.py``):
the reference's formulas in torch, each family's mean, variance,
``log_prob``, ``entropy``, ``sample`` / ``rsample``, and ``cdf`` /
``icdf`` where the reference has them.

The conventions are the reference's, not ``torch.distributions``'s:
``Geometric`` counts failures before the first success (support 0, 1,
...); ``Categorical`` takes unnormalised logits; ``ContinuousBernoulli``
switches to its Taylor forms inside ``lims``; ``MultivariateNormal``
takes a covariance, a precision or a Cholesky factor; ``Multinomial``'s
entropy is a 256-draw Monte-Carlo estimate.

The closed-form samplers map noise drawn by the helpers below (normal,
uniform in ``[minval, maxval)``, exponential, Gumbel) as the reference's
maps ``jax.random``'s; Gamma, Beta, Dirichlet and StudentT draw standard
gammas (``torch._standard_gamma``, whose gradient in the concentration
is the implicit reparameterisation JAX's gamma also uses); Poisson,
Binomial, Bernoulli and the categorical draws are not differentiable.
Every draw comes from the port's generator of the parameters' device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .distribution import (
    Distribution, ExponentialFamily, _HALF_LOG_2PI, _bshape, _param,
    _shape_tuple,
)

_EULER = float(np.euler_gamma)


# -- noise: every draw of the closed-form samplers goes through these ------

def _normal(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def _uniform(shape, gen, device, minval=0.0, maxval=1.0):
    return torch.empty(shape, device=device).uniform_(minval, maxval,
                                                      generator=gen)


def _exponential(shape, gen, device):
    return torch.empty(shape, device=device).exponential_(generator=gen)


def _gumbel(shape, gen, device):
    u = _uniform(shape, gen, device, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def _standard_gamma(concentration, gen):
    return torch._standard_gamma(concentration, generator=gen)


class Normal(ExponentialFamily):
    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc.broadcast_to(self.batch_shape)

    @property
    def variance(self):
        return (self.scale ** 2).broadcast_to(self.batch_shape)

    def rsample(self, shape=()):
        eps = _normal(self._extend_shape(shape), self._gen(), self._device())
        return self.loc + self.scale * eps

    def log_prob(self, value):
        v, l, s = _param(value), self.loc, self.scale
        return -((v - l) ** 2) / (2.0 * s ** 2) - torch.log(s) - _HALF_LOG_2PI

    def entropy(self):
        return (0.5 + _HALF_LOG_2PI + torch.log(self.scale)).broadcast_to(
            self.batch_shape)


class Uniform(Distribution):
    """Support ``[low, high)``."""

    def __init__(self, low, high, name=None):
        self.low = _param(low)
        self.high = _param(high)
        super().__init__(_bshape(self.low, self.high))

    @property
    def mean(self):
        return (self.low + self.high) / 2.0

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12.0

    def rsample(self, shape=()):
        u = _uniform(self._extend_shape(shape), self._gen(), self._device())
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        a, b, v = self.low, self.high, _param(value)
        inside = (v >= a) & (v < b)
        return torch.where(inside, -torch.log(b - a),
                           torch.full((), -math.inf, device=v.device))

    def entropy(self):
        return torch.log(self.high - self.low)


class Bernoulli(ExponentialFamily):
    """``probs`` parameterisation."""

    def __init__(self, probs, name=None):
        self.probs_param = _param(probs)
        super().__init__(_bshape(self.probs_param))

    @property
    def mean(self):
        return self.probs_param.broadcast_to(self.batch_shape)

    @property
    def variance(self):
        p = self.probs_param
        return p * (1 - p)

    def sample(self, shape=()):
        full = self._extend_shape(shape)
        p = self.probs_param.detach().float().broadcast_to(full)
        return torch.bernoulli(p, generator=self._gen())

    rsample = sample

    def log_prob(self, value):
        pc = self.probs_param.clamp(1e-7, 1 - 1e-7)
        v = _param(value)
        return v * torch.log(pc) + (1 - v) * torch.log1p(-pc)

    def entropy(self):
        pc = self.probs_param.clamp(1e-7, 1 - 1e-7)
        return -(pc * torch.log(pc) + (1 - pc) * torch.log1p(-pc))


def _gumbel_argmax(logits, sample_shape, gen):
    """Categorical draws over the last axis of ``logits`` by the Gumbel
    max, as ``jax.random.categorical`` draws: ``sample_shape +
    logits.shape[:-1]`` int64 indices."""
    lg = logits.detach()
    g = _gumbel(tuple(sample_shape) + tuple(lg.shape), gen, lg.device)
    return torch.argmax(lg + g, dim=-1)


class Categorical(Distribution):
    """Unnormalised ``logits``; the last axis indexes the categories."""

    def __init__(self, logits, name=None):
        self.logits = _param(logits)
        self._num_categories = self.logits.shape[-1]
        super().__init__(tuple(self.logits.shape[:-1]))

    @property
    def probs_tensor(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=()):
        return _gumbel_argmax(self.logits, _shape_tuple(shape), self._gen())

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        v = _param(value).long()
        lead = torch.broadcast_shapes(tuple(v.shape), tuple(logp.shape[:-1]))
        logp = logp.broadcast_to(lead + (logp.shape[-1],))
        return torch.gather(logp, -1, v.broadcast_to(lead)[..., None])[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta, name=None):
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        super().__init__(_bshape(self.alpha, self.beta))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def variance(self):
        a, b = self.alpha, self.beta
        return a * b / ((a + b) ** 2 * (a + b + 1))

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        gen = self._gen()
        ga = _standard_gamma(self.alpha.broadcast_to(full), gen)
        gb = _standard_gamma(self.beta.broadcast_to(full), gen)
        return ga / (ga + gb)

    def log_prob(self, value):
        a, b, v = self.alpha, self.beta, _param(value)
        return (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v) \
            - _lbeta(a, b)

    def entropy(self):
        a, b = self.alpha, self.beta
        return (_lbeta(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Gamma(ExponentialFamily):
    """Concentration and rate."""

    def __init__(self, concentration, rate, name=None):
        self.concentration = _param(concentration)
        self.rate = _param(rate)
        super().__init__(_bshape(self.concentration, self.rate))

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.concentration / self.rate ** 2

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        g = _standard_gamma(self.concentration.broadcast_to(full),
                            self._gen())
        return g / self.rate

    def log_prob(self, value):
        c, r, v = self.concentration, self.rate, _param(value)
        return c * torch.log(r) + (c - 1) * torch.log(v) - r * v \
            - torch.lgamma(c)

    def entropy(self):
        c, r = self.concentration, self.rate
        return c - torch.log(r) + torch.lgamma(c) + (1 - c) * torch.digamma(c)


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration, name=None):
        self.concentration = _param(concentration)
        shape = tuple(self.concentration.shape)
        super().__init__(shape[:-1], shape[-1:])

    @property
    def mean(self):
        c = self.concentration
        return c / c.sum(-1, keepdim=True)

    @property
    def variance(self):
        c = self.concentration
        a0 = c.sum(-1, keepdim=True)
        m = c / a0
        return m * (1 - m) / (a0 + 1)

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        g = _standard_gamma(self.concentration.broadcast_to(full),
                            self._gen())
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        c, v = self.concentration, _param(value)
        return ((c - 1) * torch.log(v)).sum(-1) + torch.lgamma(c.sum(-1)) \
            - torch.lgamma(c).sum(-1)

    def entropy(self):
        c = self.concentration
        a0 = c.sum(-1)
        k = c.shape[-1]
        lnb = torch.lgamma(c).sum(-1) - torch.lgamma(a0)
        return lnb + (a0 - k) * torch.digamma(a0) \
            - ((c - 1) * torch.digamma(c)).sum(-1)


class Exponential(ExponentialFamily):
    """Rate parameterisation."""

    def __init__(self, rate, name=None):
        self.rate = _param(rate)
        super().__init__(_bshape(self.rate))

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / self.rate ** 2

    def rsample(self, shape=()):
        e = _exponential(self._extend_shape(shape), self._gen(),
                         self._device())
        return e / self.rate

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * _param(value)

    def entropy(self):
        return 1.0 - torch.log(self.rate)


class Geometric(Distribution):
    """pmf ``p (1 - p)^k`` over the failures ``k >= 0`` before the first
    success (``torch.distributions.Geometric`` counts the same;
    ``Tensor.geometric_`` counts trials, from 1: ROADMAP C34)."""

    def __init__(self, probs, name=None):
        self.probs_param = _param(probs)
        super().__init__(_bshape(self.probs_param))

    @property
    def mean(self):
        p = self.probs_param
        return (1 - p) / p

    @property
    def variance(self):
        p = self.probs_param
        return (1 - p) / p ** 2

    def sample(self, shape=()):
        u = _uniform(self._extend_shape(shape), self._gen(), self._device(),
                     1e-7, 1.0)
        p = self.probs_param.detach()
        return torch.floor(torch.log(u) / torch.log1p(-p)).float()

    rsample = sample

    def log_prob(self, value):
        p = self.probs_param
        return _param(value) * torch.log1p(-p) + torch.log(p)

    def entropy(self):
        p = self.probs_param
        q = 1 - p
        return -(q * torch.log(q) + p * torch.log(p)) / p


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc + self.scale * _EULER

    @property
    def variance(self):
        return (math.pi ** 2 / 6.0) * self.scale ** 2 \
            + torch.zeros_like(self.loc)

    def rsample(self, shape=()):
        g = _gumbel(self._extend_shape(shape), self._gen(), self._device())
        return self.loc + self.scale * g

    def log_prob(self, value):
        z = (_param(value) - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    def entropy(self):
        return torch.log(self.scale) + 1.0 + _EULER \
            + torch.zeros_like(self.loc)


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc.broadcast_to(self.batch_shape)

    @property
    def variance(self):
        return 2 * self.scale ** 2 + torch.zeros_like(self.loc)

    def rsample(self, shape=()):
        u = _uniform(self._extend_shape(shape), self._gen(), self._device(),
                     -0.5 + 1e-7, 0.5)
        return self.loc - self.scale * torch.sign(u) \
            * torch.log1p(-2 * torch.abs(u))

    def log_prob(self, value):
        return -torch.abs(_param(value) - self.loc) / self.scale \
            - torch.log(2 * self.scale)

    def entropy(self):
        return 1.0 + torch.log(2 * self.scale) + torch.zeros_like(self.loc)


class LogNormal(Distribution):
    """The exp of a Normal(loc, scale), in closed forms."""

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return torch.exp(self.loc + self.scale ** 2 / 2)

    @property
    def variance(self):
        l, s = self.loc, self.scale
        return (torch.exp(s ** 2) - 1) * torch.exp(2 * l + s ** 2)

    def rsample(self, shape=()):
        eps = _normal(self._extend_shape(shape), self._gen(), self._device())
        return torch.exp(self.loc + self.scale * eps)

    def log_prob(self, value):
        l, s = self.loc, self.scale
        lv = torch.log(_param(value))
        return -((lv - l) ** 2) / (2 * s ** 2) - torch.log(s) \
            - _HALF_LOG_2PI - lv

    def entropy(self):
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale) + self.loc


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs_param = _param(probs)
        shape = tuple(self.probs_param.shape)
        super().__init__(shape[:-1], shape[-1:])

    def _normalised(self):
        p = self.probs_param
        return p / p.sum(-1, keepdim=True)

    @property
    def mean(self):
        return self.total_count * self._normalised()

    @property
    def variance(self):
        pn = self._normalised()
        return self.total_count * pn * (1 - pn)

    def sample(self, shape=()):
        """``total_count`` categorical draws, counted per category."""
        logits = torch.log(self._normalised().detach())
        draws = _gumbel_argmax(
            logits, (self.total_count,) + _shape_tuple(shape), self._gen())
        k = logits.shape[-1]
        return torch.nn.functional.one_hot(draws, k).sum(0).float()

    rsample = sample

    def log_prob(self, value):
        pn = self._normalised()
        v = _param(value)
        # v = 0 contributes 0 even where pn = 0
        term = torch.where(v == 0, torch.zeros((), device=v.device),
                           v * torch.log(pn.clamp_min(1e-38)))
        return math.lgamma(self.total_count + 1.0) \
            - torch.lgamma(v + 1.0).sum(-1) + term.sum(-1)

    def entropy(self):
        """A Monte-Carlo estimate (no closed form): -E[log_prob] over 256
        draws."""
        return -self.log_prob(self.sample((256,))).mean(0)


class MultivariateNormal(Distribution):
    """``loc`` with exactly one of ``covariance_matrix``,
    ``precision_matrix`` or ``scale_tril`` (kept as ``scale_tril``)."""

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None):
        self.loc = _param(loc)
        given = [a is not None for a in
                 (covariance_matrix, precision_matrix, scale_tril)]
        if sum(given) != 1:
            raise ValueError("pass exactly one of covariance_matrix / "
                             "precision_matrix / scale_tril")
        if scale_tril is not None:
            self.scale_tril = _param(scale_tril)
        elif covariance_matrix is not None:
            self.scale_tril = torch.linalg.cholesky(
                _param(covariance_matrix))
        else:
            self.scale_tril = torch.linalg.cholesky(
                torch.linalg.inv(_param(precision_matrix)))
        d = self.loc.shape[-1]
        batch = torch.broadcast_shapes(tuple(self.loc.shape[:-1]),
                                       tuple(self.scale_tril.shape[:-2]))
        self._dim = d
        super().__init__(tuple(batch), (d,))

    def _half_logdet(self):
        return torch.log(torch.diagonal(self.scale_tril, dim1=-2,
                                        dim2=-1)).sum(-1)

    @property
    def mean(self):
        return self.loc.broadcast_to(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        st = self.scale_tril
        return (st * st).sum(-1).broadcast_to(self.batch_shape
                                              + self.event_shape)

    def rsample(self, shape=()):
        eps = _normal(self._extend_shape(shape), self._gen(), self._device())
        return self.loc + torch.matmul(self.scale_tril, eps[..., None])[..., 0]

    def log_prob(self, value):
        diff = _param(value) - self.loc
        st = self.scale_tril.broadcast_to(tuple(diff.shape[:-1])
                                          + tuple(self.scale_tril.shape[-2:]))
        sol = torch.linalg.solve_triangular(st, diff[..., None],
                                            upper=False)[..., 0]
        m = (sol ** 2).sum(-1)
        return -0.5 * m - self._half_logdet() - self._dim * _HALF_LOG_2PI

    def entropy(self):
        return (0.5 * self._dim * (1.0 + 2.0 * _HALF_LOG_2PI)
                + self._half_logdet()).broadcast_to(self.batch_shape)


class Poisson(ExponentialFamily):
    _ENTROPY_TERMS = 128   # the series' fixed cut (accurate for rate < ~60)

    def __init__(self, rate, name=None):
        self.rate = _param(rate)
        super().__init__(_bshape(self.rate))

    @property
    def mean(self):
        return self.rate.broadcast_to(self.batch_shape)

    @property
    def variance(self):
        return self.rate.broadcast_to(self.batch_shape)

    def sample(self, shape=()):
        lam = self.rate.detach().float().broadcast_to(
            self._extend_shape(shape)).contiguous()
        return torch.poisson(lam, generator=self._gen())

    rsample = sample

    def log_prob(self, value):
        r, v = self.rate, _param(value)
        return v * torch.log(r) - r - torch.lgamma(v + 1.0)

    def entropy(self):
        r = self.rate
        k = torch.arange(self._ENTROPY_TERMS, dtype=torch.float32,
                         device=r.device)
        rr = r.reshape(tuple(r.shape) + (1,))
        logpmf = k * torch.log(rr) - rr - torch.lgamma(k + 1.0)
        return -(torch.exp(logpmf) * logpmf).sum(-1)


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs_param = _param(probs)
        super().__init__(_bshape(self.probs_param))

    @property
    def mean(self):
        return self.total_count * self.probs_param

    @property
    def variance(self):
        p = self.probs_param
        return self.total_count * p * (1 - p)

    def sample(self, shape=()):
        full = self._extend_shape(shape)
        p = self.probs_param.detach().float().broadcast_to(full).contiguous()
        n = torch.full(full, float(self.total_count), device=p.device)
        return torch.binomial(n, p, generator=self._gen())

    rsample = sample

    def log_prob(self, value):
        n = float(self.total_count)
        pc = self.probs_param.clamp(1e-7, 1 - 1e-7)
        v = _param(value)
        logc = math.lgamma(n + 1.0) - torch.lgamma(v + 1.0) \
            - torch.lgamma(n - v + 1.0)
        return logc + v * torch.log(pc) + (n - v) * torch.log1p(-pc)

    def entropy(self):
        """Exact: -sum pmf log pmf over the support 0..total_count."""
        n = self.total_count
        pc = self.probs_param.clamp(1e-7, 1 - 1e-7)
        k = torch.arange(n + 1, dtype=torch.float32, device=pc.device)
        pcr = pc.reshape(tuple(pc.shape) + (1,))
        logpmf = (math.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
                  - torch.lgamma(n - k + 1.0)
                  + k * torch.log(pcr) + (n - k) * torch.log1p(-pcr))
        return -(torch.exp(logpmf) * logpmf).sum(-1)


class Cauchy(Distribution):
    """No mean or variance (both raise, as the reference's do)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        raise ValueError("Cauchy distribution has no mean")

    @property
    def variance(self):
        raise ValueError("Cauchy distribution has no variance")

    def rsample(self, shape=()):
        u = _uniform(self._extend_shape(shape), self._gen(), self._device(),
                     1e-6, 1 - 1e-6)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value):
        z = (_param(value) - self.loc) / self.scale
        return -torch.log(math.pi * self.scale * (1 + z ** 2))

    def entropy(self):
        return torch.log(4 * math.pi * self.scale) + torch.zeros_like(
            self.loc)


class StudentT(Distribution):
    """Degrees of freedom, loc and scale."""

    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self.df = _param(df)
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_bshape(self.df, self.loc, self.scale))

    @property
    def mean(self):
        df, l = self.df, self.loc
        return torch.where(df > 1, l.broadcast_to(_bshape(df, l)),
                           torch.full((), math.nan, device=l.device))

    @property
    def variance(self):
        df, s = self.df, self.scale
        v = s ** 2 * df / (df - 2)
        inf = torch.full((), math.inf, device=s.device)
        nan = torch.full((), math.nan, device=s.device)
        return torch.where(df > 2, v, torch.where(df > 1, inf, nan))

    def rsample(self, shape=()):
        full = self._extend_shape(shape)
        gen = self._gen()
        eps = _normal(full, gen, self._device())
        g = _standard_gamma((self.df / 2.0).broadcast_to(full), gen)
        chi2 = 2.0 * g
        return self.loc + self.scale * (eps * torch.sqrt(self.df / chi2))

    def log_prob(self, value):
        df, l, s = self.df, self.loc, self.scale
        z = (_param(value) - l) / s
        return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
                - 0.5 * torch.log(df * math.pi) - torch.log(s)
                - (df + 1) / 2 * torch.log1p(z ** 2 / df))

    def entropy(self):
        df, s = self.df, self.scale
        return ((df + 1) / 2 * (torch.digamma((df + 1) / 2)
                                - torch.digamma(df / 2))
                + 0.5 * torch.log(df) + torch.lgamma(df / 2)
                + math.lgamma(0.5) - torch.lgamma((df + 1) / 2)
                + torch.log(s))


class ContinuousBernoulli(ExponentialFamily):
    """CB(lambda) on [0, 1]: ``p(x) = C(lambda) lambda^x (1 -
    lambda)^(1 - x)``, ``C = 2 artanh(1 - 2 lambda) / (1 - 2 lambda)``;
    inside ``lims`` the Taylor forms at 1/2 are used. Draws go through the
    closed-form inverse CDF."""

    _EPS = 1e-6

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self.probs_param = _param(probs)
        self._lims = lims
        super().__init__(_bshape(self.probs_param))

    def _safe(self, p):
        # lambda away from 1/2 for the closed forms; the Taylor value is
        # selected there instead
        lo, hi = self._lims
        mid = (p >= lo) & (p <= hi)
        return mid, torch.where(mid, torch.full((), 0.25, device=p.device),
                                p.clamp(self._EPS, 1 - self._EPS))

    def _log_norm(self, p):
        mid, ps = self._safe(p)
        c = torch.log(2 * torch.atanh(1 - 2 * ps) / (1 - 2 * ps))
        # Taylor at 1/2: log C ~ log 2 + 4 (lambda - 1/2)^2 / 3
        return torch.where(mid, math.log(2.0) + 4 * (p - 0.5) ** 2 / 3, c)

    def _mean_expr(self, p):
        mid, ps = self._safe(p)
        m = ps / (2 * ps - 1) + 1 / (2 * torch.atanh(1 - 2 * ps))
        return torch.where(mid, 0.5 + (p - 0.5) / 3, m)

    @property
    def mean(self):
        return self._mean_expr(self.probs_param)

    @property
    def variance(self):
        p = self.probs_param
        mid, ps = self._safe(p)
        v = ps * (ps - 1) / (1 - 2 * ps) ** 2 \
            + 1 / (2 * torch.atanh(1 - 2 * ps)) ** 2
        return torch.where(mid, 1 / 12 - (p - 0.5) ** 2 / 15, v)

    def log_prob(self, value):
        p = self.probs_param
        v = _param(value)
        pc = p.clamp(self._EPS, 1 - self._EPS)
        return v * torch.log(pc) + (1 - v) * torch.log1p(-pc) \
            + self._log_norm(p)

    def icdf(self, value):
        p = self.probs_param
        u = _param(value)
        mid, ps = self._safe(p)
        x = torch.log1p(u * (2 * ps - 1) / (1 - ps)) \
            / torch.log(ps / (1 - ps))
        return torch.where(mid, u, x).clamp(0.0, 1.0)

    def cdf(self, value):
        p = self.probs_param
        x = _param(value)
        mid, ps = self._safe(p)
        c = (ps ** x * (1 - ps) ** (1 - x) + ps - 1) / (2 * ps - 1)
        return torch.where(mid, x, c).clamp(0.0, 1.0)

    def sample(self, shape=()):
        u = _uniform(self._extend_shape(shape), self._gen(), self._device())
        return self.icdf(u)

    def rsample(self, shape=()):
        return self.sample(shape)

    def entropy(self):
        p = self.probs_param
        pc = p.clamp(self._EPS, 1 - self._EPS)
        mean = self._mean_expr(p)
        return -(mean * torch.log(pc) + (1 - mean) * torch.log1p(-pc)
                 + self._log_norm(p))
