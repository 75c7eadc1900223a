"""``paddle.distribution`` (port of ``paddle_tpu/distribution/``):
probability distributions, transforms and the KL registry, in torch.

Parameters are tensors and every quantity is torch math on them, so
``log_prob``, ``entropy``, ``rsample`` and ``kl_divergence`` are
differentiable through autograd; draws come from the port's generator of
the parameters' device (``paddle.seed`` reseeds it), so they reproduce
within the port but not the reference's JAX streams (ROADMAP C2)."""
from __future__ import annotations

from .distribution import Distribution, ExponentialFamily, Independent
from .families import (
    Bernoulli, Beta, Binomial, Categorical, Cauchy, ContinuousBernoulli,
    Dirichlet, Exponential,
    Gamma, Geometric, Gumbel, Laplace, LogNormal, Multinomial,
    MultivariateNormal, Normal, Poisson, StudentT, Uniform,
)
from .transform import (
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform, SigmoidTransform,
    SoftmaxTransform, StackTransform, StickBreakingTransform, TanhTransform,
    Transform, TransformedDistribution,
)
from .kl import kl_divergence, register_kl

__all__ = [
    "Distribution", "ExponentialFamily", "Independent",
    "Bernoulli", "Beta", "Binomial", "Categorical", "Cauchy",
    "ContinuousBernoulli", "Dirichlet",
    "Exponential", "Gamma", "Geometric", "Gumbel", "Laplace", "LogNormal",
    "Multinomial", "MultivariateNormal", "Normal", "Poisson", "StudentT",
    "Uniform",
    "Transform", "TransformedDistribution", "AbsTransform", "AffineTransform",
    "ChainTransform", "ExpTransform", "IndependentTransform",
    "PowerTransform", "ReshapeTransform", "SigmoidTransform",
    "SoftmaxTransform", "StackTransform", "StickBreakingTransform",
    "TanhTransform",
    "kl_divergence", "register_kl",
]
