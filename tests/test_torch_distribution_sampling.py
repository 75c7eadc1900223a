"""The port's samplers (``paddle_tpu_torch/distribution/families.py``)
against the reference's (``paddle_tpu/distribution/families.py``) on the
CPU:

* the closed-form samplers (Normal, Uniform, LogNormal, Exponential,
  Laplace, Gumbel, Cauchy, Geometric, ContinuousBernoulli,
  MultivariateNormal) on the same noise: the reference's ``jax.random``
  draw and the port's noise helper both monkeypatched to one numpy array
  (the JAX key streams cannot be reproduced, ROADMAP C2), values and
  pathwise gradients within ``rtol = 1e-5`` (``atol = 1e-5``);
* the other samplers (Gamma, Beta, Dirichlet, Poisson, Binomial,
  Bernoulli, Categorical, Multinomial, StudentT): shapes, support,
  moments within stated bounds, reproducibility under ``paddle.seed``,
  Gamma's gradient in the concentration against JAX's implicit
  reparameterisation (``jax.lax.random_gamma_grad``), draws from the
  port's generators alone, and Multinomial's Monte-Carlo entropy.
The families, helpers and bound are ``tests/test_torch_distribution.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as JD

import paddle_tpu_torch as pt
import paddle_tpu_torch.distribution as TD
from paddle_tpu_torch.distribution import families as TF
from test_torch_distribution import _rng, close, f32, npy, pair
from torch_vision_common import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


#: family -> the noise helper it draws through, and the reference's
#: jax.random function it maps
CLOSED_FORM = {"Normal": "normal", "LogNormal": "normal",
               "MultivariateNormal-cov": "normal",
               "MultivariateNormal-tril": "normal",
               "Uniform": "uniform", "Laplace": "uniform",
               "Cauchy": "uniform", "Geometric": "uniform",
               "ContinuousBernoulli": "uniform",
               "Exponential": "exponential", "Gumbel": "gumbel"}


def _same_noise(monkeypatch, kind, shape):
    """One numpy noise array behind both packages' draws of ``kind``;
    the uniform one mapped to ``[minval, maxval)`` as each asks."""
    rng = _rng(5)
    if kind == "uniform":
        base = f32(rng.random(shape))

        def ref(key, shp, dtype=jnp.float32, minval=0.0, maxval=1.0):
            assert tuple(shp) == shape
            return jnp.asarray(f32(np.float32(minval) + np.float32(
                maxval - minval) * base))

        def port(shp, gen, device, minval=0.0, maxval=1.0):
            assert tuple(shp) == shape
            return torch.tensor(f32(np.float32(minval) + np.float32(
                maxval - minval) * base))
    else:
        draw = {"normal": lambda: rng.standard_normal(shape),
                "exponential": lambda: rng.exponential(size=shape),
                "gumbel": lambda: rng.gumbel(size=shape)}[kind]
        base = f32(draw())

        def ref(key, shp, dtype=jnp.float32):
            assert tuple(shp) == shape
            return jnp.asarray(base)

        def port(shp, gen, device):
            assert tuple(shp) == shape
            return torch.tensor(base)
    monkeypatch.setattr(jax.random, kind, ref)
    monkeypatch.setattr(TF, f"_{kind}", port)


@pytest.mark.parametrize("family", sorted(CLOSED_FORM))
def test_closed_form_samplers_on_the_same_noise(family, monkeypatch):
    j, t, js, ts = pair(family)
    shape = (4,) + j.batch_shape + j.event_shape
    _same_noise(monkeypatch, CLOSED_FORM[family], shape)
    jr, tr = j.rsample((4,)), t.rsample((4,))
    close(tr, jr, f"{family}.rsample")
    close(t.sample((4,)), j.sample((4,)), f"{family}.sample")
    if family in ("Geometric",):
        return                          # not differentiable in either
    w = f32(_rng(6).standard_normal(shape))
    (jr * paddle.to_tensor(w)).sum().backward()
    (tr * torch.tensor(w)).sum().backward()
    for k, (g, h) in enumerate(zip(ts.grads(), js.grads())):
        if h is None:
            assert g is None or not npy(g).any()
            continue
        close(g, h, f"{family}.rsample d parameter {k}",
              tol=dict(rtol=1e-5, atol=1e-5))


#: family -> (build(D), the mean and variance of one draw, a support test)
SAMPLED = {
    "Gamma": (lambda D: D.Gamma(f32(3.0), f32(2.0)), 1.5, 0.75,
              lambda s: (s > 0).all()),
    "Beta": (lambda D: D.Beta(f32(2.0), f32(5.0)), 2 / 7,
             10 / (49 * 8), lambda s: ((s > 0) & (s < 1)).all()),
    "Dirichlet": (lambda D: D.Dirichlet(f32([2.0, 3.0, 5.0])), 0.2,
                  0.2 * 0.8 / 11,
                  lambda s: np.allclose(s.sum(-1), 1, atol=1e-5)),
    "Poisson": (lambda D: D.Poisson(f32(4.0)), 4.0, 4.0,
                lambda s: ((s >= 0) & (s == np.round(s))).all()),
    "Binomial": (lambda D: D.Binomial(10, f32(0.5)), 5.0, 2.5,
                 lambda s: ((s >= 0) & (s <= 10)
                            & (s == np.round(s))).all()),
    "Bernoulli": (lambda D: D.Bernoulli(f32(0.3)), 0.3, 0.21,
                  lambda s: np.isin(s, [0.0, 1.0]).all()),
    "Categorical": (lambda D: D.Categorical(f32(np.log([0.2, 0.3, 0.5]))),
                    1.3, 0.61, lambda s: np.isin(s, [0, 1, 2]).all()),
    "Multinomial": (lambda D: D.Multinomial(8, f32([0.2, 0.3, 0.5])),
                    1.6, 8 * 0.2 * 0.8,
                    lambda s: (s.sum(-1) == 8).all()),
    "StudentT": (lambda D: D.StudentT(f32(6.0), f32(0.5), f32(2.0)), 0.5,
                 4.0 * 6 / 4, lambda s: np.isfinite(s).all()),
}
N_DRAWS = 20000


@pytest.mark.parametrize("family", sorted(SAMPLED))
def test_sampled_families_moments_support_and_seed(family):
    """Moments over 20000 draws: the mean within 4.5 standard errors
    (+ 0.01), the variance within 15 % (+ 0.02), the bounds of
    ``tests/test_distribution.py``; the first coordinate of an event is
    the one held (Dirichlet, Multinomial)."""
    build, mean, var, support = SAMPLED[family]
    t, j = build(TD), build(JD)
    pt.seed(1234)
    s = npy(t.sample((N_DRAWS,)))
    js = npy(j.sample((N_DRAWS,)))
    assert s.shape == js.shape
    if family == "Categorical":
        assert s.dtype == np.int64 and js.dtype == np.int32     # C26
    assert support(s), family
    first = s[..., 0] if s.ndim > 1 else s
    first = first.astype(np.float64)
    assert abs(first.mean() - mean) < 4.5 * np.sqrt(var / N_DRAWS) + 0.01
    assert abs(first.var() - var) < 0.15 * max(var, 0.1) + 0.02
    pt.seed(1234)
    np.testing.assert_array_equal(npy(t.sample((N_DRAWS,))), s)
    pt.seed(99)
    assert not np.array_equal(npy(t.sample((N_DRAWS,))), s)


def test_gamma_gradient_is_jax_implicit_reparameterisation():
    """d rsample / d concentration of the port's Gamma equals JAX's
    implicit gradient (``random_gamma_grad``) at the port's own draw,
    over the rate; Beta's and Dirichlet's draws take theirs through the
    same standard gammas."""
    c = torch.tensor(f32(_rng(7).uniform(0.2, 8.0, 64)), requires_grad=True)
    r = torch.tensor(f32(_rng(8).uniform(0.5, 3.0, 64)))
    pt.seed(3)
    x = TD.Gamma(c, r).rsample()
    x.sum().backward()
    g = npy(x) * npy(r)                  # the standard gamma draws
    want = np.asarray(jax.lax.random_gamma_grad(jnp.asarray(npy(c)),
                                                jnp.asarray(g))) / npy(r)
    np.testing.assert_allclose(npy(c.grad), want, rtol=1e-4, atol=1e-6)
    beta_a = torch.tensor(f32([2.0, 0.5]), requires_grad=True)
    TD.Beta(beta_a, f32([3.0, 1.0])).rsample((8,)).sum().backward()
    assert np.isfinite(npy(beta_a.grad)).all()
    conc = torch.tensor(f32([1.0, 2.0, 3.0]), requires_grad=True)
    (TD.Dirichlet(conc).rsample((8,))[..., 0]).sum().backward()
    assert np.isfinite(npy(conc.grad)).all() and npy(conc.grad).any()


def test_draws_use_the_ports_generator_only():
    """Sampling leaves torch's global RNG where it was."""
    state = torch.get_rng_state()
    pt.seed(5)
    for name in ("Gamma", "Poisson", "Categorical", "Bernoulli"):
        SAMPLED[name][0](TD).sample((10,))
    for family in CLOSED_FORM:
        pair(family)[1].sample((2,))
    assert torch.equal(torch.get_rng_state(), state)


def test_multinomial_entropy_estimate():
    pt.seed(0)
    m = TD.Multinomial(8, f32([0.2, 0.3, 0.5]))
    ent = float(m.entropy())
    assert abs(ent - st.multinomial(8, [0.2, 0.3, 0.5]).entropy()) < 0.2
