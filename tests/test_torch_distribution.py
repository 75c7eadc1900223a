"""The port's distribution families (``paddle_tpu_torch/distribution/
{distribution,families}.py``) against the reference's
(``paddle_tpu/distribution/{distribution,families}.py``) on the CPU, per
family, on parameters drawn from a numpy seed:

* every deterministic quantity (mean, variance, stddev, ``log_prob``,
  ``prob`` / ``probs``, entropy, ``cdf`` / ``icdf``, the shapes) and the
  gradients of ``log_prob`` and entropy in the parameters, within
  ``rtol = 1e-5`` (``atol = 1e-6``);
* ``Independent``, the parameters' device, and the cases of
  ``tests/test_distribution.py`` for these families.
The samplers are in ``tests/test_torch_distribution_sampling.py``, KL
pairs and transforms in ``tests/test_torch_distribution_kl.py``."""
import numpy as np
import pytest
import scipy.stats as st
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as JD

import paddle_tpu_torch as pt
import paddle_tpu_torch.distribution as TD
from torch_vision_common import port_on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def close(got, want, what, tol=TOL):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol, err_msg=what)


class Side:
    """One package's tensor maker: leaves that require grad (float
    parameters), kept so their gradients can be read."""

    def __init__(self, port):
        self.port = port
        self.leaves = []

    def __call__(self, a, grad=True):
        a = np.asarray(a)
        if self.port:
            t = torch.tensor(a, requires_grad=grad and a.dtype.kind == "f")
        else:
            t = paddle.to_tensor(a)
            t.stop_gradient = not (grad and a.dtype.kind == "f")
        if grad and a.dtype.kind == "f":
            self.leaves.append(t)
        return t

    def grads(self):
        return [leaf.grad for leaf in self.leaves]


def _rng(seed):
    return np.random.default_rng(seed)


def f32(a):
    return np.asarray(a, np.float32)


def _spd(rng, d):
    a = rng.standard_normal((d, d))
    return f32(a @ a.T + d * np.eye(d))


#: family -> (build(D, mk), a value in the support for log_prob)
LOGITS = f32(_rng(0).standard_normal((2, 5)))
FAMILIES = {
    "Normal": (lambda D, mk: D.Normal(mk(f32([0.2, -1.0, 3.0])),
                                      mk(f32([1.0, 0.5, 2.0]))),
               f32([[0.5, -1.2, 2.0], [0.0, 1.0, -3.0]])),
    "Uniform": (lambda D, mk: D.Uniform(mk(f32([-1.0, 0.0, 2.0])),
                                        mk(f32([3.0, 0.5, 2.5]))),
                f32([[0.0, 0.25, 2.1], [5.0, -0.1, 2.4]])),
    "Bernoulli": (lambda D, mk: D.Bernoulli(mk(f32([0.3, 0.9, 0.5]))),
                  f32([[1, 0, 1], [0, 0, 1]])),
    "Categorical": (lambda D, mk: D.Categorical(mk(LOGITS)),
                    np.array([2, 4])),
    "Beta": (lambda D, mk: D.Beta(mk(f32([2.0, 0.5, 3.0])),
                                  mk(f32([5.0, 0.7, 1.5]))),
             f32([[0.3, 0.7, 0.5], [0.05, 0.9, 0.99]])),
    "Gamma": (lambda D, mk: D.Gamma(mk(f32([2.0, 0.5, 7.0])),
                                    mk(f32([3.0, 1.0, 0.5]))),
              f32([[0.3, 1.7, 12.0], [2.0, 0.01, 5.0]])),
    "Dirichlet": (lambda D, mk: D.Dirichlet(mk(f32([[2.0, 3.0, 5.0, 0.5],
                                                    [1.0, 1.0, 1.0, 1.0]]))),
                  f32([[0.2, 0.3, 0.4, 0.1], [0.25, 0.25, 0.25, 0.25]])),
    "Exponential": (lambda D, mk: D.Exponential(mk(f32([1.5, 0.2, 4.0]))),
                    f32([[0.3, 1.7, 0.01]])),
    "Geometric": (lambda D, mk: D.Geometric(mk(f32([0.3, 0.5, 0.9]))),
                  f32([[0.0, 2.0, 5.0], [1.0, 0.0, 3.0]])),
    "Gumbel": (lambda D, mk: D.Gumbel(mk(f32([0.0, 1.0, -2.0])),
                                      mk(f32([1.5, 0.5, 2.0]))),
               f32([[0.3, 1.7, -2.5]])),
    "Laplace": (lambda D, mk: D.Laplace(mk(f32([0.5, -1.0, 0.0])),
                                        mk(f32([1.2, 0.3, 2.0]))),
                f32([[0.3, 1.7, -2.5]])),
    "LogNormal": (lambda D, mk: D.LogNormal(mk(f32([0.2, -1.0, 1.0])),
                                            mk(f32([0.8, 0.3, 1.5]))),
                  f32([[0.3, 1.7, 4.0]])),
    "Multinomial": (lambda D, mk: D.Multinomial(8, mk(f32([0.2, 0.3, 0.5]))),
                    f32([[2, 2, 4], [0, 8, 0], [1, 3, 4]])),
    "MultivariateNormal-cov": (
        lambda D, mk: D.MultivariateNormal(
            mk(f32([[1.0, -1.0, 0.5], [0.0, 0.2, 0.1]])),
            covariance_matrix=mk(_spd(_rng(1), 3))),
        f32([[0.3, 0.7, -0.2], [1.0, 0.0, 2.0]])),
    "MultivariateNormal-prec": (
        lambda D, mk: D.MultivariateNormal(
            mk(f32([1.0, -1.0, 0.5])), precision_matrix=mk(_spd(_rng(2), 3))),
        f32([[0.3, 0.7, -0.2], [1.0, 0.0, 2.0]])),
    "MultivariateNormal-tril": (
        lambda D, mk: D.MultivariateNormal(
            mk(f32([1.0, -1.0, 0.5])),
            scale_tril=mk(f32(np.linalg.cholesky(_spd(_rng(3), 3))))),
        f32([[0.3, 0.7, -0.2], [1.0, 0.0, 2.0]])),
    "Poisson": (lambda D, mk: D.Poisson(mk(f32([2.5, 0.5, 30.0]))),
                f32([[0.0, 2.0, 25.0], [5.0, 1.0, 31.0]])),
    "Binomial": (lambda D, mk: D.Binomial(10, mk(f32([0.4, 0.05, 0.9]))),
                 f32([[0.0, 2.0, 10.0], [5.0, 1.0, 9.0]])),
    "Cauchy": (lambda D, mk: D.Cauchy(mk(f32([0.0, 1.0, -2.0])),
                                      mk(f32([2.0, 0.5, 1.0]))),
               f32([[0.3, 1.7, -4.0]])),
    "StudentT": (lambda D, mk: D.StudentT(mk(f32([4.0, 1.5, 30.0])),
                                          mk(f32([0.5, 0.0, -1.0])),
                                          mk(f32([2.0, 1.0, 0.5]))),
                 f32([[0.3, 1.7, -1.2]])),
    "ContinuousBernoulli": (
        lambda D, mk: D.ContinuousBernoulli(mk(f32([0.2, 0.5, 0.4995,
                                                    0.9]))),
        f32([[0.0, 0.3, 0.5, 1.0], [0.9, 0.1, 0.7, 0.2]])),
}
#: quantities a family does not have: both packages raise
RAISES = {"Categorical": {"mean": NotImplementedError,
                          "variance": NotImplementedError},
          "Cauchy": {"mean": ValueError, "variance": ValueError}}


def pair(family):
    build, _ = FAMILIES[family]
    js, ts = Side(False), Side(True)
    return build(JD, js), build(TD, ts), js, ts


def value(family, mk):
    v = FAMILIES[family][1]
    return mk(v, grad=False)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_deterministic_quantities(family):
    j, t, js, ts = pair(family)
    assert t.batch_shape == j.batch_shape
    assert t.event_shape == j.event_shape
    for q in ("mean", "variance", "stddev"):
        err = RAISES.get(family, {}).get(q if q != "stddev" else "variance")
        if err:
            with pytest.raises(err):
                getattr(j, q)
            with pytest.raises(err):
                getattr(t, q)
            continue
        close(getattr(t, q), getattr(j, q), f"{family}.{q}")
    for q in ("log_prob", "prob", "probs"):
        close(getattr(t, q)(value(family, ts)),
              getattr(j, q)(value(family, js)), f"{family}.{q}")
    if family != "Multinomial":         # a Monte-Carlo estimate: below
        close(t.entropy(), j.entropy(), f"{family}.entropy")
    if family == "ContinuousBernoulli":
        u = f32(np.linspace(0.0, 1.0, 9)[:, None] * np.ones(4))
        close(t.cdf(ts(u, False)), j.cdf(js(u, False)), "cdf")
        close(t.icdf(ts(u, False)), j.icdf(js(u, False)), "icdf")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_of_log_prob_and_entropy(family):
    j, t, js, ts = pair(family)
    jl = j.log_prob(value(family, js)).sum()
    tl = t.log_prob(value(family, ts)).sum()
    if family != "Multinomial":
        jl, tl = jl + j.entropy().sum(), tl + t.entropy().sum()
    jl.backward()
    tl.backward()
    assert len(js.grads()) == len(ts.grads()) > 0
    for k, (g, h) in enumerate(zip(ts.grads(), js.grads())):
        close(g, h, f"{family} d parameter {k}", tol=dict(rtol=1e-5,
                                                           atol=1e-5))


def test_independent():
    base = lambda D: D.Normal(f32(_rng(9).standard_normal((3, 2))),  # noqa
                              f32(_rng(10).uniform(0.5, 2, (3, 2))))
    j, t = JD.Independent(base(JD), 1), TD.Independent(base(TD), 1)
    assert t.batch_shape == j.batch_shape == (3,)
    assert t.event_shape == j.event_shape == (2,)
    v = f32(_rng(11).standard_normal((3, 2)))
    close(t.log_prob(torch.tensor(v)), j.log_prob(paddle.to_tensor(v)),
          "Independent.log_prob")
    close(t.entropy(), j.entropy(), "Independent.entropy")
    close(t.mean, j.mean, "Independent.mean")
    with pytest.raises(ValueError):
        TD.Independent(base(TD), 3)


def test_reference_cases():
    """``tests/test_distribution.py``'s scipy checks on the port."""
    v = f32([0.3, 1.7])
    np.testing.assert_allclose(
        npy(TD.Gamma(f32(2.0), f32(3.0)).log_prob(torch.tensor(v))),
        st.gamma(2.0, scale=1 / 3.0).logpdf(v), rtol=1e-4)
    k = f32([0.0, 2.0, 5.0])
    np.testing.assert_allclose(
        npy(TD.Geometric(f32(0.3)).log_prob(torch.tensor(k))),
        st.geom(0.3, loc=-1).logpmf(k), rtol=1e-4)
    np.testing.assert_allclose(
        npy(TD.Binomial(10, f32(0.4)).entropy()),
        st.binom(10, 0.4).entropy(), rtol=1e-4)
    mean, cov = f32([1.0, -1.0]), f32([[2.0, 0.5], [0.5, 1.0]])
    mv = TD.MultivariateNormal(mean, covariance_matrix=cov)
    np.testing.assert_allclose(npy(mv.log_prob(torch.tensor(f32([0.3, 0.7])))),
                               st.multivariate_normal(mean, cov).logpdf(
                                   [0.3, 0.7]), rtol=1e-4)
    assert tuple(mv.rsample((5,)).shape) == (5, 2)
    for lam in (0.2, 0.5, 0.9):
        d = TD.ContinuousBernoulli(f32(lam))
        xs = np.linspace(0, 1, 2001, dtype="float32")
        pdf = np.exp(npy(d.log_prob(torch.tensor(xs))))
        trapz = getattr(np, "trapezoid", None) or np.trapz
        assert abs(trapz(pdf, xs) - 1.0) < 1e-3, lam
    pt.seed(11)
    for lam in (0.15, 0.5, 0.8):
        d = TD.ContinuousBernoulli(f32(lam))
        s = npy(d.sample([20000]))
        assert abs(s.mean() - float(d.mean)) < 5e-3, lam
        assert abs(s.var() - float(d.variance)) < 5e-3, lam
        assert (s >= 0).all() and (s <= 1).all()
    with pytest.raises(ValueError):
        TD.MultivariateNormal(mean)
    loc = torch.tensor(0.5, requires_grad=True)
    TD.Normal(loc, f32(1.5)).log_prob(torch.tensor(1.0)).backward()
    np.testing.assert_allclose(float(loc.grad), 0.5 / 1.5 ** 2, rtol=1e-5)


def test_parameters_follow_the_current_device():
    """Numbers and arrays become fp32 tensors on the current device; on a
    machine without CUDA the default device refuses them."""
    d = TD.Normal(0.0, 1.0)
    assert d.loc.dtype == torch.float32 and d.loc.device.type == "cpu"
    if not torch.cuda.is_available():
        prev = pt.get_device()
        pt.set_device("gpu")
        try:
            with pytest.raises(RuntimeError):
                TD.Normal(0.0, 1.0)
        finally:
            pt.set_device(prev)
