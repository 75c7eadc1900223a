"""The port's KL registry and transforms (``paddle_tpu_torch/
distribution/{kl,transform}.py``) against the reference's
(``paddle_tpu/distribution/{kl,transform}.py``) on the CPU, on
parameters drawn from a numpy seed: every registered KL pair (values and
gradients in both distributions' parameters), ``register_kl``'s MRO
dispatch and its error, each of the 12 transforms (forward, inverse,
both log-dets, event ranks) and ``TransformedDistribution`` (``log_prob``,
``rsample`` on the same noise, shapes), a SAC-style tanh-squashed Normal
among them, and the cases of ``tests/test_distribution.py`` for them.

The rule: fp32 values and gradients within ``rtol = 1e-5`` (``atol =
1e-5`` for gradients and KL values, ``1e-6`` for the transforms' values)
of the reference's. The KL closed forms are differences of lgamma,
digamma and log terms of order 1 to 10 that cancel to KLs of order
0.01: XLA's and torch's lgamma and digamma differ by a few ulp of the
terms (1.4e-6 in Gamma's), so their bound is absolute at 1e-5, about
1e-6 of the terms. Where the reference reads a transform's parameters
as raw arrays (no gradient), the port's gradients in them are held to
finite differences instead (ROADMAP C50)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as JD

import paddle_tpu_torch as pt
import paddle_tpu_torch.distribution as TD
from paddle_tpu_torch.distribution import families as TF
from paddle_tpu_torch.distribution import kl as TK
from torch_vision_common import port_on_cpu  # noqa: F401
from test_torch_distribution import Side, close, f32, npy, _rng, _spd

GRAD_TOL = KL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def _u(seed, lo, hi, shape=(3,)):
    return f32(_rng(seed).uniform(lo, hi, shape))


#: every registered pair: (p, q) builders over a tensor maker
KL_PAIRS = {
    "Normal": lambda D, mk: (D.Normal(mk(_u(1, -1, 1)), mk(_u(2, .5, 2))),
                             D.Normal(mk(_u(3, -1, 1)), mk(_u(4, .5, 2)))),
    "Uniform": lambda D, mk: (D.Uniform(mk(f32([0., -1., 0.])),
                                        mk(f32([1., 1., 2.]))),
                              D.Uniform(mk(f32([-1., -2., 0.5])),
                                        mk(f32([2., 3., 3.])))),
    "Bernoulli": lambda D, mk: (D.Bernoulli(mk(_u(5, .1, .9))),
                                D.Bernoulli(mk(_u(6, .1, .9)))),
    "Categorical": lambda D, mk: (
        D.Categorical(mk(f32(_rng(7).standard_normal((2, 5))))),
        D.Categorical(mk(f32(_rng(8).standard_normal((2, 5)))))),
    "Beta": lambda D, mk: (D.Beta(mk(_u(9, .5, 4)), mk(_u(10, .5, 4))),
                           D.Beta(mk(_u(11, .5, 4)), mk(_u(12, .5, 4)))),
    "Gamma": lambda D, mk: (D.Gamma(mk(_u(13, .5, 4)), mk(_u(14, .5, 3))),
                            D.Gamma(mk(_u(15, .5, 4)), mk(_u(16, .5, 3)))),
    "Dirichlet": lambda D, mk: (D.Dirichlet(mk(_u(17, .5, 4, (2, 4)))),
                                D.Dirichlet(mk(_u(18, .5, 4, (2, 4))))),
    "Exponential": lambda D, mk: (D.Exponential(mk(_u(19, .2, 3))),
                                  D.Exponential(mk(_u(20, .2, 3)))),
    "Laplace": lambda D, mk: (D.Laplace(mk(_u(21, -1, 1)), mk(_u(22, .5, 2))),
                              D.Laplace(mk(_u(23, -1, 1)),
                                        mk(_u(24, .5, 2)))),
    "Geometric": lambda D, mk: (D.Geometric(mk(_u(25, .1, .9))),
                                D.Geometric(mk(_u(26, .1, .9)))),
    "MultivariateNormal": lambda D, mk: (
        D.MultivariateNormal(mk(f32(_rng(27).standard_normal(3))),
                             covariance_matrix=mk(_spd(_rng(28), 3))),
        D.MultivariateNormal(mk(f32(_rng(29).standard_normal(3))),
                             scale_tril=mk(f32(np.linalg.cholesky(
                                 _spd(_rng(30), 3)))))),
    "LogNormal": lambda D, mk: (D.LogNormal(mk(_u(31, -1, 1)),
                                            mk(_u(32, .5, 2))),
                                D.LogNormal(mk(_u(33, -1, 1)),
                                            mk(_u(34, .5, 2)))),
    "Poisson": lambda D, mk: (D.Poisson(mk(_u(35, .5, 6))),
                              D.Poisson(mk(_u(36, .5, 6)))),
}


def test_every_registered_pair_is_tested():
    ported = {(p.__name__, q.__name__) for p, q in TK._REGISTRY}
    assert ported == {(n, n) for n in KL_PAIRS}
    from paddle_tpu.distribution import kl as JK
    assert {(p.__name__, q.__name__) for p, q in JK._REGISTRY} == ported


@pytest.mark.parametrize("name", sorted(KL_PAIRS))
def test_kl_pair(name):
    js, ts = Side(False), Side(True)
    jp, jq = KL_PAIRS[name](JD, js)
    tp, tq = KL_PAIRS[name](TD, ts)
    jk, tk = JD.kl_divergence(jp, jq), TD.kl_divergence(tp, tq)
    close(tk, jk, f"KL {name}", tol=KL_TOL)
    close(tp.kl_divergence(tq), jp.kl_divergence(jq), f"{name}.kl_divergence",
          tol=KL_TOL)
    if name == "Uniform":
        # one pair whose support is not covered: inf in both
        jr, tr = JD.kl_divergence(jq, jp), TD.kl_divergence(tq, tp)
        close(tr, jr, "KL Uniform, reversed")
        assert np.isinf(npy(tr)).any()
        return
    jk.sum().backward()
    tk.sum().backward()
    for k, (g, h) in enumerate(zip(ts.grads(), js.grads())):
        close(g, h, f"KL {name} d parameter {k}", tol=GRAD_TOL)


def test_kl_mvn_with_a_batched_loc():
    """A batch of locs over one covariance: the reference's
    ``solve_triangular`` does not broadcast and raises (C50); the port's
    KL is each row's, as the reference gives row by row."""
    locs = f32(_rng(37).standard_normal((2, 3)))
    cov, tril = _spd(_rng(38), 3), f32(np.linalg.cholesky(_spd(_rng(39), 3)))
    qloc = f32(_rng(40).standard_normal(3))
    got = TD.kl_divergence(TD.MultivariateNormal(locs, covariance_matrix=cov),
                           TD.MultivariateNormal(qloc, scale_tril=tril))
    with pytest.raises(TypeError):
        JD.kl_divergence(JD.MultivariateNormal(locs, covariance_matrix=cov),
                         JD.MultivariateNormal(qloc, scale_tril=tril))
    rows = [JD.kl_divergence(JD.MultivariateNormal(r, covariance_matrix=cov),
                             JD.MultivariateNormal(qloc, scale_tril=tril))
            for r in locs]
    np.testing.assert_allclose(npy(got), [float(npy(r)) for r in rows],
                               **KL_TOL)


def test_register_kl_dispatch_and_error():
    class MyNormal(TD.Normal):
        pass

    @TD.register_kl(MyNormal, MyNormal)
    def _kl(p, q):
        return torch.tensor(42.0)

    try:
        assert float(TD.kl_divergence(MyNormal(0.0, 1.0),
                                      MyNormal(0.0, 1.0))) == 42.0
        # a subclass against its base takes the base pair
        close(TD.kl_divergence(MyNormal(0.0, 1.0), TD.Normal(1.0, 2.0)),
              JD.kl_divergence(JD.Normal(0.0, 1.0), JD.Normal(1.0, 2.0)),
              "MRO dispatch")
    finally:
        del TK._REGISTRY[(MyNormal, MyNormal)]
    with pytest.raises(NotImplementedError):
        TD.kl_divergence(TD.Cauchy(0.0, 1.0), TD.Normal(0.0, 1.0))


# -- transforms ---------------------------------------------------------------

#: name -> (build(D, mk), an input x in the domain)
TRANSFORMS = {
    "Affine": (lambda D, mk: D.AffineTransform(mk(_u(40, -1, 1)),
                                               mk(_u(41, .5, 2))),
               f32(_rng(42).standard_normal((2, 3)))),
    "Exp": (lambda D, mk: D.ExpTransform(), f32(_rng(43).standard_normal(5))),
    "Power": (lambda D, mk: D.PowerTransform(mk(f32(2.5))),
              _u(44, .2, 3, (4,))),
    "Abs": (lambda D, mk: D.AbsTransform(), _u(45, .1, 2, (4,))),
    "Sigmoid": (lambda D, mk: D.SigmoidTransform(),
                f32(_rng(46).standard_normal(5))),
    "Tanh": (lambda D, mk: D.TanhTransform(),
             f32(_rng(47).standard_normal(5) * 0.8)),
    "Softmax": (lambda D, mk: D.SoftmaxTransform(),
                f32(_rng(48).standard_normal((2, 4)))),
    "StickBreaking": (lambda D, mk: D.StickBreakingTransform(),
                      f32(_rng(49).standard_normal((2, 3)))),
    "Reshape": (lambda D, mk: D.ReshapeTransform((2, 3), (3, 2)),
                f32(_rng(50).standard_normal((4, 2, 3)))),
    "Independent": (lambda D, mk: D.IndependentTransform(
        D.ExpTransform(), 1), f32(_rng(51).standard_normal((2, 3)))),
    "Stack": (lambda D, mk: D.StackTransform(
        [D.ExpTransform(), D.TanhTransform()], axis=1),
        f32(_rng(52).standard_normal((3, 2)) * 0.8)),
    "Chain": (lambda D, mk: D.ChainTransform(
        [D.AffineTransform(mk(f32(0.5)), mk(f32(2.0))), D.ExpTransform()]),
        f32(_rng(53).standard_normal(4) * 0.5)),
}


def test_every_transform_is_tested():
    names = {n[:-len("Transform")] for n in TD.__all__
             if n.endswith("Transform") and n != "Transform"}
    assert names == set(TRANSFORMS)
    assert len(names) == 12


def _substitute(k, arr):
    """A float64 tensor maker that gives ``arr`` for the ``k``-th
    parameter it makes."""
    made = []

    def mk(a, grad=True):
        made.append(a)
        return torch.tensor(arr if len(made) - 1 == k
                            else np.asarray(a, np.float64))
    return mk


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform(name):
    build, x = TRANSFORMS[name]
    js, ts = Side(False), Side(True)
    j, t = build(JD, js), build(TD, ts)
    assert t._event_rank == j._event_rank
    jx = js(x)
    tx = ts(x)
    jy, ty = j.forward(jx), t.forward(tx)
    close(ty, jy, f"{name}.forward")
    close(t.inverse(ty.detach()), j.inverse(paddle.to_tensor(npy(jy))),
          f"{name}.inverse")
    if name == "Softmax":
        with pytest.raises(NotImplementedError):
            j.forward_log_det_jacobian(jx)
        with pytest.raises(NotImplementedError):
            t.forward_log_det_jacobian(tx)
        return
    jl, tl = j.forward_log_det_jacobian(jx), t.forward_log_det_jacobian(tx)
    close(tl, jl, f"{name}.forward_log_det_jacobian")
    close(t.inverse_log_det_jacobian(ty.detach()),
          j.inverse_log_det_jacobian(paddle.to_tensor(npy(jy))),
          f"{name}.inverse_log_det_jacobian")
    (jy.sum() + jl.sum()).backward()
    (ty.sum() + tl.sum()).backward()
    for k, (g, h) in enumerate(zip(ts.grads(), js.grads())):
        if h is not None:
            close(g, h, f"{name} gradient {k}", tol=GRAD_TOL)
            continue
        # a parameter the reference reads as a raw array (C50): the
        # port's gradient against central differences in float64
        base = npy(ts.leaves[k]).astype(np.float64)
        xx = torch.tensor(x.astype(np.float64))
        num = np.zeros_like(base)
        for i in np.ndindex(base.shape):
            for sign in (1, -1):
                pert = base.copy()
                pert[i] += sign * 1e-4
                tr = build(TD, _substitute(k, pert))
                num[i] += sign * float(
                    tr.forward(xx).sum()
                    + tr.forward_log_det_jacobian(xx).sum()) / 2e-4
        np.testing.assert_allclose(npy(g), num, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} parameter {k}")


def test_transform_reference_cases():
    """``tests/test_distribution.py``'s round trips, the numeric log-det,
    the chain and the simplex."""
    x = np.linspace(-1.5, 1.5, 7).astype(np.float32)
    for tr, dom in [(TD.AffineTransform(f32(1.0), f32(2.0)), x),
                    (TD.ExpTransform(), x), (TD.SigmoidTransform(), x),
                    (TD.TanhTransform(), x * 0.6)]:
        y = tr.forward(torch.tensor(dom))
        np.testing.assert_allclose(npy(tr.inverse(y)), dom, rtol=1e-4,
                                   atol=1e-5)
        eps = 1e-3
        num = (npy(tr.forward(torch.tensor(dom + eps)))
               - npy(tr.forward(torch.tensor(dom - eps)))) / (2 * eps)
        np.testing.assert_allclose(
            npy(tr.forward_log_det_jacobian(torch.tensor(dom))),
            np.log(np.abs(num)), rtol=5e-3, atol=5e-3)
    sb = TD.StickBreakingTransform()
    y = npy(sb.forward(torch.tensor(f32([0.3, -0.2, 0.8]))))
    assert y.shape == (4,)
    np.testing.assert_allclose(y.sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["lognormal", "sac_tanh", "stick"])
def test_transformed_distribution(case, monkeypatch):
    """``log_prob`` against the reference's; ``rsample`` on the same normal
    noise (both draws monkeypatched to one array); shapes. ``sac_tanh`` is
    a SAC policy head: a Normal over 6 actions squashed by tanh."""
    rng = _rng(60)
    if case == "lognormal":
        loc, scale = f32([0.2, -0.3]), f32([0.7, 1.1])
        tfs = lambda D, mk: [D.ExpTransform()]  # noqa: E731
        v = f32([[0.5, 2.0], [1.0, 0.3]])
    elif case == "sac_tanh":
        loc = f32(rng.standard_normal((4, 6)) * 0.5)
        scale = f32(rng.uniform(0.2, 1.0, (4, 6)))
        tfs = lambda D, mk: [D.TanhTransform()]  # noqa: E731
        v = f32(np.tanh(rng.standard_normal((4, 6)) * 0.5))
    else:
        loc, scale = f32(rng.standard_normal(3)), f32(rng.uniform(.5, 1, 3))
        tfs = lambda D, mk: [D.StickBreakingTransform()]  # noqa: E731
        v = f32([[0.2, 0.3, 0.4, 0.1]])
    js, ts = Side(False), Side(True)
    j = JD.TransformedDistribution(JD.Normal(js(loc), js(scale)),
                                   tfs(JD, js))
    t = TD.TransformedDistribution(TD.Normal(ts(loc), ts(scale)),
                                   tfs(TD, ts))
    assert (t.batch_shape, t.event_shape) == (j.batch_shape, j.event_shape)
    jl = j.log_prob(paddle.to_tensor(v))
    tl = t.log_prob(torch.tensor(v))
    close(tl, jl, f"{case} log_prob")
    jl.sum().backward()
    tl.sum().backward()
    for k, (g, h) in enumerate(zip(ts.grads(), js.grads())):
        close(g, h, f"{case} log_prob d parameter {k}", tol=GRAD_TOL)
    eps = f32(rng.standard_normal((5,) + loc.shape))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shp, dtype=jnp.float32: jnp.asarray(eps))
    monkeypatch.setattr(TF, "_normal",
                        lambda shp, gen, device: torch.tensor(eps))
    close(t.rsample((5,)), j.rsample((5,)), f"{case} rsample")
    close(t.sample((5,)), j.sample((5,)), f"{case} sample")


def test_transformed_sample_reference_case():
    d = TD.TransformedDistribution(TD.Normal(f32(0.2), f32(0.7)),
                                   [TD.ExpTransform()])
    pt.seed(3)
    s = npy(d.sample((4,)))
    assert s.shape == (4,) and (s > 0).all()
    ref = TD.LogNormal(f32(0.2), f32(0.7))
    v = torch.tensor(f32([0.5, 2.0]))
    np.testing.assert_allclose(npy(d.log_prob(v)), npy(ref.log_prob(v)),
                               rtol=1e-5)
