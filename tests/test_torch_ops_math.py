"""The port's ``ops/math.py`` against the reference's OpCases and random
ops of that module (``tests/test_torch_ops_harness.py`` says how), and
its exempt ops against the reference."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_op_suite import RANDOM_OPS
from test_torch_ops_harness import (_port_on_cpu, assert_same, cases_of,  # noqa: F401
                                    registry, run_case, run_random,
                                    to_numpy)

import paddle_tpu_torch as pt


@pytest.mark.parametrize("case", cases_of("math"), ids=lambda c: c.name)
def test_math_case_matches_reference(case):
    run_case(case)


@pytest.mark.parametrize("name", sorted(
    n for n in RANDOM_OPS if registry()[n].module == "math"))
def test_random_op(name):
    run_random(name)


def test_histogramdd():
    x = np.random.RandomState(5).rand(40, 2).astype(np.float32)
    want_h, want_e = paddle.histogramdd(paddle.to_tensor(x), bins=4,
                                        ranges=[(0.0, 1.0), (0.0, 1.0)])
    got_h, got_e = pt.histogramdd(torch.from_numpy(x), bins=4,
                                  ranges=[(0.0, 1.0), (0.0, 1.0)])
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h.numpy()))
    for g, w in zip(got_e, want_e):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6)


def test_host_helpers():
    assert pt.broadcast_shape([2, 1, 3], [4, 1]) == paddle.broadcast_shape(
        [2, 1, 3], [4, 1])
    x = np.random.RandomState(6).randn(3).astype(np.float32)
    assert pt.tolist(torch.from_numpy(x)) == pytest.approx(
        paddle.to_tensor(x).tolist())


def test_gamma_aliases():
    a = np.random.RandomState(7).uniform(0.5, 3.0, (2, 3)).astype(np.float32)
    b = np.random.RandomState(8).uniform(0.5, 3.0, (2, 3)).astype(np.float32)
    for name in ("igamma", "igammac"):
        want = getattr(paddle, name)(paddle.to_tensor(a),
                                     paddle.to_tensor(b)).numpy()
        got = getattr(pt, name)(torch.from_numpy(a), torch.from_numpy(b))
        assert_same(to_numpy(got), np.asarray(want), 1e-5, 1e-6, name)


@pytest.mark.parametrize("op,args,kwargs", [
    ("sum", ((3, 4),), dict(axis=None, keepdim=True)),
    ("mean", ((2, 3, 4),), dict(axis=[0, 2], keepdim=True)),
    ("median", ((3, 4),), dict(axis=1)),
    ("quantile", ((3, 8),), dict(q=[0.25, 0.75], axis=[0, 1])),
    ("cumsum", ((3, 4),), dict(axis=None)),
    ("max", ((3, 4),), dict(axis=[0, 1])),
    ("clip", ((3, 4),), dict(min=None, max=0.2)),
    ("logsumexp", ((3, 4),), dict(axis=None)),
    ("all", ((3, 4),), dict(axis=[0, 1])),
    ("take", ((3, 4),), dict(index=np.array([-1, 2, 15]), mode="wrap")),
])
def test_axis_and_option_spellings(op, args, kwargs):
    """Paddle's ``axis`` as None, an int and a list, ``keepdim``, ``clip``
    with one bound, ``take``'s modes: the reference's results."""
    x = np.random.RandomState(9).randn(*args[0]).astype(np.float32)
    if op == "all":
        x = x > -1.0
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    want = getattr(paddle, op)(paddle.to_tensor(x), **jkw)
    got = getattr(pt, op)(torch.from_numpy(x), **tkw)
    assert_same(to_numpy(got), np.asarray(want.numpy()), 1e-5, 1e-6, op)


@pytest.mark.parametrize("x,y", [(-7, 3), (7, -3), (-7.5, 2.0), (7.5, -2.0)])
def test_divide_family_signs(x, y):
    """``floor_divide`` and ``mod`` follow Python's signs, ``divide`` of
    integers gives a float, as in the reference."""
    for op in ("floor_divide", "mod", "remainder", "divide"):
        a = np.array([x, 2 * x]).astype(np.int64 if isinstance(x, int)
                                        else np.float32)
        want = getattr(paddle, op)(paddle.to_tensor(a),
                                   paddle.to_tensor(np.full_like(a, y)))
        got = getattr(pt, op)(torch.from_numpy(a),
                              torch.from_numpy(np.full_like(a, y)))
        assert_same(to_numpy(got), np.asarray(want.numpy()), 1e-6, 0, op)


def test_round_half_to_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(pt.round(torch.from_numpy(x)).numpy(),
                                  paddle.round(paddle.to_tensor(x)).numpy())


def test_cummax_ties_keep_the_first_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    for op in ("cummax", "cummin"):
        wv, wi = getattr(paddle, op)(paddle.to_tensor(x), axis=1)
        gv, gi = getattr(pt, op)(torch.from_numpy(x), axis=1)
        np.testing.assert_array_equal(gv.numpy(), wv.numpy())
        np.testing.assert_array_equal(gi.numpy(), wi.numpy())


def test_cdist_gradient_is_zero_at_zero_distance():
    x = torch.tensor([[0.0, 1.0], [2.0, 3.0]], requires_grad=True)
    pt.cdist(x, x.detach()).sum().backward()
    assert torch.isfinite(x.grad).all()
