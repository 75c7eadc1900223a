"""The port's ``ops/creation.py`` against the reference's OpCases and
random ops of that module (``tests/test_torch_ops_harness.py`` says
how), and its exempt ops against the reference."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_op_suite import RANDOM_OPS
from test_torch_ops_harness import (_port_on_cpu, cases_of, registry,  # noqa: F401
                                    run_case, run_random, to_numpy)

import paddle_tpu_torch as pt


@pytest.mark.parametrize("case", cases_of("creation"), ids=lambda c: c.name)
def test_creation_case_matches_reference(case):
    run_case(case)


@pytest.mark.parametrize("name", sorted(
    n for n in RANDOM_OPS if registry()[n].module == "creation"))
def test_random_op(name):
    run_random(name)


def test_complex_and_polar():
    r, i = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    want = paddle.complex(paddle.to_tensor(r), paddle.to_tensor(i)).numpy()
    got = pt.complex(torch.from_numpy(r), torch.from_numpy(i))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    mag = np.abs(r)
    want = paddle.polar(paddle.to_tensor(mag), paddle.to_tensor(i)).numpy()
    got = pt.polar(torch.from_numpy(mag), torch.from_numpy(i))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [(4,), (3, 5, 1), (5, 3, -1)])
def test_tri_indices(args):
    for name in ("tril_indices", "triu_indices"):
        want = getattr(paddle, name)(*args).numpy()
        got = getattr(pt, name)(*args)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_in_place_variants():
    x = np.random.RandomState(4).randn(4, 4).astype(np.float32)
    for name in ("tril_", "triu_"):
        t = torch.from_numpy(x.copy())
        out = getattr(pt, name)(t, 1)
        want = getattr(paddle, name[:-1])(paddle.to_tensor(x), 1).numpy()
        assert out is t
        np.testing.assert_array_equal(t.numpy(), want)


def test_in_place_random():
    """normal_ and bernoulli_ fill the tensor they get, from the seeded
    generator."""
    pt.seed(1)
    a = pt.normal_(torch.zeros(1000), 2.0, 0.5)
    assert abs(a.mean().item() - 2.0) < 0.1 and abs(a.std().item() - 0.5) < 0.1
    pt.seed(1)
    assert torch.equal(pt.normal_(torch.zeros(1000), 2.0, 0.5), a)
    b = pt.bernoulli_(torch.zeros(1000), 0.25)
    assert set(b.unique().tolist()) <= {0.0, 1.0}
    assert 0.15 < b.mean().item() < 0.35
    e = pt.exponential_(torch.zeros(1000), lam=2.0)
    assert (e > 0).all() and abs(e.mean().item() - 0.5) < 0.1


def test_default_dtype_and_fill_types_follow_paddle():
    assert pt.full([2], 3).dtype == torch.int64       # reference int32, C26
    assert pt.full([2], True).dtype == torch.bool
    assert pt.arange(0, 1, 0.25).dtype == torch.float32
    assert pt.diag(torch.tensor([1.0, 2.0]), padding_value=9).tolist() == [
        [1.0, 9.0], [9.0, 2.0]]
    out = torch.zeros(2, 2)
    assert pt.assign(np.ones((2, 2), np.float32), output=out) is out
    assert out.sum().item() == 4.0
