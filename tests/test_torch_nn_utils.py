"""The port's ``nn.utils`` against ``paddle_tpu.nn.utils`` on a Conv2D
(whose weight layout the packages share): ``weight_norm`` (its ``g``,
``v`` and forward, then ``remove_weight_norm``), ``spectral_norm`` (the
forward once the power iteration has converged: its start vector is a
draw, ROADMAP C2), and ``parameters_to_vector`` /
``vector_to_parameters``. Tolerances beside each check."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import utils as jutils

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.nn import utils as tutils

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _convs():
    paddle.seed(4)
    j = jnn.Conv2D(3, 4, 3, padding=1)
    t = tnn.Conv2D(3, 4, 3, padding=1)
    pt.load_jax_state(t, {k: np.asarray(v.numpy())
                          for k, v in j.state_dict().items()})
    x = np.random.RandomState(8).randn(2, 3, 5, 5).astype(np.float32)
    return j, t, x


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_weight_norm_and_its_removal():
    j, t, x = _convs()
    jutils.weight_norm(j)
    tutils.weight_norm(t)
    assert [n for n, _ in t.named_parameters()] == [
        n for n, _ in j.named_parameters()] == ["bias", "weight_g",
                                                 "weight_v"]
    _close(t.weight_g, j.weight_g)
    _close(t.weight_v, j.weight_v)
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))
    with torch.no_grad():
        t.weight_g.mul_(2.0)
    j.weight_g.set_value(j.weight_g.numpy() * 2.0)
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))
    t(torch.from_numpy(x)).sum().backward()
    assert t.weight_g.grad is not None and t.weight_v.grad is not None
    tutils.remove_weight_norm(t)
    assert sorted(n for n, _ in t.named_parameters()) == ["bias", "weight"]
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))


def test_spectral_norm_converged_forward():
    """50 power iterations from either package's start vector converge
    to the same largest singular value (1e-5)."""
    j, t, x = _convs()
    jutils.spectral_norm(j, n_power_iterations=50)
    tutils.spectral_norm(t, n_power_iterations=50)
    assert [n for n, _ in t.named_parameters()] == [
        n for n, _ in j.named_parameters()]
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))
    w = t.weight_orig.detach().reshape(4, -1).double()
    sigma = torch.linalg.svdvals(w)[0]
    _close(t.weight.double(), (t.weight_orig.detach().double() / sigma))
    t(torch.from_numpy(x)).sum().backward()
    assert t.weight_orig.grad is not None       # C30


def test_parameters_to_vector_and_back():
    j, t, _ = _convs()
    jv = jutils.parameters_to_vector(j.parameters())
    tv = tutils.parameters_to_vector(t.parameters())
    _close(tv, jv)
    new = np.arange(tv.numel(), dtype=np.float32) / 100
    jutils.vector_to_parameters(paddle.to_tensor(new), j.parameters())
    tutils.vector_to_parameters(torch.from_numpy(new), t.parameters())
    for (n, p), (_, q) in zip(t.named_parameters(), j.named_parameters()):
        _close(p, q)


def test_clip_functions_are_exported():
    assert tutils.clip_grad_norm_ is tnn.clip_grad_norm_
    assert tutils.clip_grad_value_ is tnn.clip_grad_value_
