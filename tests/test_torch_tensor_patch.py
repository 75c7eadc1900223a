"""``paddle.Tensor`` on the port: ``torch.Tensor`` with the Paddle members
it lacks (``paddle_tpu_torch/framework/tensor_patch.py``), against the
reference's ``Tensor`` (``paddle_tpu/framework/{core,tensor_patch}.py``).

* Every public name of the reference's ``Tensor`` is installed or left
  to torch (``KEPT``; ROADMAP C34 lists those whose meaning differs).
* ``import paddle_tpu_torch`` overrides nothing: in a fresh interpreter,
  every attribute ``torch.Tensor`` and its bases had before the import is
  the same object after it, and the only new names are the installed
  ones. (The worker has imported the package already, so the check runs
  in a subprocess.)
* Each installed op method is the port's op and gives the reference's
  method's values on the reference suite's inputs (``tests/
  test_op_suite.py``, drawn as the ops harness draws them); the members
  (``stop_gradient``, ``astype``, ``set_value``, ...) behave as the
  reference's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_op_suite import CASES
import test_torch_ops_harness as harness

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.framework import tensor_patch as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: installed op methods whose first argument is a list of tensors in the
#: reference suite: a tensor receiver means something else there, so
#: they are held to be the op itself only
LIST_FIRST = {"concat", "stack", "multiplex"}
#: the members held by hand below, not by a suite case
MEMBERS = {"apply", "astype", "cast", "clear_grad", "clear_gradient",
           "gradient", "persistable", "place", "placements", "process_mesh",
           "retain_grads", "set_value", "stop_gradient", "rank"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_names():
    return sorted(n for n in dir(paddle.Tensor) if not n.startswith("_"))


def test_every_reference_name_is_installed_or_kept():
    names = reference_names()
    assert len(names) > 300
    lost = [n for n in names if n not in tp.INSTALLED and n not in tp.KEPT]
    assert lost == []
    for n in tp.INSTALLED:
        assert n in vars(torch.Tensor), n
    assert set(tp.DIFFERS) <= set(tp.KEPT)
    assert set(tp.INSTALLED).isdisjoint(tp.KEPT)


def test_installed_methods_are_the_port_ops():
    for name in tp.INSTALLED:
        if name in MEMBERS - {"rank"} or name.endswith("_"):
            continue
        op = getattr(tops, name, None) or getattr(tops.linalg, name)
        assert vars(torch.Tensor)[name] is op, name


_IDENTITY_PROBE = textwrap.dedent("""
    import json, sys
    import torch
    before = {(c.__qualname__, k): v for c in torch.Tensor.__mro__
              for k, v in vars(c).items()}
    names = set(vars(torch.Tensor))
    import paddle_tpu_torch
    from paddle_tpu_torch.framework import tensor_patch as tp
    after = {(c.__qualname__, k): v for c in torch.Tensor.__mro__
             for k, v in vars(c).items()}
    changed = [f"{c}.{k}" for (c, k), v in before.items()
               if (c, k) not in after or after[(c, k)] is not v]
    added = sorted(set(vars(torch.Tensor)) - names)
    print(json.dumps({"changed": changed, "added": added,
                      "installed": sorted(tp.INSTALLED),
                      "checked": len(before)}))
""")


def test_import_overrides_no_attribute_of_torch_tensor():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _IDENTITY_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["checked"] > 500
    assert out["changed"] == []
    assert out["added"] == out["installed"]


def _method_cases():
    out = []
    for c in CASES:
        for name in (c.name, c.name + "_"):
            if name in tp.INSTALLED and c.name not in LIST_FIRST:
                out.append(pytest.param(c, name, id=f"{name}-{len(out)}"))
    return out


def _call_method(receiver, name, rest, kwargs):
    return getattr(receiver, name)(**rest, **kwargs)


@pytest.mark.parametrize("case,name", _method_cases())
def test_installed_method_equals_the_reference(case, name):
    inputs = harness.draw_inputs(case)
    first = next(iter(inputs))
    jrest = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in inputs.items() if k != first}
    trest = {k: harness.to_port(v) for k, v in inputs.items() if k != first}
    jrecv = paddle.to_tensor(inputs[first])
    trecv = harness.to_port(inputs[first])
    want = _call_method(jrecv, name, jrest, case.kwargs)
    got = _call_method(trecv, name, trest, case.kwargs)
    msg = f"Tensor.{name}: port vs reference"
    harness.assert_same(harness.to_numpy(got), case._unwrap(want),
                        case.rtol, case.atol, msg)
    if name.endswith("_"):              # the receiver holds the result
        harness.assert_same(harness.to_numpy(trecv), jrecv.numpy(),
                            case.rtol, case.atol, msg + " (receiver)")


def _pair(seed=0, shape=(2, 3)):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return a, paddle.to_tensor(a), torch.from_numpy(a.copy())


def test_stop_gradient_is_requires_grad():
    _, j, t = _pair()
    assert t.stop_gradient is j.stop_gradient is True
    t.stop_gradient = False
    assert t.requires_grad and not t.stop_gradient
    y = t * 2
    assert not y.stop_gradient
    y.stop_gradient = True              # cuts an intermediate
    assert not y.requires_grad
    t.stop_gradient = True
    assert not t.requires_grad


def test_astype_cast_and_rank():
    _, j, t = _pair(1)
    for dt in ("float64", "int32", "bool", "float16"):
        assert t.astype(dt).dtype == getattr(torch, dt)
        np.testing.assert_array_equal(t.astype(dt).numpy(),
                                      j.astype(dt).numpy())
        np.testing.assert_array_equal(t.cast(dt).numpy(),
                                      j.cast(dt).numpy())
    assert int(t.rank()) == int(paddle.rank(j).numpy())


def test_set_value_clear_grad_gradient_and_retain_grads():
    a, j, t = _pair(2)
    b = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    j.set_value(b)
    t.set_value(b)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    t.set_value(torch.ones(2, 3, dtype=torch.float64))
    assert t.dtype == torch.float32 and float(t.sum()) == 6.0
    with pytest.raises(ValueError):
        t.set_value(np.ones(3, np.float32))
    w = torch.from_numpy(a.copy()).requires_grad_()
    h = w * 3
    h.retain_grads()
    h.sum().backward()
    np.testing.assert_array_equal(h.grad.numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(w.gradient(), np.full((2, 3), 3.0))
    w.clear_grad()
    assert w.grad is None and w.gradient() is None
    w.grad = torch.ones_like(w)
    w.clear_gradient()
    assert w.grad is None


def test_place_and_attributes():
    _, j, t = _pair(4)
    assert t.place == pt.CPUPlace() and isinstance(t.place, pt.Place)
    assert pt.CUDAPlace(1) == pt.Place("gpu", 1) != pt.CPUPlace()
    assert t.persistable is j.persistable is False
    assert t.process_mesh is j.process_mesh is None
    assert t.placements is j.placements is None
    t.persistable = True                # an instance attribute
    assert t.persistable and torch.zeros(1).persistable is False


def test_apply_maps_each_element():
    _, j, t = _pair(5)
    f = lambda v: v * v + 1.0           # noqa: E731
    np.testing.assert_allclose(t.apply(f).numpy(), j.apply(f).numpy(),
                               rtol=1e-6)
    assert t.apply(f).dtype == torch.float32


def test_places_and_device_queries():
    assert pt.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert not pt.is_compiled_with_xpu()
    assert pt.device_count() == torch.cuda.device_count()
    dev = pt.get_device()
    try:
        assert pt.set_device(pt.CPUPlace()) == torch.device("cpu")
        assert pt.get_device() == "cpu"
    finally:
        pt.set_device(dev)


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_geometric_fill_differs_and_is_listed(p):
    """``geometric_`` keeps torch's meaning (C34): it counts trials, from
    1; the reference's fill draws its ``Geometric``, which counts failures,
    from 0. Both supports and both means over 20000 draws (within 4.5
    standard errors), and the port's ``distribution.Geometric`` counts
    as the reference's fill does."""
    assert "geometric_" in tp.DIFFERS and "geometric_" in tp.KEPT
    n = 20000
    se = 4.5 * np.sqrt((1 - p) / p ** 2 / n)
    torch.manual_seed(0)
    got = torch.empty(n).geometric_(p).numpy()
    paddle.seed(0)
    want = np.asarray(paddle.zeros([n]).geometric_(p).numpy())
    assert got.min() == 1.0 and want.min() == 0.0
    assert abs(got.mean() - 1 / p) < se and abs(want.mean() - (1 - p) / p) < se
    dev = pt.get_device()
    pt.set_device("cpu")
    try:
        pt.seed(0)
        port = pt.distribution.Geometric(p).sample((n,)).numpy()
    finally:
        pt.set_device(dev)
    assert port.min() == 0.0 and abs(port.mean() - (1 - p) / p) < se


def test_cauchy_and_log_normal_fills_mean_the_same():
    """``cauchy_`` and ``log_normal_`` keep torch's meaning, which is the
    reference's (C34): the same defaults (Cauchy(0, 1); the log of the
    draw Normal(1, 2)) and the same laws. Over 20000 draws the Cauchy
    quartiles sit within 0.05 of -1, 0, 1 in both, and the logs of the
    log-normal draws have mean 1 and standard deviation 2 (within 0.05)
    in both."""
    n = 20000
    assert "cauchy_" not in tp.DIFFERS and "log_normal_" not in tp.DIFFERS
    torch.manual_seed(1)
    paddle.seed(1)
    for fill in ("cauchy_", "log_normal_"):
        got = getattr(torch.empty(n), fill)().numpy().astype(np.float64)
        want = np.asarray(getattr(paddle.zeros([n]), fill)().numpy(),
                          np.float64)
        for draws in (got, want):
            if fill == "cauchy_":
                q = np.percentile(draws, [25, 50, 75])
                np.testing.assert_allclose(q, [-1, 0, 1], atol=0.05)
            else:
                assert (draws > 0).all()
                logs = np.log(draws)
                assert abs(logs.mean() - 1.0) < 0.05
                assert abs(logs.std() - 2.0) < 0.05
