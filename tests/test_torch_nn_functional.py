"""The port's ``nn.functional`` against the reference's, op by op.

One case (or more) per op of the reference registry's ``functional``
module and per alias the registry records for it
(``paddle_tpu.ops.schema.build_registry``): the same seeded numpy inputs
through ``paddle_tpu.nn.functional`` and ``paddle_tpu_torch.nn.functional``
on the CPU. Forward: every output's dtype (int64 where the reference
narrows to int32, ROADMAP C26) and values, integers exactly, floats
within ``tol`` of the reference's largest magnitude (``FWD_TOL`` unless
the case says). Gradient: of ``sum(out * cot)`` over the float outputs,
``cot`` seeded, for every float input, the reference's tape backward
against torch autograd, within ``GRAD_TOL`` of the reference gradient's
largest magnitude. The random ops' random modes are held statistically
and within the port (``test_random_*``); their deterministic modes are
cases. ``test_every_reference_op_has_a_case`` is the coverage gate.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu.autograd import tape as jtape
from paddle_tpu.framework.core import Tensor
from paddle_tpu.ops.schema import build_registry

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.framework import core as tcore

from torch_nn_cases import (CASES, FWD_TOL, GRAD_TOL,  # noqa: F401
                            RANDOM_ONLY, case_arrays, case_id, flat_outputs)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1.0))


def _run(case, arrays, grad):
    """The reference's and the port's outputs (numpy) and, with ``grad``,
    the gradients of every float input not in ``nograd``."""
    diff = {k for k, a in arrays.items()
            if _is_float(a) and k not in case.nograd and grad}
    jt = {k: paddle.to_tensor(a, stop_gradient=k not in diff)
          for k, a in arrays.items()}
    tt = {k: torch.from_numpy(a.copy()).requires_grad_(k in diff)
          for k, a in arrays.items()}
    jout, tout = flat_outputs(case.fn(JF, jt)), flat_outputs(case.fn(TF, tt))
    res = {"fwd": ([_np(o) for o in jout], [_np(o) for o in tout])}
    if not diff:
        return res
    cot_rng = np.random.RandomState(
        zlib.crc32(b"cot" + case_id(case).encode()))
    jloss = tloss = 0.0
    for jo, to in zip(jout, tout):
        if not _is_float(_np(jo)):
            continue
        cot = np.asarray(cot_rng.randn(*_np(jo).shape), np.float32)
        jloss = jloss + (jo * paddle.to_tensor(cot)).sum()
        tloss = tloss + (to * torch.from_numpy(cot)).sum()
    jloss.backward()
    tloss.backward()
    res["grad"] = {k: (None if jt[k].grad is None else _np(jt[k].grad),
                       None if tt[k].grad is None else _np(tt[k].grad))
                   for k in sorted(diff)}
    return res


def _same_dtype(got, want):
    c26 = {np.dtype(np.int64): np.dtype(np.int32)}
    return got == want or c26.get(got) == want


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_functional_matches_reference(case):
    arrays = case_arrays(case)
    res = _run(case, arrays, case.grad)
    want, got = res["fwd"]
    assert len(got) == len(want), f"{len(got)} outputs, want {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"out {i}: shape {g.shape} vs {w.shape}"
        assert _same_dtype(g.dtype, w.dtype), (
            f"out {i}: dtype {g.dtype} vs {w.dtype}")
        if _is_float(w):
            err = _rel_err(g, w)
            assert err <= case.tol, f"out {i}: forward error {err:.3e}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"out {i}")
    for k, (w, g) in res.get("grad", {}).items():
        # no gradient at all (None) counts as a zero one
        w = np.zeros(arrays[k].shape, np.float32) if w is None else w
        g = np.zeros(arrays[k].shape, np.float32) if g is None else g
        err = _rel_err(g, w)
        assert err <= case.gtol, f"grad of {k}: error {err:.3e}"


def _reference_ops():
    reg = build_registry()
    return {n for n, s in reg.items()
            if s.module == "functional" or "functional" in s.aliases}


def test_every_reference_op_has_a_case():
    """The coverage gate: every op of the reference registry's functional
    module (111) and every alias it records there (7) has a case or a
    statistical test, and each exists in the port."""
    ref = _reference_ops()
    assert len(ref) == 118
    covered = {c.op for c in CASES} | RANDOM_ONLY
    assert sorted(ref - covered) == []
    assert sorted(n for n in ref if not callable(getattr(TF, n, None))) == []


# ---------------------------------------------------------------------------
# random modes: statistics, and reproduction within the port (ROADMAP C2)
# ---------------------------------------------------------------------------

def _seeded(fn, s):
    pt.seed(s)
    return fn()


def _reproduces(fn):
    a, b, c = _seeded(fn, 5), _seeded(fn, 5), _seeded(fn, 6)
    for x, y in zip(flat_outputs(a), flat_outputs(b)):
        assert torch.equal(x, y), "the same seed drew another stream"
    assert any(not torch.equal(x, y) for x, y in zip(flat_outputs(a), flat_outputs(c))), (
        "another seed drew the same stream")
    return a


def _binomial_ok(kept, n, p):
    """``kept`` of ``n`` within 5 standard deviations of ``n p``."""
    return abs(kept - n * p) <= 5 * np.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_random_dropout(mode):
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        1, 2, (200, 100)).astype(np.float32))
    out = _reproduces(lambda: TF.dropout(x, 0.3, mode=mode))
    kept = out != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 0.7)
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(out[kept], (x * scale)[kept], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("fn,shape", [
    (lambda x: TF.dropout(x, 0.5, axis=[0, 1]), (40, 50, 6)),
    (lambda x: TF.dropout2d(x, 0.5), (40, 50, 3, 3)),
    (lambda x: TF.dropout3d(x, 0.5), (40, 50, 2, 2, 2)),
    (lambda x: TF.feature_alpha_dropout(x, 0.5), (40, 50, 4))],
    ids=["axis", "2d", "3d", "feature_alpha"])
def test_random_dropout_whole_channels(fn, shape):
    """The mask is shared along the axes outside ``axis`` (whole channels
    for the 2-D, 3-D and feature-alpha variants), drops about half."""
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        1, 2, shape).astype(np.float32))
    out = _reproduces(lambda: fn(x))
    flat = out.reshape(shape[0], shape[1], -1)
    dropped = (flat.amax(-1) - flat.amin(-1)) < 1e-6
    assert _binomial_ok(int(dropped.sum()), shape[0] * shape[1], 0.5)


def test_random_alpha_dropout_keeps_mean_and_variance():
    x = torch.from_numpy(np.random.RandomState(3).randn(400, 500)
                         .astype(np.float32))
    out = _reproduces(lambda: TF.alpha_dropout(x, 0.2))
    assert abs(float(out.mean())) < 0.02
    assert abs(float(out.std()) - 1.0) < 0.02


def test_random_rrelu_slopes():
    x = -torch.from_numpy(np.random.RandomState(4).uniform(
        0.5, 1.5, (300, 300)).astype(np.float32))
    out = _reproduces(lambda: TF.rrelu(x, 0.1, 0.3))
    slope = out / x
    assert float(slope.min()) >= 0.1 - 1e-6 and float(slope.max()) <= 0.3 + 1e-6
    assert abs(float(slope.mean()) - 0.2) < 0.003


@pytest.mark.parametrize("hard", [False, True])
def test_random_gumbel_softmax(hard):
    """Rows sum to 1 (one-hot with ``hard``), and the argmax falls on each
    class about as often as ``softmax(x)`` says."""
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    x = torch.from_numpy(np.tile(logits, (20000, 1)))
    out = _reproduces(lambda: TF.gumbel_softmax(x, hard=hard))
    torch.testing.assert_close(out.sum(-1), torch.ones(20000), rtol=0,
                               atol=1e-5)
    if hard:
        assert set(out.unique().tolist()) == {0.0, 1.0}
    freq = torch.bincount(out.argmax(-1), minlength=4).numpy() / 20000
    assert np.abs(freq - np.exp(logits)).max() < 0.015
    g = x.clone().requires_grad_(True)
    TF.gumbel_softmax(g, hard=hard)[:, 0].sum().backward()
    assert g.grad is not None and float(g.grad.abs().sum()) > 0


def test_random_class_center_sample():
    """Every positive class first (sorted), then sorted negatives up to
    ``num_samples``; labels remapped into the sample."""
    y = torch.tensor([1, 7, 3, 3, 9, 1])
    remap, sampled = _reproduces(lambda: TF.class_center_sample(y, 20, 8))
    s = sampled.tolist()
    assert s[:4] == [1, 3, 7, 9] and len(s) == 8 and len(set(s)) == 8
    assert s[4:] == sorted(s[4:]) and not set(s[4:]) & {1, 3, 7, 9}
    assert [s[i] for i in remap.tolist()] == y.tolist()


# ---------------------------------------------------------------------------
# the AMP dtype trace
# ---------------------------------------------------------------------------

def _dt(d):
    s = str(d).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


#: a sample beside the ResNet trace of ``tests/test_torch_resnet.py``
#: (which covers conv2d, batch_norm, relu, pooling, linear, cross_entropy)
TRACED = ["layer_norm", "group_norm", "softmax", "interpolate", "embedding",
          "batch_norm", "max_pool2d", "cross_entropy"]


@pytest.mark.parametrize("level,dtype", [("O1", "float16"),
                                         ("O2", "bfloat16")])
def test_amp_dtype_trace_equals_reference(level, dtype, monkeypatch):
    """Under O1 fp16 and O2 bf16, a sample of ops records the reference's
    op names, input dtypes and cast dtypes, call by call."""
    cases = [c for c in CASES if c.op in TRACED and "nhwc" not in c.tag]
    assert {c.op for c in cases} == set(TRACED)
    trace, inner = [], jtape._amp_cast_inputs

    def record(name, leaves):
        out = inner(name, leaves)
        if name != "cast":
            trace.append((name, tuple(_dt(a.dtype) for a in leaves
                                      if isinstance(a, Tensor)),
                          tuple(_dt(a.dtype) for a in out
                                if isinstance(a, Tensor))))
        return out

    monkeypatch.setattr(jtape, "_amp_cast_inputs", record)
    for case in cases:
        arrays = case_arrays(case)
        jt = {k: paddle.to_tensor(a) for k, a in arrays.items()}
        tt = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
        trace.clear()
        with jamp.auto_cast(level=level, dtype=dtype):
            jout = flat_outputs(case.fn(JF, jt))
        with debugging.collect_operator_stats() as stats:
            with tamp.auto_cast(level=level, dtype=dtype):
                tout = flat_outputs(case.fn(TF, tt))
        got = [(op, tuple(_dt(d) for d in ins), tuple(_dt(d) for d in cs))
               for op, ins, cs in stats.records]
        assert got == trace, case_id(case)
        for j, t in zip(jout, tout):
            assert _dt(t.dtype) == _dt(j.dtype), (case_id(case), t.dtype,
                                                   j.dtype)
