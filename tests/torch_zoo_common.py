"""Shared helpers of the model-zoo parity tests (``tests/test_torch_{
transformer,bert,gpt,gpt_serving,t5,moe,mixtral,mixtral_serving}.py``):
weights carried from the JAX model, the fp32 tolerance, the near-tie rule
for greedy streams, and the AMP dtype trace of both packages. Not a test
module (no ``test_`` prefix)."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.core import Tensor

import paddle_tpu_torch as pt

#: fp32 on both sides; the matmuls sum in different orders (XLA vs
#: PyTorch CPU), which moves values by a few ulp of their magnitude
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps a file
    from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_device():
    """``nn`` layers land on ``paddle.get_device()``; the CPU for the
    module, the previous device put back after."""
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def jt(a):
    return Tensor(jnp.asarray(a))


def npy(x):
    if isinstance(x, Tensor):
        return np.asarray(x._data)
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def arrays_of(jm):
    """The JAX model's ``state_dict`` as numpy arrays."""
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def close(got, want, what, tol=TOL):
    """``assert_allclose`` at ``tol``, the message giving the observed
    error ``max |got - want| / (atol + rtol |want|)`` (<= 1 passes)."""
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ratio = float(np.max(np.abs(got - want)
                         / (tol["atol"] + tol["rtol"] * np.abs(want)),
                         initial=0.0))
    np.testing.assert_allclose(got, want, **tol, err_msg=(
        f"{what}: max |got - want| / (atol + rtol |want|) = {ratio:.4g}, "
        f"tol {tol}"))


def close_to_scale(got, want, what, tol=1e-5):
    """``max |got - want| <= tol * max |want|``: the bound of a tensor
    whose values span signs at a large scale, where an element near zero
    carries the rounding of the whole scale."""
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (
        f"{what}: max |got - want| {err:.3e} > {tol} x max |want| "
        f"{scale:.3e}")


def jax_grads(jm):
    return {n: np.asarray(p.grad._data, np.float32)
            for n, p in jm.named_parameters() if p.grad is not None}


def port_grads(tm):
    """The port's gradients in the JAX layout (Linear weights
    transposed)."""
    return pt.jax_layout(tm, {n: p.grad for n, p in tm.named_parameters()
                              if p.grad is not None})


def close_grads(tm, jm, what, check=close):
    want, got = jax_grads(jm), port_grads(tm)
    assert set(got) == set(want), (set(got) ^ set(want))
    for name in sorted(want):
        check(got[name], want[name], f"{what}: grad {name}")


#: the near-tie rule (ROADMAP C29): a greedy stream may leave the
#: reference's only where the reference's top-two gap at that position is
#: within two roundoffs of fp32 at the largest logit
NEAR_TIE_ULPS = 2 * 2.0 ** -24


def top_two_gap(logits):
    top = np.sort(npy(logits).astype(np.float64))[-2:]
    return float(top[1] - top[0]), float(np.abs(npy(logits)).max())


def assert_stream(got, want, ref_logits, what):
    """``got`` equals ``want`` (``[b, n]`` ids), or leaves it first at a
    near-tie of the reference: ``ref_logits(row, prefix)`` gives the
    reference's next-token logits after ``prefix``. The first difference
    is reported with its position and gap either way."""
    got, want = npy(got).astype(np.int64), npy(want).astype(np.int64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for row in range(got.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if not diff.size:
            continue
        pos = int(diff[0])
        gap, scale = top_two_gap(ref_logits(row, want[row, :pos]))
        assert gap <= NEAR_TIE_ULPS * scale, (
            f"{what}: row {row} leaves the reference at position {pos} "
            f"({got[row, pos]} vs {want[row, pos]}); the reference's "
            f"top-two gap there {gap:.3e} of a {scale:.3e} scale is no "
            f"near-tie")


def dtype_name(dtype):
    """A dtype's name; integers as ``"int"`` (labels are int32 in the
    reference and int64 in the port)."""
    s = str(dtype).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


def jax_amp_trace(run, monkeypatch):
    """``run()`` with every ``tape._amp_cast_inputs`` call of the
    reference recorded but the policy's own ``"cast"``: ``(op, input
    dtypes, cast dtypes)``. Returns ``(run's result, trace)``."""
    from paddle_tpu.autograd import tape as jtape
    trace, inner = [], jtape._amp_cast_inputs

    def record(name, leaves):
        out = inner(name, leaves)
        if name != "cast":
            trace.append((name, tuple(dtype_name(a.dtype) for a in leaves
                                      if isinstance(a, Tensor)),
                          tuple(dtype_name(a.dtype) for a in out
                                if isinstance(a, Tensor))))
        return out

    monkeypatch.setattr(jtape, "_amp_cast_inputs", record)
    try:
        return run(), trace
    finally:
        monkeypatch.setattr(jtape, "_amp_cast_inputs", inner)


def torch_amp_trace(run):
    """``run()`` under ``amp.debugging.collect_operator_stats``: its
    result and the port's trace in :func:`jax_amp_trace`'s form."""
    from paddle_tpu_torch.amp import debugging
    with debugging.collect_operator_stats() as stats:
        out = run()
    return out, [(op, tuple(dtype_name(d) for d in ins),
                  tuple(dtype_name(d) for d in cs))
                 for op, ins, cs in stats.records]


def auto_cast(mod, kw):
    """``mod.auto_cast(**kw)``, or no block for ``kw`` None."""
    return mod.auto_cast(**kw) if kw else contextlib.nullcontext()
