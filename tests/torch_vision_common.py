"""Shared helpers of the vision, detection and layer parity tests
(``tests/test_torch_{vision_ops,vision_roi_ops,vision_deform,ppyoloe,
vit,vision_zoo,vision_zoo_alexnet,vision_blocks,
vision_blocks_more,inception_blocks,inception_blocks_cde,nn_extras,
rnn}.py``): the relative error, one function
run through both packages with its gradients, a model pair on shared
weights, and the module fixtures that put the port on the CPU with one
thread. Not a test module (no ``test_`` prefix)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt

#: fp32 on both sides, relative to each tensor's largest magnitude
TOL = 1e-5


@pytest.fixture(scope="module")
def port_on_cpu():
    """The port's layers on the CPU and torch on one thread for the
    module; the previous device and thread count put back after."""
    dev, n = pt.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def err(got, want):
    """``max |got - want| / max |want|`` in float64 (0 for empty)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def flat(out):
    """A result's tensors in order (tuples and lists flattened)."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return [out]


def run_both(jfn, tfn, arrays, diff=(), seed=5, tol=TOL):
    """``jfn`` on reference tensors and ``tfn`` on port tensors of
    ``arrays``: every output within ``tol`` of its largest magnitude, and
    the gradients of ``sum(out * cot)`` (seeded cotangents) of the inputs
    named in ``diff``. Returns the port's outputs."""
    jin = {k: paddle.to_tensor(a, stop_gradient=k not in diff)
           for k, a in arrays.items()}
    tin = {k: torch.from_numpy(a.copy()).requires_grad_(k in diff)
           for k, a in arrays.items()}
    jout, tout = flat(jfn(**jin)), flat(tfn(**tin))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == tuple(j.shape)
        assert err(npy(t), npy(j)) <= tol
    if diff:
        rng = np.random.default_rng(seed)
        cots = [rng.standard_normal(tuple(t.shape)).astype(np.float32)
                for t in tout]
        sum((j * paddle.to_tensor(c)).sum()
            for j, c in zip(jout, cots)).backward()
        sum((t * torch.from_numpy(c)).sum()
            for t, c in zip(tout, cots)).backward()
        for k in diff:
            assert err(npy(tin[k].grad), npy(jin[k].grad)) <= tol, k
    return tout


def model_pair(jbuild, tbuild, seed=0):
    """The reference's model from ``jbuild()`` after ``paddle.seed``, the
    port's from ``tbuild()`` on the CPU, the reference's weights and
    buffers carried in."""
    paddle.seed(seed)
    jm = jbuild()
    tm = tbuild()
    pt.load_jax_state(tm, {k: np.asarray(v.numpy())
                           for k, v in jm.state_dict().items()})
    return jm, tm


#: ROADMAP C42, phase 8's rule (``chip_smoke.RESNET_FACTOR``) on the CPU:
#: where a gradient cancels (a BatchNorm's weight or bias feeding
#: another BatchNorm through a linear op), the two packages' fp32 values
#: may differ by more than ``TOL`` of their own small magnitude; the
#: port's distance from an fp64 run may then be this many times the
#: reference's
CANCEL_FACTOR = 8.0


def grads_of(m):
    """``m``'s parameter gradients in the reference's layout."""
    return pt.jax_layout(m, {n: p.grad for n, p in m.named_parameters()
                             if p.grad is not None})


def check_grads(jm, tm, tol=TOL, exact=None):
    """Every parameter's gradient, port against reference, within
    ``tol`` of the reference's largest magnitude; or, given ``exact``
    (the port's fp64 gradients, :func:`grads_of` a float64 copy), by
    C42's rule."""
    tg = grads_of(tm)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
          if p.grad is not None}
    assert set(tg) == set(jg)
    for n in jg:
        e = err(tg[n], jg[n])
        if e <= tol:
            continue
        assert exact is not None, (n, e)
        port_d, ref_d = err(tg[n], exact[n]), err(jg[n], exact[n])
        assert port_d <= max(CANCEL_FACTOR * ref_d, tol), (n, e, port_d,
                                                           ref_d)
