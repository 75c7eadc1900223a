"""Rprop, ASGD, NAdam, RAdam and LBFGS in the port
(``paddle_tpu_torch/optimizer/extras.py``) against the reference's
(``paddle_tpu/optimizer/extras.py``), on the same numpy parameters and
grads: ``STEPS`` eager steps (the reference's ``fuse_step = False``), the
parameters and every slot within 1e-5 of each tensor's largest magnitude;
LBFGS's ``step(closure)`` on the same objective, with and without the
strong-Wolfe line search."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.framework.core import Parameter as JParameter, Tensor

from paddle_tpu_torch import optimizer as topt_mod
from test_torch_optimizers import NAMES, SHAPES

STEPS = 8          # RAdam rectifies from step 6 at beta2 0.999
REL_TOL = 1e-5

CONFIGS = {
    "rprop": ("Rprop", dict(learning_rate=0.01)),
    "rprop_range": ("Rprop", dict(learning_rate=0.05, etas=(0.3, 1.5),
                                  learning_rate_range=(1e-3, 0.08))),
    "asgd": ("ASGD", dict(learning_rate=0.05, batch_num=3,
                          weight_decay=0.01)),
    "nadam": ("NAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    "radam": ("RAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    "radam_fast": ("RAdam", dict(learning_rate=0.01, beta2=0.9)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x,
                      dtype=np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _run(cls_name, kw, seed=0):
    rng = np.random.RandomState(seed)
    init = [(rng.randn(*s) * 0.3).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 0.5).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    jps = [JParameter(jnp.asarray(a)) for a in init]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jo = getattr(jopt_mod, cls_name)(parameters=jps, **kw)
    jo.fuse_step = False
    to = getattr(topt_mod, cls_name)(parameters=list(zip(NAMES, tps)), **kw)
    for step_grads in grads:
        for jp, tp, g in zip(jps, tps, step_grads):
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    return jo, to, jps, tps


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_optimizer_matches_reference(config):
    jo, to, jps, tps = _run(*CONFIGS[config])
    for name, jp, tp in zip(NAMES, jps, tps):
        jslots, tslots = jo._slots[id(jp)], to.state[tp]
        assert set(tslots) - {"step"} == set(jslots), name
        assert tslots["step"] == STEPS
        for slot, value in jslots.items():
            _close(tslots[slot].numpy(), _np(value), (name, slot))
        _close(tp.detach().numpy(), _np(jp), name)


def _objective(lib, ws, x):
    """A least-squares fit with a small L2 term: convex, so neither
    package's iterates amplify the other's rounding."""
    r = lib.matmul(x, ws[0]) + ws[1] - 1.0
    return (r * r).mean() + (ws[0] * ws[0]).sum() * 0.01


def _lbfgs(lib, mod, params, x, **kw):
    opt = mod.LBFGS(parameters=params, **kw)

    def closure():
        opt.clear_grad()
        loss = _objective(lib, params, x)
        loss.backward()
        return loss

    losses = [float(np.asarray(_np(opt.step(closure)))) for _ in range(3)]
    return losses, [_np(p) if lib is paddle else p.detach().numpy()
                    for p in params]


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_with_a_closure_matches_reference(line_search):
    rng = np.random.RandomState(3)
    w0 = (rng.randn(4, 3) * 0.5).astype(np.float32)
    b0 = (rng.randn(3) * 0.1).astype(np.float32)
    x = rng.randn(8, 4).astype(np.float32)
    kw = dict(learning_rate=0.2, max_iter=5, history_size=4,
              line_search_fn=line_search)
    jl, jw = _lbfgs(paddle, jopt_mod,
                    [JParameter(jnp.asarray(w0)), JParameter(jnp.asarray(b0))],
                    paddle.to_tensor(x), **kw)
    tl, tw = _lbfgs(torch, topt_mod,
                    [torch.nn.Parameter(torch.from_numpy(w0.copy())),
                     torch.nn.Parameter(torch.from_numpy(b0.copy()))],
                    torch.from_numpy(x), **kw)
    np.testing.assert_allclose(tl, jl, rtol=REL_TOL)
    assert tl[-1] < tl[0]
    for got, want in zip(tw, jw):
        _close(got, want, "lbfgs params")
    with pytest.raises(ValueError):
        topt_mod.LBFGS(parameters=[torch.nn.Parameter(torch.ones(2))],
                       grad_clip=object())
