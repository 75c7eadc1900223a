"""Paddle's other optimizers and its regularizers in the port
(``optimizer/__init__.py``) against the JAX package's eager step.

Each optimizer runs 3 steps on the same numpy parameters and grads in
both packages, in fp32 and on bf16 parameters under ``multi_precision``
(fp32 master weights), with the reference's eager loop (``fuse_step =
False``). Both compute the same elementwise fp32 ops in the same order,
so the parameters, master weights and slots agree within 1e-6 of each
tensor's max (Lamb's two norms sum in other orders); a bf16 parameter
within one bf16 ulp. The ``state_dict`` names are the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.framework.core import Parameter as JParameter, Tensor
from paddle_tpu.nn import clip_grad as jclip

from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.nn import ClipGradByGlobalNorm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 3
REL_TOL = 1e-6
SHAPES = [(9, 7), (13,), (4, 3, 5), (6,)]
NAMES = ["w_a", "b_a", "w_norm", "w_b"]

#: name -> (class, constructor arguments); ``reg`` puts L1Decay or L2Decay
#: objects where the reference takes them
CONFIGS = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_l2": ("SGD", dict(learning_rate=0.1, weight_decay=("l2", 0.05))),
    "sgd_l1": ("SGD", dict(learning_rate=0.1, weight_decay=("l1", 0.02))),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                           use_nesterov=True)),
    "adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True, weight_decay=0.01)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02)),
    "lamb_exclude": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.02,
                                  exclude_from_weight_decay_fn="norm")),
    "adam_l1": ("Adam", dict(learning_rate=0.01, weight_decay=("l1", 0.01))),
    "adamw_l2": ("AdamW", dict(learning_rate=0.01,
                               weight_decay=("l2", 0.05))),
}


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x,
                      dtype=np.float32)


def _kwargs(kw, mod, params):
    out = dict(kw)
    wd = out.get("weight_decay")
    if isinstance(wd, tuple):
        out["weight_decay"] = (mod.L1Decay if wd[0] == "l1"
                               else mod.L2Decay)(wd[1])
    if out.get("exclude_from_weight_decay_fn") == "norm":
        names = {id(p): n for n, p in params}
        out["exclude_from_weight_decay_fn"] = \
            lambda p: "norm" in names[id(p)]
    return out


def _setup(dtype, per_param=False, seed=0):
    rng = np.random.RandomState(seed)
    init = [(rng.randn(*s) * 0.3).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 0.5).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    jps = [JParameter(jnp.asarray(a, getattr(jnp, dtype))) for a in init]
    tps = [torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
           for a in init]
    for n, jp in zip(NAMES, jps):
        jp.name = n
    if per_param:
        # a per-parameter rate, and per-parameter L2 / L1 regularizers
        for jp, tp in ((jps[1], tps[1]),):
            jp.optimize_attr = {"learning_rate": 3.0}
            tp.optimize_attr = {"learning_rate": 3.0}
        jps[2].regularizer = jopt_mod.L2Decay(0.2)
        tps[2].regularizer = topt_mod.L2Decay(0.2)
        jps[3].regularizer = jopt_mod.L1Decay(0.03)
        tps[3].regularizer = topt_mod.L1Decay(0.03)
    return jps, tps, grads


def _run(cls_name, kw, dtype, per_param=False, groups=False, clip=False):
    jps, tps, grads = _setup(dtype, per_param)
    mp = dtype != "float32"
    tnamed = list(zip(NAMES, tps))
    jkw = _kwargs(kw, jopt_mod, list(zip(NAMES, jps)))
    tkw = _kwargs(kw, topt_mod, tnamed)
    jparams, tparams = jps, tnamed
    if groups:
        jparams = [{"params": jps[:2]}, {"params": jps[2:]}]
        tparams = [{"params": tnamed[:2]}, {"params": tnamed[2:]}]
    jo = getattr(jopt_mod, cls_name)(
        parameters=jparams, multi_precision=mp,
        grad_clip=jclip.ClipGradByGlobalNorm(1.0) if clip else None, **jkw)
    jo.fuse_step = False
    to = getattr(topt_mod, cls_name)(
        parameters=tparams, multi_precision=mp,
        grad_clip=ClipGradByGlobalNorm(1.0) if clip else None, **tkw)
    for step_grads in grads:
        for jp, tp, g in zip(jps, tps, step_grads):
            jp.grad = Tensor(jnp.asarray(g, jp._data.dtype))
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    return jo, to, jps, tps


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _compare(jo, to, jps, tps):
    for name, jp, tp in zip(NAMES, jps, tps):
        jslots, tslots = jo._slots[id(jp)], to.state[tp]
        assert set(tslots) - {"step"} == set(jslots), name
        assert tslots["step"] == jo._step_t[id(jp)]
        for slot, value in jslots.items():
            assert str(tslots[slot].dtype).split(".")[1] == str(
                value.dtype), (name, slot)
            _close(tslots[slot].float().numpy(), _np(value), (name, slot))
        want, got = _np(jp), tp.detach().float().numpy()
        assert tp.dtype == getattr(torch, str(jp._data.dtype))
        if tp.dtype == torch.bfloat16:
            assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want)), \
                name
        else:
            _close(got, want, name)
        assert not np.array_equal(got, np.asarray(
            _setup("float32")[1][NAMES.index(name)].detach().numpy())), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_optimizer_matches_reference_eager_step(config, dtype):
    cls_name, kw = CONFIGS[config]
    _compare(*_run(cls_name, kw, dtype))


@pytest.mark.parametrize("config", ["sgd_l2", "momentum", "adamax",
                                    "rmsprop", "adam_l1", "adamw_l2"])
def test_per_parameter_rates_and_regularizers_in_groups(config):
    """``optimize_attr["learning_rate"]`` on one parameter, a per-parameter
    L2Decay and L1Decay overriding the optimizer's, the parameters passed
    as two groups, and the global-norm clip."""
    cls_name, kw = CONFIGS[config]
    _compare(*_run(cls_name, kw, "float32", per_param=True, groups=True,
                   clip=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_state_dict_names_are_the_references(config, dtype):
    cls_name, kw = CONFIGS[config]
    jo, to, _, _ = _run(cls_name, kw, dtype)
    want = {k for k in jo.state_dict() if k != "LR_Scheduler"}
    assert set(to.state_dict()) == want


def test_l1_parameters_and_other_optimizers_take_the_eager_loop():
    """The fused engine takes only Adam and AdamW groups: an SGD step of
    20 parameters dispatches them all eagerly, and an L1-regularised
    AdamW parameter too."""
    ps = [torch.nn.Parameter(torch.randn(4)) for _ in range(20)]
    sgd = topt_mod.SGD(learning_rate=0.1, parameters=ps)
    adamw = topt_mod.AdamW(learning_rate=0.1, parameters=ps)
    ps[0].regularizer = topt_mod.L1Decay(0.1)
    for opt in (sgd, adamw):
        for p in ps:
            p.grad = torch.ones(4)
        opt.step()
    assert sgd._fused_engine.dispatches == {"eager": 20, "fused": 0}
    assert adamw._fused_engine.dispatches == {"eager": 1, "fused": 1}
