"""The port's mixture of experts (``paddle_tpu_torch/incubate/distributed/
models/moe``) against the reference's (``paddle_tpu/incubate/distributed/
models/moe/__init__.py``), fp32, CPU: the GShard plan (dispatch bit-equal
from the same logits, exact ties to the lower expert, capacity drops;
combine weights bit-equal from the same probabilities), ``MoELayer`` with
each gate, the stacked experts and an expert list (outputs, aux losses,
gradients within ``rtol = atol = 1e-5``), and the capacity rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.incubate.distributed.models import moe as jmoe

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from torch_zoo_common import (arrays_of, close, close_grads,  # noqa: F401
                              cpu_device, jt, npy, one_torch_thread)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, cpu_device, _no_reference_mesh):  # noqa: F811
    yield


def _tied_logits(s=48, e=8, seed=0):
    """Router logits on a grid of five values: most rows hold exact ties."""
    return np.random.RandomState(seed).randint(-2, 3, (s, e)).astype(
        np.float32)


@pytest.mark.parametrize("top_k,cf", [(2, 0.5), (1, 0.25), (2, 2.0)])
def test_plan_is_bit_equal_with_ties_and_drops(top_k, cf):
    """Dispatch bit-equal from the same logits; every row's choices go to
    the lower expert on a tie; low capacity factors drop choices (by
    choice rank, then token); the combine weights bit-equal from the same
    probabilities (the softmax's ``exp`` may differ by an ulp between XLA
    and torch, ROADMAP C37), the probabilities within 1e-5."""
    logits = _tied_logits()
    s, e = logits.shape
    cap = tmoe.moe_capacity(s, e, top_k, cf)
    assert cap == jmoe.moe_capacity(s, e, top_k, cf)
    jp, jd, jc = (np.asarray(a) for a in jmoe.plan_dispatch(
        jnp.asarray(logits), cap, top_k))
    tp, td, tc = tmoe.plan_dispatch(torch.from_numpy(logits), cap, top_k)
    np.testing.assert_array_equal(npy(td), jd)
    close(tp, jp, "router probabilities")
    td2, tc2 = tmoe._plan_from_probs(torch.from_numpy(jp.copy()), cap,
                                     top_k)
    np.testing.assert_array_equal(npy(td2), jd)
    np.testing.assert_array_equal(npy(tc2), jc)
    kept = jd.sum((1, 2))
    if cf < 1:
        assert (kept < top_k).any(), "no choice dropped"
    else:
        assert (kept == top_k).all()
    ties = (logits == logits.max(-1, keepdims=True)).sum(-1) > 1
    assert ties.sum() > 5


def test_plan_on_continuous_logits_follows_the_near_tie_rule():
    """Random router logits: the port's choices are the reference's, or
    differ only at a row whose k-th and (k+1)-th reference probabilities
    lie within two fp32 roundoffs (reported, not hidden by another
    seed)."""
    rng = np.random.RandomState(1)
    logits = (rng.randn(256, 8) * 2).astype(np.float32)
    cap = jmoe.moe_capacity(256, 8, 2, 1.25)
    jp, jd, _ = (np.asarray(a) for a in jmoe.plan_dispatch(
        jnp.asarray(logits), cap, 2))
    _, td, _ = tmoe.plan_dispatch(torch.from_numpy(logits), cap, 2)
    rows = np.nonzero((npy(td) != jd).any((1, 2)))[0]
    srt = np.sort(jp, -1)[:, ::-1]
    for r in rows:
        gap = srt[r, 1] - srt[r, 2]
        assert gap <= 2 * 2.0 ** -24 * srt[r, 0], (r, gap)


def test_plan_has_no_data_dependent_shapes():
    """Static in shape: the plan traces whole (a CUDA graph captures it)."""
    f = torch.compile(tmoe.plan_dispatch, backend="eager", fullgraph=True)
    _, d, c = f(torch.from_numpy(_tied_logits()), 6, 2)
    assert d.shape == c.shape == (48, 8, 6)


def _layers(seed, **kw):
    paddle.seed(seed)
    jl = jmoe.MoELayer(**kw)
    tl = tmoe.MoELayer(**kw)
    pt.load_jax_state(tl, arrays_of(jl))
    return jl, tl


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _step(layer, x, cot, lib):
    if lib == "jax":
        out = layer(jt(x))
        ((out * jt(cot)).sum() + layer.aux_loss).backward()
    else:
        out = layer(torch.from_numpy(x))
        ((out * torch.from_numpy(cot)).sum() + layer.aux_loss).backward()
    return out, layer.aux_loss


@pytest.mark.parametrize("gate,top_k,cf", [("gshard", 2, 1.25),
                                           ("switch", 2, 0.5),
                                           ("naive", 1, 2.0)])
def test_stacked_moe_layer_matches_reference(gate, top_k, cf):
    jl, tl = _layers(gate == "switch", d_model=16, num_experts=4,
                     d_hidden=32, gate=gate, top_k=top_k,
                     capacity_factor=cf)
    x, cot = _x((2, 8, 16), 2), _x((2, 8, 16), 3)
    jout, jaux = _step(jl, x, cot, "jax")
    tout, taux = _step(tl, x, cot, "torch")
    close(tout, jout, f"{gate} output")
    close(taux, jaux, f"{gate} aux loss")
    aux = float(taux.detach())
    assert aux > 0 if gate != "naive" else aux == 0.0
    close_grads(tl, jl, f"{gate} MoE")


def test_expert_list_moe_layer_matches_reference():
    paddle.seed(4)
    jl = jmoe.MoELayer(d_model=8, experts=[jnn.Linear(8, 8)
                                            for _ in range(3)],
                       gate="gshard", top_k=2, capacity_factor=1.0)
    tl = tmoe.MoELayer(d_model=8, experts=[pt.nn.Linear(8, 8)
                                            for _ in range(3)],
                       gate="gshard", top_k=2, capacity_factor=1.0)
    pt.load_jax_state(tl, arrays_of(jl))
    x, cot = _x((1, 12, 8), 5), _x((1, 12, 8), 6)
    jout, jaux = _step(jl, x, cot, "jax")
    tout, taux = _step(tl, x, cot, "torch")
    close(tout, jout, "expert-list output")
    close(taux, jaux, "expert-list aux loss")
    close_grads(tl, jl, "expert-list MoE")


def test_gate_config_dict_and_names():
    tl = tmoe.MoELayer(d_model=8, num_experts=4, d_hidden=8,
                       gate={"type": "switch", "top_k": 1})
    assert isinstance(tl.gate, tmoe.SwitchGate) and tl.top_k == 1
    g = tmoe.NaiveGate(8, num_expert=2, world_size=2)
    assert g.num_experts == 4 and tuple(g.weight.shape) == (8, 4)
    assert tmoe.ep_axis_for(8) is None
    assert [tmoe.moe_capacity(n, 8, 2, 2.0) for n in (1, 7, 64)] == \
        [jmoe.moe_capacity(n, 8, 2, 2.0) for n in (1, 7, 64)]
    x = torch.from_numpy(_x((3, 8), 7))
    close(g.gate_logits(x), x @ g.weight, "gate logits")
