"""The port's Llama training step against the JAX package's eager loop.

``loss, logits = model(ids, labels=labels)``, ``loss.backward()``, then
``AdamW`` with ``ClipGradByGlobalNorm(1.0)`` under ``LinearWarmup`` into
``CosineAnnealingDecay``, on both sides, from the same weights
(``load_jax_state``) and the same numpy batch, in fp32 on the CPU. The
model is wide enough per head (``head_dim`` 64) and the batch long
enough (128 tokens) that the port's SDPA takes the flash route, so its
gradients come from the flash backward's plain version; the JAX package
takes its plain einsum on the CPU (``common.py:583-587`` needs a TPU).
Both are exact causal attention with no row lacking a key, so they
compute the same function.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Parameter as JParameter, Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.nn import clip_grad as jclip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import clip_grad as tclip
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: hidden 256 over 4 query heads and 2 kv heads: head_dim 64
CFG = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
           num_hidden_layers=2, intermediate_size=688,
           max_position_embeddings=256)
BATCH, SEQ, STEPS = 2, 128, 3
#: the loss, a mean of fp32 log-probabilities, relative
LOSS_RTOL = 1e-6
#: logits and gradients relative to each tensor's max: the same fp32
#: function, the matmuls summed in other orders by XLA and PyTorch
GRAD_RTOL = 1e-5
#: parameters after AdamW steps, per element: 1e-5 of each tensor's max
#: plus 5 % of the learning rates summed so far. Adam divides each grad
#: element by its own magnitude (+ eps = 1e-8), so an element whose grad
#: lies within the ulp-level noise of zero can move by up to lr more on
#: one side (measured on this model: 20 of 1.5 M elements beyond 1e-5
#: relative, the worst 2.4 % of the first step's lr). In aggregate the
#: updates agree within 3e-4 of their norm (measured 6.4e-5 after the
#: first step, 5.4e-6 after the third)
PARAM_RTOL, PARAM_LR_FRAC, UPDATE_RTOL = 1e-5, 0.05, 3e-4
NO_DECAY = "norm"


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (BATCH, SEQ)).astype(np.int64)
    labels = rng.randint(0, 128, (BATCH, SEQ)).astype(np.int64)
    labels[0, :5] = -100                       # ignored positions
    return ids, labels


def _decay(name):
    return NO_DECAY not in name


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


def _port_model(arrays, **kw):
    tm = pt.LlamaForCausalLM(pt.llama_tiny(**CFG, **kw), device="cpu")
    return pt.load_jax_state(tm, arrays)


@pytest.fixture(scope="module")
def runs():
    """Both loops, three steps each; per step the loss, logits and grads
    (JAX layout), and the parameters after the update."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(**CFG))
    for name, p in jm.named_parameters():
        p.name = name                  # apply_decay_param_fun sees names
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = _port_model(arrays)
    ids, labels = _batch()
    jsched, tsched = _schedule(jlr), _schedule(tlr)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters(),
                  grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                  apply_decay_param_fun=_decay)
    jopt.fuse_step = False             # the eager functional core
    topt = AdamW(learning_rate=tsched, parameters=tm.named_parameters(),
                 grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=_decay)
    out = {"arrays": arrays, "jax": [], "torch": [], "lr": []}
    for _ in range(STEPS):
        out["lr"].append(jsched())
        jloss, jlogits = jm(paddle.to_tensor(ids),
                            labels=paddle.to_tensor(labels))
        jloss.backward()
        jgrads = {n: _np(p.grad).copy() for n, p in jm.named_parameters()}
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        out["jax"].append(dict(
            loss=float(_np(jloss)), logits=_np(jlogits).copy(),
            grads=jgrads,
            params={n: _np(p).copy() for n, p in jm.named_parameters()}))

        tloss, tlogits = tm(ids, labels=labels)
        tloss.backward()
        tgrads = pt.jax_layout(tm, {n: p.grad
                                    for n, p in tm.named_parameters()})
        topt.step()
        topt.clear_grad()
        tsched.step()
        out["torch"].append(dict(
            loss=float(tloss.detach()), logits=tlogits.detach().numpy().copy(),
            grads=tgrads, params=pt.jax_layout(tm,
                                               dict(tm.named_parameters()))))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_and_logits_match_jax(runs, step):
    j, t = runs["jax"][step], runs["torch"][step]
    assert np.isfinite(t["loss"])
    assert abs(t["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"])
    assert t["logits"].shape == (BATCH, SEQ, 128)
    assert _rel(t["logits"], j["logits"]) <= GRAD_RTOL


@pytest.mark.parametrize("step", range(STEPS))
def test_every_gradient_matches_jax(runs, step):
    j, t = runs["jax"][step], runs["torch"][step]
    assert set(t["grads"]) == set(j["grads"]) == set(runs["arrays"])
    for name, want in j["grads"].items():
        assert t["grads"][name].shape == want.shape, name
        assert _rel(t["grads"][name], want) <= GRAD_RTOL, name


@pytest.mark.parametrize("step", range(STEPS))
def test_adamw_steps_match_jax(runs, step):
    j, t = runs["jax"][step], runs["torch"][step]
    lr_sum = sum(runs["lr"][:step + 1])
    moved, diff = [], []
    for name, want in j["params"].items():
        got = t["params"][name]
        tol = PARAM_RTOL * np.abs(want).max() + PARAM_LR_FRAC * lr_sum
        assert float(np.abs(got - want).max()) <= tol, name
        moved.append((want - runs["arrays"][name]).ravel())
        diff.append((got - want).ravel())
    moved, diff = np.concatenate(moved), np.concatenate(diff)
    assert float(np.abs(moved).max()) > 0.0
    assert np.linalg.norm(diff) <= UPDATE_RTOL * np.linalg.norm(moved)


def test_loss_decreases_over_the_steps(runs):
    losses = [r["loss"] for r in runs["torch"]]
    assert losses[2] < losses[0]


def test_recompute_gives_the_same_gradients(runs, monkeypatch):
    """``use_recompute=True`` drops each layer's activations and reruns
    its forward in backward: the flash forward runs twice per layer, the
    gradients do not change."""
    calls = {"fwd": 0, "dq": 0}
    real_fwd, real_dq = tfa.flash_attention_plain, tfa.flash_bwd_dq_plain

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def dq(*a, **kw):
        calls["dq"] += 1
        return real_dq(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_plain", dq)
    ids, labels = _batch()
    grads = {}
    for recompute in (False, True):
        tm = _port_model(runs["arrays"], use_recompute=recompute)
        calls.update(fwd=0, dq=0)
        loss, _ = tm(ids, labels=labels)
        loss.backward()
        layers = CFG["num_hidden_layers"]
        assert calls == {"fwd": layers * (2 if recompute else 1),
                         "dq": layers}, recompute
        grads[recompute] = {n: p.grad for n, p in tm.named_parameters()}
    for name, g in grads[False].items():
        np.testing.assert_array_equal(grads[True][name].numpy(), g.numpy())
    # eval mode and inference never recompute
    tm.eval()
    calls.update(fwd=0)
    with torch.no_grad():
        tm(ids)
    assert calls["fwd"] == CFG["num_hidden_layers"]


@pytest.mark.parametrize("granularity", ["full", "full_attn", "core_attn"])
def test_every_recompute_granularity_recomputes_whole_layers(runs,
                                                             granularity):
    """The reference stores any ``recompute_granularity`` and recomputes
    whole decoder layers (``llama.py:213-220``): the port's gradients
    under each are the non-recomputed ones bit for bit, and the
    reference's own under the same setting within GRAD_RTOL."""
    ids, labels = _batch()
    jm = JaxLlama(jtiny(**CFG, use_recompute=True,
                        recompute_granularity=granularity))
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in runs["arrays"].items()})
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    want = {n: _np(p.grad) for n, p in jm.named_parameters()}
    grads = {}
    for recompute in (False, True):
        tm = _port_model(runs["arrays"], use_recompute=recompute,
                         recompute_granularity=granularity)
        assert tm.config.recompute_granularity == granularity
        loss, _ = tm(ids, labels=labels)
        loss.backward()
        grads[recompute] = {n: p.grad for n, p in tm.named_parameters()}
    got = pt.jax_layout(tm, grads[True])
    assert set(got) == set(want)
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name
        assert _rel(got[name], want[name]) <= GRAD_RTOL, name


def test_criterion_matches_jax_and_ignores_labels():
    from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCrit
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 7)).astype(np.int64)
    labels[1, 2:] = -100
    want = float(_np(JCrit()(Tensor(jnp.asarray(logits)),
                             Tensor(jnp.asarray(labels)))))
    got = float(pt.LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                               torch.from_numpy(labels)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    every = torch.full((2, 7), -100)
    assert float(pt.LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                                every)) == 0.0


def test_jax_layout_round_trips(runs):
    tm = _port_model(runs["arrays"])
    back = pt.jax_layout(tm)
    assert set(back) == set(runs["arrays"])
    for name, a in back.items():
        np.testing.assert_array_equal(a, runs["arrays"][name])
    # copies: an in-place update of the model does not reach them
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    for name, a in back.items():
        np.testing.assert_array_equal(a, runs["arrays"][name])
    tm = _port_model(runs["arrays"])
    fresh = pt.LlamaForCausalLM(pt.llama_tiny(**CFG), device="cpu", seed=9)
    pt.load_jax_state(fresh, back)
    for (name, a), b in zip(tm.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# AdamW's functional core under multi_precision, on bf16 parameters
# ---------------------------------------------------------------------------

def test_multi_precision_adamw_matches_reference_core():
    """bf16 parameters with fp32 master weights and fp32 moments: the
    same numpy grads through the reference's eager step (``_apply`` via
    ``_masterized_apply``, grads clipped first) and the port's, three
    steps at a fixed rate with decay. Identical elementwise fp32
    arithmetic in the same order: the bf16 parameters must be equal, the
    master weights and moments within 1 fp32 ulp of their magnitude."""
    rng = np.random.RandomState(4)
    shapes = [(33, 17), (17,), (5, 3, 8)]
    init = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 0.5 for s in shapes]
             for _ in range(3)]
    jps = [JParameter(jnp.asarray(a, jnp.bfloat16)) for a in init]
    tps = [torch.nn.Parameter(torch.from_numpy(a).bfloat16()) for a in init]
    kw = dict(learning_rate=3e-3, weight_decay=0.1, multi_precision=True)
    jopt = JAdamW(parameters=jps, grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                  **kw)
    jopt.fuse_step = False
    topt = AdamW(parameters=tps, grad_clip=tclip.ClipGradByGlobalNorm(1.0),
                 **kw)
    for step_grads in grads:
        for jp, tp, g in zip(jps, tps, step_grads):
            jp.grad = Tensor(jnp.asarray(g, jnp.bfloat16))
            tp.grad = torch.from_numpy(g).bfloat16()
        jopt.step()
        topt.step()
        for jp, tp in zip(jps, tps):
            assert tp.dtype == torch.bfloat16
            want = np.asarray(_np(jp).astype(np.float32))
            np.testing.assert_array_equal(tp.detach().float().numpy(), want)
            jslots, tslots = jopt._slots[id(jp)], topt.state[tp]
            for slot in ("master", "moment1", "moment2"):
                got, ref = tslots[slot], np.asarray(jslots[slot])
                assert got.dtype == torch.float32, slot
                np.testing.assert_allclose(got.numpy(), ref,
                                           rtol=1.2e-7, atol=0, err_msg=slot)
            assert tslots["step"] == jopt._step_t[id(jp)]


def test_optimizer_state_dict_round_trip():
    ps = [torch.nn.Parameter(torch.ones(3) * i) for i in range(2)]
    sched = tlr.StepDecay(0.1, step_size=1)
    opt = AdamW(learning_rate=sched, parameters=[("a", ps[0]), ("b", ps[1])])
    for p in ps:
        p.grad = torch.ones(3)
    opt.step()
    sched.step()
    state = opt.state_dict()
    assert set(state) == {"a_moment1", "a_moment2", "a_step", "b_moment1",
                          "b_moment2", "b_step", "LR_Scheduler"}
    ps2 = [torch.nn.Parameter(torch.ones(3) * i) for i in range(2)]
    sched2 = tlr.StepDecay(0.1, step_size=1)
    opt2 = AdamW(learning_rate=sched2,
                 parameters=[("a", ps2[0]), ("b", ps2[1])])
    opt2.set_state_dict(state)
    assert sched2.last_epoch == sched.last_epoch
    for p, p2 in zip(ps, ps2):
        for k in ("moment1", "moment2"):
            assert torch.equal(opt.state[p][k], opt2.state[p2][k])
        assert opt2.state[p2]["step"] == 1
    # loaded states are copies: stepping one optimizer leaves the other
    before = [opt.state[p]["moment1"].clone() for p in ps]
    for p2 in ps2:
        p2.grad = torch.full((3,), 2.0)
    opt2.step()
    for p, b in zip(ps, before):
        assert torch.equal(opt.state[p]["moment1"], b)
    opt.clear_grad()
    assert all(p.grad is None for p in ps)


# ---------------------------------------------------------------------------
# clipping and schedules against the reference, on plain numbers
# ---------------------------------------------------------------------------

CLIPS = {
    "global_norm_clips": ("ClipGradByGlobalNorm", (1.0,)),
    "global_norm_passes": ("ClipGradByGlobalNorm", (100.0,)),
    "norm": ("ClipGradByNorm", (0.5,)),
    "value": ("ClipGradByValue", (0.3, -0.1)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_clips_match_reference(name, dtype):
    cls, args = CLIPS[name]
    rng = np.random.RandomState(len(name))
    gs = [rng.randn(*s).astype(np.float32) for s in ((4, 5), (7,))]
    jpairs = [(JParameter(jnp.zeros(g.shape)), Tensor(jnp.asarray(
        g, getattr(jnp, dtype)))) for g in gs]
    tpairs = [(torch.nn.Parameter(torch.zeros(g.shape)),
               torch.from_numpy(g).to(getattr(torch, dtype))) for g in gs]
    # the third pair has no grad and passes through untouched
    jpairs.append((JParameter(jnp.zeros(2)), None))
    tpairs.append((torch.nn.Parameter(torch.zeros(2)), None))
    want = getattr(jclip, cls)(*args)(jpairs)
    got = getattr(tclip, cls)(*args)(tpairs)
    assert got[-1][1] is None and want[-1][1] is None
    for (_, g), (_, w) in zip(got[:-1], want[:-1]):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(_np(w).astype(np.float32)),
                                   rtol=1e-6, atol=1e-7)


SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5),
    "piecewise": lambda m: m.PiecewiseDecay([3, 8], [0.1, 0.05, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.2),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=7),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=6, power=2.0, cycle=True),
    "linear_warmup_float": lambda m: m.LinearWarmup(
        0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=12), warmup_steps=4,
        start_lr=0.01, end_lr=0.1),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 15]),
    "step": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.5),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.9),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=8, eta_min=0.001),
    "cosine_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2, eta_min=0.001),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=18),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=18, anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=2, step_size_down=4, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode="exp_range", exp_gamma=0.9),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=10),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference(name):
    make = SCHEDULERS[name]
    js, ts = make(jlr), make(tlr)
    for _ in range(20):
        assert ts.last_lr == js.last_lr
        assert ts() == js()
        js.step()
        ts.step()
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_reference():
    js = jlr.ReduceOnPlateau(0.1, patience=2, cooldown=1, factor=0.5)
    ts = tlr.ReduceOnPlateau(0.1, patience=2, cooldown=1, factor=0.5)
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9,
               0.85, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.1]
    for i, x in enumerate(metrics):
        # the port takes a torch scalar where the reference takes a Tensor
        js.step(Tensor(jnp.asarray(x)) if i % 2 else x)
        ts.step(torch.tensor(x) if i % 2 else x)
        assert ts.last_lr == js.last_lr
    assert ts.last_lr < 0.1
