"""The port's fused optimizer step (``optimizer/fused.py`` and the plain
versions of kernels K-A and K-B in ``ops/optimizer_step.py``) against its
own eager loop and the JAX package's.

On the CPU a fused group runs K-A's plain version, which must give the
eager loop's bits (the kernel is held to the same on the card by
``chip_smoke.py``). Against the reference: the engine's groups and
leftovers equal ``FusedStepEngine.step``'s, except that the port fuses
bf16 parameters with fp32 master weights, which the reference sends back
to its eager loop (``fused.py:14-17``); the updated tensors agree within
1e-5 of each tensor's max over 3 steps, the reference's own fused-vs-eager
bound (``fused.py:19-25``). Planted faults in the plain versions must
break the bit-for-bit comparison or K-B's 1e-6 bound.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.core import Parameter as JParameter, Tensor
from paddle_tpu.nn import clip_grad as jclip
from paddle_tpu.optimizer import Adam as JAdam, AdamW as JAdamW
from paddle_tpu.optimizer import L1Decay as JL1, L2Decay as JL2
from paddle_tpu.optimizer import fused as jfused

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue
from paddle_tpu_torch.ops import optimizer_step as ost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 3
#: the reference's fused-vs-eager bound, relative to each tensor's max
REL_TOL = 1e-5
#: K-B against an fp64 sum, relative
SUMSQ_TOL = 1e-6
#: shapes with tails that are no multiple of 8, and one of two chunks
SHAPES = [(33, 17), (7,), (16,), (5, 3, 8), (64, 9), (3,), (24, 24),
          (1,), (40, 3), (11, 11), (8, 8), (13,), (2, ost.CHUNK + 3)]
KW = dict(learning_rate=3e-3, beta1=0.9, beta2=0.95, epsilon=1e-8)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x,
                      dtype=np.float32)


def _specs():
    """18 named parameters (19 occurrences: ``w0`` twice) with the
    attributes the engine keys on."""
    specs = [dict(name=f"w{i}", shape=s) for i, s in enumerate(SHAPES)]
    specs += [dict(name="norm_a", shape=(17,)),
              dict(name="norm_b", shape=(9,)),
              dict(name="l1_w", shape=(6, 5), reg=("l1", 0.01)),
              dict(name="fast_w", shape=(10, 3), lr=2.0),
              dict(name="reg_w", shape=(4, 4), reg=("l2", 0.05)),
              dict(name="noclip_w", shape=(12,), need_clip=False)]
    return specs


def _decay(name):
    return "norm" not in name


def _build(specs, dtypes, seed=0):
    """The same parameters and ``STEPS`` grads for both packages:
    ``(jax params, torch params, names, grads per step)``. ``dtypes``
    maps a name to ``"bfloat16"`` (default fp32)."""
    rng = np.random.RandomState(seed)
    jps, tps, names, init = [], [], [], []
    for s in specs:
        a = (rng.randn(*s["shape"]) * 0.1).astype(np.float32)
        dt = dtypes.get(s["name"], "float32")
        jp = JParameter(jnp.asarray(a, getattr(jnp, dt)))
        tp = torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dt)))
        jp.name = s["name"]
        for p in (jp, tp):
            if "lr" in s:
                p.optimize_attr = {"learning_rate": s["lr"]}
            if "reg" in s:
                kind, c = s["reg"]
                p.regularizer = (topt.L1Decay(c) if kind == "l1"
                                 else topt.L2Decay(c)) if p is tp else (
                    JL1(c) if kind == "l1" else JL2(c))
            if "need_clip" in s:
                p.need_clip = s["need_clip"]
        jps.append(jp)
        tps.append(tp)
        names.append(s["name"])
        init.append(a)
    grads = [[(rng.randn(*a.shape) * 0.5).astype(np.float32) for a in init]
             for _ in range(STEPS)]
    return jps, tps, names, grads


def _set_grads(jps, tps, step_grads):
    for jp, tp, g in zip(jps, tps, step_grads):
        jp.grad = Tensor(jnp.asarray(g, jp._data.dtype))
        tp.grad = torch.from_numpy(g).to(tp.dtype)


def _port_params(tps, names, dup=True):
    pairs = list(zip(names, tps))
    if dup:
        pairs.append(pairs[0])              # w0 a second time
    return pairs


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# groups, leftovers and dispatch counts against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def against_reference():
    """AdamW (multi_precision, global-norm clip, apply_decay_param_fun)
    over the mixed parameter set in two parameter groups, 3 steps: the
    reference with ``fuse_step = True``, the port on auto (19 >= 16).
    Records each step's groups, leftovers, dispatch counts and tensors."""
    specs = _specs()
    jps, tps, names, grads = _build(specs, {"half_w": "bfloat16"})
    # one bf16 parameter: a master in both, fused only in the port
    specs.append(dict(name="half_w", shape=(16, 4)))
    extra = _build([specs[-1]], {"half_w": "bfloat16"}, seed=1)
    jps += extra[0]
    tps += extra[1]
    names += extra[2]
    grads = [g + eg for g, eg in zip(grads, extra[3])]
    half = len(jps) // 2
    jlist = jps + [jps[0]]
    jopt = JAdamW(parameters=[{"params": jlist[:half]},
                              {"params": jlist[half:]}],
                  weight_decay=0.01, apply_decay_param_fun=_decay,
                  grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                  multi_precision=True, **KW)
    jopt.fuse_step = True
    pairs = _port_params(tps, names)
    tpo = topt.AdamW(parameters=[{"params": pairs[:half]},
                                 {"params": pairs[half:]}],
                     weight_decay=0.01, apply_decay_param_fun=_decay,
                     grad_clip=ClipGradByGlobalNorm(1.0),
                     multi_precision=True, **KW)
    ref_plans = []
    real_run, real_step = jfused.FusedStepEngine._run_group, \
        jfused.FusedStepEngine.step

    def run_group(self, key, pg, lr):
        ref_plans[-1]["groups"][key] = sorted(p.name for p, _ in pg)
        return real_run(self, key, pg, lr)

    def step(self, params_grads, lr):
        ref_plans.append({"groups": {}})
        left = real_step(self, params_grads, lr)
        ref_plans[-1]["leftover"] = [p.name for p, _ in left]
        return left

    tele = jfused.opt_telemetry()["dispatches"]
    out = {"ref": ref_plans, "port": [], "names": names, "jps": jps,
           "tps": tps, "tpo": tpo, "jopt": jopt, "ref_dispatch": []}
    jfused.FusedStepEngine._run_group = run_group
    jfused.FusedStepEngine.step = step
    try:
        for step_grads in grads:
            _set_grads(jps, tps, step_grads)
            e0, f0 = tele.value(mode="eager"), tele.value(mode="fused")
            jopt.step()
            out["ref_dispatch"].append(
                {"eager": tele.value(mode="eager") - e0,
                 "fused": tele.value(mode="fused") - f0})
            pg = [(p, p.grad) for p in tpo._parameter_list]
            groups, left = tpo._fused_engine.plan(pg)
            before = dict(tpo._fused_engine.dispatches)
            tpo.step()
            out["port"].append(dict(
                groups={k: sorted(tpo._names[p] for p, _ in v)
                        for k, v in groups.items()},
                leftover=[tpo._names[p] for p, _ in left],
                dispatch={k: tpo._fused_engine.dispatches[k] - before[k]
                          for k in before}))
            jopt.clear_grad()
            tpo.clear_grad()
    finally:
        jfused.FusedStepEngine._run_group = real_run
        jfused.FusedStepEngine.step = real_step
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_groups_and_leftovers_match_the_reference(against_reference, step):
    ref = against_reference["ref"][step]
    port = against_reference["port"][step]
    # the port's keys extend the reference's (lr_mult, wd) by dtype,
    # device, master and step; the master group is the stated difference
    merged = {}
    for (lr_mult, wd, dtype, _, master, t), names in port["groups"].items():
        # w0 takes two updates a step (its second occurrence eager), so
        # its bias corrections run ahead and it is grouped apart
        assert t == (2 * step + 1 if names == ["w0"] else step + 1), names
        if master:
            assert dtype == torch.bfloat16 and names == ["half_w"]
            continue
        merged.setdefault((lr_mult, wd), []).extend(names)
    assert {k: sorted(v) for k, v in merged.items()} == ref["groups"]
    assert ref["leftover"] == ["l1_w", "half_w", "w0"]
    assert port["leftover"] == ["l1_w", "w0"]
    assert set(ref["groups"]) == {(1.0, 0.01), (1.0, 0.0), (2.0, 0.01),
                                  (1.0, 0.05)}


@pytest.mark.parametrize("step", range(STEPS))
def test_dispatch_counts_follow_the_reference(against_reference, step):
    ref = against_reference["ref_dispatch"][step]
    port = against_reference["port"][step]
    # one a parameter eager, one a group launch fused; half_w moves from
    # the reference's eager loop to a fused group of its own, and from the
    # second step on w0's step count sets it apart too
    assert ref == {"eager": 3, "fused": 4}
    assert port["dispatch"] == {"eager": ref["eager"] - 1,
                                "fused": len(port["groups"])}
    assert len(port["groups"]) == ref["fused"] + 1 + (step > 0)


def test_fused_step_matches_the_reference_engine(against_reference):
    """After 3 steps every fp32 tensor is within 1e-5 of the reference's
    fused engine and the bf16 one (master, moments) of its eager loop."""
    r = against_reference
    for name, jp, tp in zip(r["names"], r["jps"], r["tps"]):
        jslots = r["jopt"]._slots[id(jp)]
        tslots = r["tpo"].state[tp]
        assert tslots["step"] == r["jopt"]._step_t[id(jp)]
        for slot in ("moment1", "moment2") + (
                ("master",) if "master" in tslots else ()):
            _close(tslots[slot].numpy(), _np(jslots[slot]), (name, slot))
        want = _np(jp)
        got = tp.detach().float().numpy()
        if tp.dtype == torch.bfloat16:
            assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want)), \
                name
        else:
            _close(got, want, name)


# ---------------------------------------------------------------------------
# plain K-A against the port's eager loop, bit for bit, and against JAX
# ---------------------------------------------------------------------------

def _uniform_set(dtype, seed=3):
    specs = [dict(name=f"w{i}", shape=s) for i, s in enumerate(SHAPES)]
    specs += [dict(name="norm_a", shape=(17,)),
              dict(name="norm_b", shape=(9,)),
              dict(name="noclip_w", shape=(12,), need_clip=False)]
    return _build(specs, {s["name"]: dtype for s in specs}, seed)


def _port_pair(cls, tps, names, clip, fused, **kw):
    """Two copies of the port's parameters and one optimizer over them."""
    copies = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    for c, p in zip(copies, tps):
        c.need_clip = getattr(p, "need_clip", True)
    opt = cls(parameters=list(zip(names, copies)),
              grad_clip=ClipGradByGlobalNorm(1.0) if clip else None,
              multi_precision=True, **kw, **KW)
    opt.fuse_step = fused
    return copies, opt


def _run_port(opt, params, grads):
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
        opt.clear_grad()


def _tensors(opt, params):
    out = []
    for p in params:
        out.append(p.detach())
        slots = opt.state[p]
        out += [slots[k] for k in ("master", "moment1", "moment2")
                if k in slots]
    return out


CASES = [(kind, clip, dtype) for kind in ("adam", "adamw")
         for clip in (False, True) for dtype in ("float32", "bfloat16")]


def _kind(kind):
    if kind == "adamw":
        return topt.AdamW, dict(weight_decay=0.05,
                                apply_decay_param_fun=_decay), JAdamW
    return topt.Adam, dict(weight_decay=0.05), JAdam


def _fused_vs_eager(kind, clip, dtype):
    _, tps, names, grads = _uniform_set(dtype)
    cls, kw, _ = _kind(kind)
    runs = []
    for fused in (True, False):
        params, opt = _port_pair(cls, tps, names, clip, fused, **kw)
        _run_port(opt, params, grads)
        runs.append((opt, params))
    return runs


@pytest.mark.parametrize("kind,clip,dtype", CASES)
def test_plain_kernel_matches_the_eager_loop_bit_for_bit(kind, clip, dtype):
    (fopt, fparams), (eopt, eparams) = _fused_vs_eager(kind, clip, dtype)
    assert fopt._fused_engine.dispatches == {"eager": 0, "fused": STEPS * (
        2 if kind == "adamw" else 1)}
    assert eopt._fused_engine.dispatches == {"eager": STEPS * len(fparams),
                                             "fused": 0}
    for a, b in zip(_tensors(fopt, fparams), _tensors(eopt, eparams)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind,clip,dtype", CASES)
def test_fused_step_matches_jax_over_three_steps(kind, clip, dtype):
    """fp32 groups against the reference's fused engine, bf16 with
    masters against its eager masterized loop, 1e-5 of each tensor's
    max."""
    jps, tps, names, grads = _uniform_set(dtype)
    cls, kw, jcls = _kind(kind)
    params, opt = _port_pair(cls, tps, names, clip, None, **kw)
    jopt = jcls(parameters=jps, multi_precision=True,
                grad_clip=jclip.ClipGradByGlobalNorm(1.0) if clip else None,
                **kw, **KW)
    jopt.fuse_step = dtype == "float32"
    for step_grads in grads:
        _set_grads(jps, params, step_grads)
        jopt.step()
        opt.step()
        jopt.clear_grad()
        opt.clear_grad()
    assert opt._fused_engine.dispatches["eager"] == 0
    for name, jp, tp in zip(names, jps, params):
        jslots, tslots = jopt._slots[id(jp)], opt.state[tp]
        for slot in ("moment1", "moment2") + (
                ("master",) if dtype == "bfloat16" else ()):
            _close(tslots[slot].numpy(), _np(jslots[slot]), (name, slot))
        if dtype == "float32":
            _close(tp.detach().numpy(), _np(jp), name)


def test_group_table_is_rebuilt_after_set_state_dict():
    _, tps, names, grads = _uniform_set("bfloat16")
    params, opt = _port_pair(topt.AdamW, tps, names, True, True,
                             weight_decay=0.05, apply_decay_param_fun=_decay)
    eparams, eopt = _port_pair(topt.AdamW, tps, names, True, False,
                               weight_decay=0.05,
                               apply_decay_param_fun=_decay)
    _run_port(opt, params, grads[:1])
    _run_port(eopt, eparams, grads[:1])
    engine = opt._fused_engine
    assert engine.table_builds == 2            # decayed, and the norms
    _run_port(opt, params, grads[1:2])
    assert engine.table_builds == 2            # the tables are kept
    opt.set_state_dict(opt.state_dict())       # replaces every slot
    _run_port(opt, params, grads[2:])
    assert engine.table_builds == 4
    eopt.set_state_dict(eopt.state_dict())
    _run_port(eopt, eparams, grads[1:])
    for a, b in zip(_tensors(opt, params), _tensors(eopt, eparams)):
        assert torch.equal(a, b)


def test_other_clips_run_before_the_fused_step():
    _, tps, names, grads = _uniform_set("float32")
    runs = []
    for fused in (True, False):
        params, opt = _port_pair(topt.AdamW, tps, names, False, fused,
                                 weight_decay=0.05)
        opt._grad_clip = ClipGradByValue(0.2)
        _run_port(opt, params, grads)
        runs.append(_tensors(opt, params))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the chunk table and K-B's two-phase sum
# ---------------------------------------------------------------------------

NUMELS = [0, 1, 7, 8, 9, ost.CHUNK - 1, ost.CHUNK, ost.CHUNK + 3, 0,
          3 * ost.CHUNK + 5, 16]


def _chunk_ranges(numels):
    """Each chunk's (tensor, lo, hi), found as the kernels find it: the
    largest i with cs[i] <= c."""
    cs = ost.chunk_table(numels)
    out = []
    for c in range(cs[-1]):
        i = bisect.bisect_right(cs, c) - 1
        lo = (c - cs[i]) * ost.CHUNK
        out.append((i, lo, min(lo + ost.CHUNK, numels[i])))
    return out


def test_chunk_table_covers_every_element_once():
    cover = [np.zeros(n, np.int64) for n in NUMELS]
    for i, lo, hi in _chunk_ranges(NUMELS):
        assert lo < hi and lo % ost.VEC == 0
        cover[i][lo:hi] += 1
        # a thread's 8-element steps: only a tensor's last may be partial
        for base in range(lo, hi, ost.VEC):
            assert base + ost.VEC <= hi or hi == NUMELS[i]
    assert all(np.all(c == 1) for c in cover)
    assert ost.chunk_table(NUMELS)[-1] == sum(-(-n // ost.CHUNK)
                                              for n in NUMELS)


def test_kernel_operands_must_be_contiguous_and_aligned():
    t = torch.zeros(64)
    ost._kernel_operands("t", [t], t.device)
    for bad in (t[1:], t.view(8, 8).t()):
        with pytest.raises(ValueError, match="aligned"):
            ost._kernel_operands("t", [bad], t.device)
    with pytest.raises(ValueError, match="master"):
        p = torch.zeros(8, dtype=torch.bfloat16)
        ost.AdamGroup([p], [None], [torch.zeros(8)], [torch.zeros(8)], [1])


def _grads_for_sumsq(seed=5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n).astype(np.float32)).to(dt)
            for n, dt in zip(NUMELS, [torch.float32, torch.bfloat16,
                                      torch.float16] * 4)]


def _kb_two_phase(grads, drop=None):
    """K-B's procedure on the CPU: one fp32 partial a chunk (chunk
    ``drop`` left out), then by tensor, the tensors in order."""
    numels = [g.numel() for g in grads]
    cs = ost.chunk_table(numels)
    partial = torch.zeros(cs[-1])
    for c, (i, lo, hi) in enumerate(_chunk_ranges(numels)):
        if c != drop:
            x = grads[i].reshape(-1)[lo:hi].float()
            partial[c] = (x * x).sum()
    total = torch.zeros(())
    for i in range(len(grads)):
        total = total + partial[cs[i]:cs[i + 1]].sum()
    return float(total)


def _fp64_sumsq(grads):
    return sum(float((g.double() ** 2).sum()) for g in grads)


def test_sum_of_squares_two_phase_within_1e_6_of_fp64():
    grads = _grads_for_sumsq()
    want = _fp64_sumsq(grads)
    for got in (_kb_two_phase(grads),
                float(ost.sum_squares_multi_tensor(grads))):
        assert abs(got - want) <= SUMSQ_TOL * want


def test_sum_of_squares_plain_matches_jax_global_norm():
    grads = _grads_for_sumsq()
    pairs = [(JParameter(jnp.zeros(g.shape)),
              Tensor(jnp.asarray(g.float().numpy(), jnp.float32)))
             for g in grads if g.dtype == torch.float32]
    want = float(jclip.ClipGradByGlobalNorm(1.0)._global_norm_sq(pairs))
    got = float(ost.sum_squares_multi_tensor(
        [g for g in grads if g.dtype == torch.float32]))
    assert abs(got - want) <= SUMSQ_TOL * want


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def _decay_after_update(w, g, m, v, hp):
    lr, wd = hp.lr, hp.weight_decay
    m.mul_(hp.beta1).add_((1 - hp.beta1) * g)
    v.mul_(hp.beta2).add_((1 - hp.beta2) * g * g)
    mhat = m / (1 - hp.beta1 ** hp.step)
    vhat = v / (1 - hp.beta2 ** hp.step)
    w.sub_(mhat.mul_(lr).div_(vhat.sqrt_().add_(hp.eps)))
    if wd and hp.decoupled:
        w.mul_(1 - lr * wd)


def _bias_correction_one_behind(w, g, m, v, hp):
    real_update(w, g, m, v, ost.AdamHyper(
        hp.lr, hp.beta1, hp.beta2, hp.eps, hp.weight_decay,
        hp.step - 1 if hp.step > 1 else hp.step, hp.decoupled))


real_update = ost.adam_update_plain

FAULTS = {
    "decay_after_the_update": ("adam_update_plain", _decay_after_update),
    "bias_correction_at_t_minus_1": ("adam_update_plain",
                                     _bias_correction_one_behind),
    "clip_rounding_to_grad_dtype_skipped": (
        "clip_scaled", lambda g, scale: g.float() * scale),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_kernel_faults_break_bit_parity(monkeypatch, fault):
    attr, fn = FAULTS[fault]
    monkeypatch.setattr(ost, attr, fn)
    (fopt, fparams), (eopt, eparams) = _fused_vs_eager("adamw", True,
                                                       "bfloat16")
    assert not all(torch.equal(a, b) for a, b in zip(
        _tensors(fopt, fparams), _tensors(eopt, eparams))), fault


def test_planted_fault_chunk_dropped_from_sum_of_squares():
    grads = _grads_for_sumsq()
    want = _fp64_sumsq(grads)
    for drop in (0, ost.chunk_table([g.numel() for g in grads])[-1] - 1):
        assert abs(_kb_two_phase(grads, drop) - want) > SUMSQ_TOL * want
