"""``paddle_tpu_torch.amp`` against ``paddle_tpu.amp`` on the CPU: the
dtype every op of the Llama forward and loss casts to, losses and
gradients under each AMP mode, a bf16 model without AMP (ROADMAP C24),
``GradScaler``'s scale / skip / update sequence, ``decorate``, recompute
under O2, and the pool dtype of a bf16 model's cache (C25).

The models are two-layer ``llama_tiny`` (head_dim 16) at 16 tokens, so
both packages take the dense ``"sdpa"`` route (the reference's flash
route needs a TPU backend; ``tests/test_torch_sdpa_routes.py`` holds the
port's flash route against the reference's kernel)."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.autograd import tape as jtape
from paddle_tpu.framework.core import Parameter as JParameter, Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models.generation import PagedKVCache as JPagedKVCache

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.models import llama as llama_mod
from paddle_tpu_torch.models.generation import PagedKVCache
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH, SEQ, LAYERS = 2, 16, 2

#: name -> (cast the model to, decorate O2 to, auto_cast arguments)
MODES = {
    "fp32": (None, None, None),
    "bf16-no-amp": ("bfloat16", None, None),
    "O1-fp16": (None, None, dict(level="O1", dtype="float16")),
    "O1-bf16": (None, None, dict(level="O1", dtype="bfloat16")),
    "O2-fp16": (None, "float16", dict(level="O2", dtype="float16")),
    "O2-bf16": (None, "bfloat16", dict(level="O2", dtype="bfloat16")),
    "O1-custom-lists": (None, None, dict(
        level="O1", dtype="float16",
        custom_white_list=["rms_norm", "fused_swiglu"],
        custom_black_list=["sdpa"])),
    # linear black under O2: every reshape of a projection is cast
    "O2-custom-lists": (None, "bfloat16", dict(
        level="O2", dtype="bfloat16", custom_black_list=["linear"])),
}


def _inputs():
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 128, (BATCH, SEQ + 1))
    return tokens[:, :-1], tokens[:, 1:]


def _models():
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=LAYERS,
                        max_position_embeddings=64))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=LAYERS,
                                           max_position_embeddings=64),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


def _name(dtype):
    """A dtype's name; integers as ``"int"`` (labels are int32 in the
    reference and int64 in the port)."""
    s = str(dtype).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


def _jax_run(jm, mode, monkeypatch):
    """Forward, loss and backward of the reference in ``mode``: the
    loss, logits, grads by name (fp32 numpy) and the trace, every
    ``tape._amp_cast_inputs`` call but the policy's own ``"cast"`` ops
    (each recasts one input of the op recorded after it)."""
    cast, deco, kw = MODES[mode]
    if cast:
        jm.to(dtype=cast)
    if deco:
        jamp.decorate(jm, level="O2", dtype=deco)
    trace, inner = [], jtape._amp_cast_inputs

    def record(name, leaves):
        out = inner(name, leaves)
        if name != "cast":
            trace.append((name, tuple(_name(a.dtype) for a in leaves
                                      if isinstance(a, Tensor)),
                          tuple(_name(a.dtype) for a in out
                                if isinstance(a, Tensor))))
        return out

    monkeypatch.setattr(jtape, "_amp_cast_inputs", record)
    ids, labels = _inputs()
    with jamp.auto_cast(**kw) if kw else contextlib.nullcontext():
        loss, logits = jm(Tensor(jnp.asarray(ids)),
                          labels=Tensor(jnp.asarray(labels)))
    monkeypatch.setattr(jtape, "_amp_cast_inputs", inner)
    loss.backward()
    grads = {n: np.asarray(p.grad._data, np.float32)
             for n, p in jm.named_parameters()}
    return (float(np.asarray(loss._data)), np.asarray(logits._data),
            grads, trace)


def _torch_run(tm, mode):
    cast, deco, kw = MODES[mode]
    if cast:
        tm.to(getattr(torch, cast))
    if deco:
        amp.decorate(tm, level="O2", dtype=deco)
    ids, labels = _inputs()
    with debugging.collect_operator_stats() as stats:
        with amp.auto_cast(**kw) if kw else contextlib.nullcontext():
            loss, logits = tm(ids, labels=labels)
    loss.backward()
    grads = pt.jax_layout(tm, {n: p.grad.float()
                               for n, p in tm.named_parameters()})
    trace = [(op, tuple(_name(d) for d in ins), tuple(_name(d) for d in cs))
             for op, ins, cs in stats.records]
    return float(loss.detach()), logits, grads, trace


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dtype_trace_equals_the_reference(mode, monkeypatch):
    """Op by op, the same names, input dtypes and cast dtypes: the
    port's ``amp_cast_inputs`` sites are the reference's tape ops (no
    op name is skipped, ``reshape`` included)."""
    jm, tm = _models()
    *_, jtrace = _jax_run(jm, mode, monkeypatch)
    *_, ttrace = _torch_run(tm, mode)
    # embedding, 18 ops a layer, the final norm, lm_head and the loss
    assert len(jtrace) == 18 * LAYERS + 4
    assert ttrace == jtrace


#: loss (relative) and grads (relative to each grad's max abs). fp32
#: agrees to the sums' order (1e-5, as tests/test_torch_llama.py). In the
#: 16-bit modes both packages round the same ops to the same dtypes, but
#: where two fp32 sums differ in order a 16-bit output may land one ulp
#: apart, and the backward carries such ulps on: the grads are held to
#: four units of the dtype's roundoff (2^-8 bf16, 2^-11 fp16; measured
#: 3.4 bf16 and 2.9 fp16 units at most), the loss to one (measured
#: under 3e-7)
LOSS_TOL = {"fp32": 1e-5, "float16": 2.0 ** -11, "bfloat16": 2.0 ** -8}
GRAD_TOL = {"fp32": 1e-5, "float16": 4 * 2.0 ** -11,
            "bfloat16": 4 * 2.0 ** -8}


def _amp_dtype(mode):
    cast, deco, kw = MODES[mode]
    return cast or (kw or {}).get("dtype", "fp32")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_loss_and_every_grad_match_the_reference(mode, monkeypatch):
    jm, tm = _models()
    jloss, jlogits, jgrads, _ = _jax_run(jm, mode, monkeypatch)
    tloss, tlogits, tgrads, _ = _torch_run(tm, mode)
    dt = _amp_dtype(mode)
    assert _name(tlogits.dtype) == _name(jlogits.dtype)
    assert abs(tloss - jloss) <= LOSS_TOL[dt] * abs(jloss), (tloss, jloss)
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        assert tgrads[n].dtype == np.float32
        err = float(np.abs(tgrads[n] - jgrads[n]).max())
        scale = float(np.abs(jgrads[n]).max())
        assert err <= GRAD_TOL[dt] * scale, (n, err, scale)
    # the parameters' dtypes after the mode's cast or decorate
    jdt = {n: _name(p.dtype) for n, p in jm.named_parameters()}
    assert {n: _name(p.dtype) for n, p in tm.named_parameters()} == jdt


def test_bf16_model_without_amp_promotes_like_the_reference(monkeypatch):
    """C24: the rope's fp32 tables make q and k fp32, and from layer 0's
    attention on a bf16 model computes in fp32 on bf16 weights: fp32
    logits, within one bf16 roundoff (2^-8) of the logits' max, what a
    one-ulp difference in layer 0's bf16 projections (the only bf16
    outputs) could move (measured 2.6e-7)."""
    jm, tm = _models()
    _, jlogits, _, _ = _jax_run(jm, "bf16-no-amp", monkeypatch)
    _, tlogits, _, _ = _torch_run(tm, "bf16-no-amp")
    assert tlogits.dtype == torch.float32 and jlogits.dtype == jnp.float32
    assert tm.llama.rope_cos.dtype == torch.float32
    err = np.abs(tlogits.detach().numpy() - np.asarray(jlogits)).max()
    assert err <= 2.0 ** -8 * np.abs(np.asarray(jlogits)).max()


def test_rope_returns_fp32_for_16_bit_inputs():
    from paddle_tpu_torch.ops import fused
    cos, sin = fused.rope_freqs(16, 8)
    x = torch.randn(1, 8, 2, 16)
    for dt in (torch.bfloat16, torch.float16):
        q, k = fused.fused_rotary_position_embedding(x.to(dt), x.to(dt),
                                                     sin=sin, cos=cos)
        assert q.dtype == k.dtype == torch.float32
        want, _ = fused.fused_rotary_position_embedding(
            x.to(dt).float(), x, sin=sin, cos=cos)
        assert torch.equal(q, want)


# -- promotion ---------------------------------------------------------------

def test_promotion_is_jnp_s_not_torch_s_zero_dim_rule():
    f32, bf, f16 = torch.float32, torch.bfloat16, torch.float16
    assert amp.result_dtype(bf, f32) == f32
    assert amp.result_dtype(bf, f16) == f32
    assert amp.result_dtype(f16, f16) == f16
    for a, b in ((bf, f32), (bf, f16), (f16, f32)):
        want = jnp.promote_types(getattr(jnp, str(a)[6:]),
                                 getattr(jnp, str(b)[6:]))
        assert str(amp.result_dtype(a, b))[6:] == str(want)
    # a 0-dim fp32 tensor beside an n-dim bf16 one: torch keeps bf16,
    # jnp (and the helper) promote to fp32
    s, x = torch.tensor(2.0), torch.ones(3, dtype=bf)
    assert (s * x).dtype == bf
    assert torch.mul(*amp.promote(s, x)).dtype == f32
    assert amp.promote(torch.ones(2, dtype=torch.int64), x)[0].dtype == \
        torch.int64


# -- the policy ----------------------------------------------------------------

def test_policy_matches_the_reference_for_every_listed_op():
    names = sorted(amp.WHITE_LIST | amp.BLACK_LIST | {"add", "cast",
                                                      "fused_rope"})
    assert amp.WHITE_LIST == jamp.WHITE_LIST
    assert amp.BLACK_LIST == jamp.BLACK_LIST
    for level in ("O1", "O2"):
        for dt in ("float16", "bfloat16"):
            for name in names:
                x32 = torch.ones(2)
                xs = [x32, x32.to(getattr(torch, dt)), torch.ones(2,
                      dtype=torch.int32)]
                j = [Tensor(jnp.ones(2, jnp.float32)),
                     Tensor(jnp.ones(2, getattr(jnp, dt))),
                     Tensor(jnp.ones(2, jnp.int32))]
                with amp.auto_cast(level=level, dtype=dt):
                    got = [_name(t.dtype) for t in
                           amp.amp_cast_inputs(name, xs)]
                with jamp.auto_cast(level=level, dtype=dt):
                    want = [_name(t.dtype) for t in
                            jamp.amp_cast_inputs(name, j)]
                assert got == want, (level, dt, name)


def test_auto_cast_nests_and_restores():
    st = amp.amp_state()
    assert not st.enabled
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert (st.enabled, st.level, st.dtype) == (True, "O2",
                                                   torch.bfloat16)
        with amp.auto_cast(enable=False):
            assert not st.enabled
        with amp.auto_cast(custom_white_list=["exp"], level="O1"):
            assert "exp" in st.white and "exp" not in st.black
        assert (st.enabled, st.level, st.dtype) == (True, "O2",
                                                   torch.bfloat16)
        assert st.white == amp.WHITE_LIST
    with pytest.raises(ZeroDivisionError):
        with amp.amp_guard(level="O2"):
            raise ZeroDivisionError
    assert not st.enabled and st.level == "O1"
    assert st.black == amp.BLACK_LIST


def test_supported_dtypes_answer_for_the_device():
    assert amp.is_bfloat16_supported("cpu")
    assert not amp.is_float16_supported("cpu")
    if not torch.cuda.is_available():
        assert not amp.is_bfloat16_supported()
        assert not amp.is_float16_supported("gpu:0")


# -- decorate -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_casts_parameters_and_masters_follow_the_cast(dtype):
    jm, tm = _models()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = topt_mod.AdamW(learning_rate=1e-3,
                         parameters=tm.named_parameters())
    ids = {id(p) for p in tm.parameters()}
    m2, o2 = amp.decorate(tm, opt, level="O2", dtype=dtype)
    assert m2 is tm and o2 is opt and opt._multi_precision
    assert {id(p) for p in tm.parameters()} == ids
    jo = jopt_mod.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jamp.decorate(jm, jo, level="O2", dtype=dtype)
    want = pt.jax_layout(tm, {n: p.float() for n, p in
                              tm.named_parameters()})
    for n, p in jm.named_parameters():
        assert _name(p.dtype) == dtype
        np.testing.assert_array_equal(want[n], np.asarray(p._data,
                                                          np.float32))
    for n, p in tm.named_parameters():
        assert p.dtype == getattr(torch, dtype)
        master = opt._get_slots(p)["master"]
        assert torch.equal(master, p.detach().float())
        if before[n].abs().max() > 0 and n.endswith("proj.weight"):
            assert not torch.equal(master, before[n])


def test_decorate_excluded_layers_and_o1():
    _, tm = _models()
    assert amp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    amp.decorate(tm, level="O2", dtype="bfloat16",
                 excluded_layers=[pt.nn.norm.RMSNorm])
    for n, p in tm.named_parameters():
        want = torch.float32 if "norm" in n else torch.bfloat16
        assert p.dtype == want, n


# -- recompute --------------------------------------------------------------------

def _o2_grads(recompute, monkeypatch=None):
    _, tm = _models()
    tm.config.use_recompute = recompute
    amp.decorate(tm, level="O2", dtype="bfloat16")
    ids, labels = _inputs()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss, _ = tm(ids, labels=labels)
    loss.backward()
    return {n: p.grad for n, p in tm.named_parameters()}


def test_recompute_under_o2_gives_the_same_grads():
    plain, again = _o2_grads(False), _o2_grads(True)
    for n in plain:
        assert again[n].dtype == torch.bfloat16
        assert torch.equal(plain[n], again[n]), n


def test_recompute_without_the_amp_state_would_cast_otherwise(monkeypatch):
    """The recompute runs in backward, outside ``auto_cast``: without the
    forward's AMP state restored, its casts differ and checkpoint's
    recomputed tensors do not match the saved ones."""
    monkeypatch.setattr(llama_mod, "_amp_contexts", lambda: (
        contextlib.nullcontext(), contextlib.nullcontext()))
    from torch.utils.checkpoint import CheckpointError
    with pytest.raises(CheckpointError, match="recomputed metadata"):
        _o2_grads(True)


# -- GradScaler ----------------------------------------------------------------

SHAPES = [(9, 7), (13,), (4, 3, 5), (6,)]
STEPS = 20
#: steps whose grads are planted with inf or nan
PLANTED = {3: np.inf, 4: np.nan, 9: -np.inf, 10: np.nan, 11: np.inf,
           16: np.nan}


def _scaler_kw():
    return dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
                decr_every_n_nan_or_inf=2)


def _state(to, tps):
    return [(p.detach().clone(), {k: v.clone() if torch.is_tensor(v) else v
                                  for k, v in to.state[p].items()})
            for p in tps if to.state.get(p)]


def _scaler_run(dtype, fuse_step, reload_at=None):
    """STEPS AdamW steps through both scalers on the same grads (the
    scaled grads ``g * scale`` rounded to the parameter's dtype), some
    planted with inf or nan; returns per step (scale, found_inf) of both
    packages and the port's parameters and slots."""
    rng = np.random.RandomState(3)
    init = [(rng.randn(*s) * 0.3).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(a, getattr(jnp, dtype))) for a in init]
    tps = [torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
           for a in init]
    mp = dtype != "float32"
    jo = jopt_mod.AdamW(learning_rate=0.01, parameters=jps,
                        multi_precision=mp)
    jo.fuse_step = False
    to = topt_mod.AdamW(learning_rate=0.01, parameters=tps,
                        multi_precision=mp)
    to.fuse_step = fuse_step
    js, ts = jamp.GradScaler(**_scaler_kw()), amp.GradScaler(**_scaler_kw())
    out = []
    for step in range(STEPS):
        if reload_at == step:
            state = ts.state_dict()
            ts = amp.GradScaler(**_scaler_kw())
            ts.load_state_dict(state)
            jstate = js.state_dict()
            js = jamp.GradScaler(**_scaler_kw())
            js.load_state_dict(jstate)
        assert ts.get_scale_ratio() == js.get_scale_ratio()
        grads = [(rng.randn(*s) * 0.5).astype(np.float32) for s in SHAPES]
        if step in PLANTED:
            g = grads[step % len(SHAPES)]
            g.flat[step % g.size] = PLANTED[step]
        before = _state(to, tps)
        for jp, tp, g in zip(jps, tps, grads):
            jg = (jnp.asarray(g) * js.get_scale_ratio()).astype(
                jp._data.dtype)
            jp.grad = Tensor(jg)
            tp.grad = (torch.from_numpy(g) * ts.get_scale_ratio()).to(
                tp.dtype)
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        assert ts._found_inf == js._found_inf == (step in PLANTED), step
        if step in PLANTED:
            after = _state(to, tps)
            assert len(after) == len(before)
            for (p0, s0), (p1, s1) in zip(before, after):
                assert torch.equal(p0, p1)
                assert s0.keys() == s1.keys()
                for k in s0:
                    same = (torch.equal(s0[k], s1[k]) if torch.is_tensor(
                        s0[k]) else s0[k] == s1[k])
                    assert same, (step, k)
        out.append((ts.get_scale_ratio(), js.get_scale_ratio(),
                    ts.state_dict(), js.state_dict()))
    return out, jo, to, jps, tps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("fuse_step", [True, False])
def test_grad_scaler_follows_the_reference(dtype, fuse_step):
    out, jo, to, jps, tps = _scaler_run(dtype, fuse_step)
    scales = [o[0] for o in out]
    assert scales == [o[1] for o in out]
    assert [o[2] for o in out] == [o[3] for o in out]
    # the trajectory moves both ways
    steps = list(zip(scales, scales[1:]))
    assert any(b > a for a, b in steps) and any(b < a for a, b in steps)
    for jp, tp in zip(jps, tps):
        n_steps = STEPS - len(PLANTED)
        assert to.state[tp]["step"] == jo._step_t[id(jp)] == n_steps
        got, want = tp.detach().float().numpy(), np.asarray(jp._data,
                                                            np.float32)
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        else:
            assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want))
            master = to.state[tp]["master"].numpy()
            jmaster = np.asarray(jo._slots[id(jp)]["master"])
            assert np.abs(master - jmaster).max() <= \
                1e-6 * np.abs(jmaster).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_scaler_fused_equals_eager_bit_for_bit(dtype):
    """C22 under the scaler: the fused step (the plain version of K-A on
    the CPU) and the eager loop give the same bits, skipped steps
    included."""
    _, _, to_f, _, tps_f = _scaler_run(dtype, True)
    _, _, to_e, _, tps_e = _scaler_run(dtype, False)
    assert to_f._fused_engine.dispatches["fused"] > 0
    assert to_e._fused_engine.dispatches["fused"] == 0
    for pf, pe in zip(tps_f, tps_e):
        assert torch.equal(pf, pe)
        for k, v in to_f.state[pf].items():
            ve = to_e.state[pe][k]
            assert torch.equal(v, ve) if torch.is_tensor(v) else v == ve


@pytest.mark.parametrize("reload_at", [5, 10])
def test_grad_scaler_state_dict_round_trip(reload_at):
    plain, *_ = _scaler_run("float32", False)
    again, *_ = _scaler_run("float32", False, reload_at=reload_at)
    assert [o[:2] for o in plain] == [o[:2] for o in again]


def test_unscale_is_bit_equal_to_the_reference_formula():
    """PyTorch's multi-tensor unscale equals ``(g.float() * inv).to(
    g.dtype)`` bit for bit (NaN payloads included), checking the inputs
    for inf and nan, as the reference's ``_check_finite_and_unscale``."""
    rng = np.random.RandomState(7)
    inv = 1.0 / 2.0 ** 13
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for plant in (None, np.inf, np.nan):
            raw = [rng.randn(n).astype(np.float32) * 2.0 ** rng.randint(
                -10, 14) for n in (1, 7, 4099, 70000)]
            if plant is not None:
                raw[2][17] = plant
            grads = [torch.tensor(a).to(dtype) for a in raw]
            want = [(g.float() * inv).to(dtype) for g in grads]
            found = amp.check_finite_and_unscale(grads, inv)
            assert bool(found) == (plant is not None)
            for g, w in zip(grads, want):
                bits = torch.int32 if dtype == torch.float32 else torch.int16
                assert torch.equal(g.view(bits), w.view(bits))
            jouts, jfound = jamp._check_finite_and_unscale(
                [jnp.asarray(a, getattr(jnp, str(dtype)[6:])) for a in raw],
                jnp.asarray(inv, jnp.float32))
            assert bool(jfound) == bool(found)
            for g, j in zip(grads, jouts):
                np.testing.assert_array_equal(g.float().numpy(),
                                              np.asarray(j, np.float32))


def test_grad_scaler_minimize_disable_and_static_scale():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt_mod.SGD(learning_rate=0.5, parameters=[p])
    s = amp.GradScaler(init_loss_scaling=8.0)
    loss = (p * torch.tensor([1.0, 2.0, 3.0])).sum()
    scaled = s.scale(loss)
    assert float(scaled.detach()) == 8.0 * float(loss.detach())
    s.minimize(opt, scaled)
    assert torch.equal(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert p.grad is None and s.get_scale_ratio() == 8.0
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    fixed = amp.GradScaler(init_loss_scaling=4.0,
                           use_dynamic_loss_scaling=False)
    p.grad = torch.tensor([float("inf"), 0.0, 0.0])
    fixed.step(opt)
    assert fixed.get_scale_ratio() == 4.0
    assert not fixed.is_use_dynamic_loss_scaling()
    assert torch.equal(p.detach(), torch.tensor([0.5, 0.0, -0.5]))
    # a parameter listed twice is unscaled once
    q = torch.nn.Parameter(torch.ones(2))
    twice = topt_mod.SGD(learning_rate=1.0, parameters=[q, q])
    q.grad = torch.full((2,), 8.0)
    amp.GradScaler(init_loss_scaling=8.0).unscale_(twice)
    assert torch.equal(q.grad, torch.ones(2))


# -- debugging -----------------------------------------------------------------

def test_debugging_checker_and_numerics():
    with pytest.raises(FloatingPointError, match="op=matmul var=w"):
        debugging.check_numerics(torch.tensor([1.0, float("nan")]),
                                 op_type="matmul", var_name="w")
    ok = torch.ones(3)
    assert debugging.check_numerics(ok) is ok
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
    try:
        torch.ones(2) + 1
        with pytest.raises(FloatingPointError, match="op=log"):
            torch.log(-torch.ones(2))
    finally:
        debugging.disable_tensor_checker()
    torch.log(-torch.ones(2))              # off again
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
        enable=False))
    torch.log(-torch.ones(2))              # a disabled config checks nothing
    debugging.disable_tensor_checker()
    assert debugging.DebugMode.CHECK_ALL.value == 2
    with pytest.raises(NotImplementedError):
        debugging.compare_accuracy("a", "b", "c")


def test_collect_operator_stats_counts_by_cast_dtype():
    _, tm = _models()
    ids, _ = _inputs()
    with debugging.collect_operator_stats() as stats:
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            tm(ids)
    counts = stats.counts()
    assert counts["linear"] == {"bfloat16": 7 * LAYERS + 1}
    assert counts["rms_norm"] == {"float32": 2 * LAYERS + 1}
    # gray: its bf16 inputs (the Linears') stay, it returns fp32
    assert counts["fused_rope"] == {"bfloat16": LAYERS}
    assert not amp._recorders


# -- C25 -------------------------------------------------------------------------

def test_c25_cached_pools_follow_k_dtype():
    """C25: a bf16 model's cache pools take k's dtype, fp32 after the
    rope, in both packages, so the cached forward computes in fp32 and
    its logits are fp32, within the cache-free path's C24 bound (one
    bf16 roundoff of the logits' max) of the reference's."""
    jm, tm = _models()
    jm.to(dtype="bfloat16")
    tm.to(torch.bfloat16)
    ids, _ = _inputs()
    jc = JPagedKVCache(page_size=16, max_len=64)
    tc = PagedKVCache(page_size=16, max_len=64)
    from paddle_tpu.autograd.tape import no_grad
    with no_grad():
        jlogits = jm(Tensor(jnp.asarray(ids)), cache=jc)
    with torch.no_grad():
        tlogits = tm(ids, cache=tc)
    jpools = [a for kv in jc._pools.values() for a in kv]
    tpools = [a for kv in tc._pools.values() for a in kv]
    assert len(jpools) == len(tpools) == 2 * LAYERS
    assert {str(a.dtype) for a in jpools} == {"float32"}
    assert {a.dtype for a in tpools} == {torch.float32}
    assert str(jlogits._data.dtype) == "float32"
    assert tlogits.dtype == torch.float32
    want = np.asarray(jlogits._data)
    err = np.abs(tlogits.numpy() - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max()
