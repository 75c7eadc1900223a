"""The tensor-core variants of the port's flash attention backward (B2 dQ,
B3 dK/dV).

What the CUDA kernels cannot show on a CPU, tested here at small sizes:
which variant a call takes (``bwd_variant``) and the checks
``chip_smoke.py`` holds them to on the card. The kernels round p to q's
dtype before ``P^T dO`` and ds before ``dS K`` and ``dS^T Q``, while the
reference dots in fp32 (ROADMAP C17). ``chip_smoke.bwd_rounding_model``
models those rounding points in plain torch: in fp32 it is the plain
backward bit for bit, and in bf16 and fp16 it passes the worst-case bound
(``wgmma_grad_error``) against the fp32 plain version. A CPU imitation of
the kernels' arithmetic (another summation order, ``exp2``, 64-row tiles,
the GQA sum head by head) passes the tight check against the model
(``grad_model_error``), and the same imitation with a fault planted fails
it: the check used on the card is itself tested. The fp32 plain backward
is held against the JAX package's interpret-mode Pallas backward.
"""
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 192, "simt"), (torch.float16, 256, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 192, "simt")])
def test_bwd_variant(dtype, head_dim, want):
    assert tfa.bwd_variant(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim,exc", [
    (torch.float64, 128, TypeError), (torch.int8, 64, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 32, ValueError)])
def test_bwd_variant_raises(dtype, head_dim, exc):
    with pytest.raises(exc):
        tfa.bwd_variant(dtype, head_dim)


@pytest.mark.parametrize("dtype,wgmma", [(torch.bfloat16, True),
                                         (torch.float16, True),
                                         (torch.float32, False)])
def test_bwd_operands_take_the_variant_and_tma_views(dtype, wgmma):
    """What a CUDA call hands its kernel (checked here on CPU tensors, which
    the wrapper itself never launches): the variant of ``bwd_variant``;
    for the tensor-core kernels q, k, v and dO as SDPA and autograd pass
    them, ``[b, s, h, d]`` views of a fused projection, in place (TMA
    reads them), and a misaligned dO copied; lse and delta contiguous."""
    b, s, hq, hk, d = 2, 40, 4, 2, 128
    fused = torch.randn(b, s, (hq + 2 * hk) * d).to(dtype).view(
        b, s, hq + 2 * hk, d)
    q, k, v = fused[:, :, :hq], fused[:, :, hq:hq + hk], fused[:, :, hq + hk:]
    dout = torch.randn(b * s * hq * d + 1).to(dtype)[1:].view(b, s, hq, d)
    lse = torch.randn(b, s, hq).transpose(1, 2)
    delta = torch.randn(b, hq, s)
    got = tfa._bwd_operands(q, k, v, dout, lse, delta, seq_dim=1)
    assert got[-1] is wgmma
    if wgmma:
        assert all(x is y for x, y in zip(got[:3], (q, k, v)))
        assert got[3] is not dout and got[3].data_ptr() % 16 == 0
    assert torch.equal(got[3], dout)
    assert got[4].is_contiguous() and torch.equal(got[4], lse)
    assert got[6] == (b, hq, hk, s, s, d)


# (b, hq, hk, sq, sk, d, causal, q_offset, kv_offset): Llama-3-8B's head
# widths and GQA cut to 300 tokens, and the dead-row case (rows 0..39 see
# no key)
CASES = {
    "llama_gqa_causal_300": (1, 32, 8, 300, 300, 128, True, 0, 0),
    "dead_rows": (1, 32, 8, 64, 100, 128, True, 0, 40),
}
DTYPES = [torch.bfloat16, torch.float16]
LOG2E = 1.4426950408889634
TILE = 64
FAULTS = ("stale_do", "no_delta", "skip_last_q_tile", "first_head_only",
          "mask_off_by_one", "scale_after_rounding")
#: the gradient each fault reaches first
FAULT_GRAD = {"stale_do": "dv", "no_delta": "dq", "skip_last_q_tile": "dk",
              "first_head_only": "dv", "mask_off_by_one": "dq",
              "scale_after_rounding": "dq"}


def _inputs(case, dtype, seed, dout_scale=1.0):
    """q, k, v, dout (times ``dout_scale``) rounded to ``dtype``; lse from
    the fp32 plain forward on them and delta from its output rounded to
    ``dtype``, as the card has them from B1 in that dtype."""
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    rng = np.random.RandomState(seed)
    q, k, v, dout = (
        torch.from_numpy(rng.randn(*shape).astype(np.float32) * sc).to(dtype)
        for shape, sc in (((b, hq, sq, d), 1.0), ((b, hk, sk, d), 1.0),
                          ((b, hk, sk, d), 1.0),
                          ((b, hq, sq, d), dout_scale)))
    out, lse = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal, None, qo, ko)
    delta = tfa.bwd_delta(out.to(dtype), dout)
    return q, k, v, dout, lse, delta


def _model(x, case, dtype):
    causal, qo, ko = case[6:]
    return smoke.bwd_rounding_model(torch, tfa, *(t.float() for t in x[:4]),
                                    *x[4:], causal, qo, ko, dtype)


def _plain(x, case):
    causal, qo, ko = case[6:]
    f32 = [t.float() for t in x[:4]]
    args = (*x[4:], causal, None, qo, ko)
    return {"dq": tfa.flash_bwd_dq_plain(*f32, *args),
            **dict(zip(("dk", "dv"), tfa.flash_bwd_dkv_plain(*f32, *args)))}


def _kernel_sim(x, case, dtype, fault=None):
    """B2 and B3's arithmetic as far as the CPU can imitate it: s and dp
    as fp64 dots rounded to fp32 (another order than the model's fp32
    matmuls), ``p = exp2(s scale log2e - lse log2e)``, ``ds = p (dp -
    delta) scale``, both rounded to ``dtype``; dq summed over key tiles
    of 64 in order, dk and dv over the group's heads and, for each, query
    tiles of 64 in order, each tile's product added to an fp32
    accumulator. A fault a kernel could have can be planted:
    ``stale_do``, dV of a head's second query tile reads the first tile's
    dO (a ring stage read before its refill); ``no_delta``, ds drops
    delta; ``skip_last_q_tile``, dK/dV's walk ends before each head's
    last query tile; ``first_head_only``, the GQA sum takes the group's
    first head only; ``mask_off_by_one``, each row also sees the key just
    after its causal limit; ``scale_after_rounding``, ds is rounded before
    the softmax scale is applied (the scale folded into the products).
    Returns ``{"dq", "dk", "dv"}`` in ``dtype``."""
    q, k, v, dout, lse, delta = x
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    g = hq // hk
    scale = d ** -0.5
    qd, dod = (t.double().view(b, hk, g, sq, d) for t in (q, dout))
    kd, vd = (t.double()[:, :, None] for t in (k, v))
    s = (qd @ kd.transpose(-1, -2)).float()
    dp = (dod @ vd.transpose(-1, -2)).float()
    valid = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        rows = qo + torch.arange(sq)[:, None]
        keys = ko + torch.arange(sk)[None, :]
        valid = rows + (fault == "mask_off_by_one") >= keys
    ls2 = (lse.float() * LOG2E).view(b, hk, g, sq, 1)
    c2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    p = torch.where(valid, torch.exp2(s * c2 - ls2), 0.0)
    dl = 0.0 if fault == "no_delta" else delta.view(b, hk, g, sq, 1)
    pr = p.to(dtype).double()
    if fault == "scale_after_rounding":
        dsr = (p * (dp - dl)).to(dtype).double() * scale
    else:
        dsr = (p * (dp - dl) * scale).to(dtype).double()
    dq = torch.zeros((b, hk, g, sq, d))
    for k0 in range(0, sk, TILE):
        dq = (dq.double() + dsr[..., k0:k0 + TILE] @ kd[..., k0:k0 + TILE, :]
              ).float()
    dk = torch.zeros((b, hk, sk, d))
    dv = torch.zeros((b, hk, sk, d))
    starts = list(range(0, sq, TILE))
    if fault == "skip_last_q_tile":
        starts = starts[:-1]
    for h in range(1 if fault == "first_head_only" else g):
        for t, r0 in enumerate(starts):
            r = slice(r0, r0 + TILE)
            stale = (slice(r0 - TILE, r0) if (fault, t) == ("stale_do", 1)
                     else r)
            dv = (dv.double() + pr[:, :, h, r].transpose(-1, -2)
                  @ dod[:, :, h, stale]).float()
            dk = (dk.double() + dsr[:, :, h, r].transpose(-1, -2)
                  @ qd[:, :, h, r]).float()
    return {"dq": dq.view(b, hq, sq, d).to(dtype), "dk": dk.to(dtype),
            "dv": dv.to(dtype)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_rounding_model_in_fp32_is_the_plain_backward(name):
    """With fp32 p and ds the model computes the plain versions' dq, dk
    and dv bit for bit: the same padding, tiles, order and dead rows."""
    case = CASES[name]
    x = _inputs(case, torch.float32, 5)
    model = _model(x, case, torch.float32)
    for gname, want in _plain(x, case).items():
        assert torch.equal(model[gname][0], want), gname


#: dO at the scale of a training step's (a mean loss over 4096 tokens):
#: in fp16 many ds values then fall below the normal range
TRAIN_SCALE = 2.0 ** -20


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [1.0, TRAIN_SCALE], ids=["unit", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_rounding_model_passes_the_rule(name, scale, dtype):
    """The model rounded to the dtype passes the C17 bound against the
    fp32 plain version on every gradient, at unit scale and at a training
    step's dO scale (where the subnormal floor matters in fp16). At unit
    scale the one-ulp rule of the fp32-accumulating kernels would refuse
    it, and a bump of four times the bound's rounding term fails the
    bound (at training scale fp16's subnormal spacing can hide both)."""
    case = CASES[name]
    x = _inputs(case, dtype, len(name), scale)
    model = _model(x, case, dtype)
    for gname, ref32 in _plain(x, case).items():
        m32, _, rounding = model[gname]
        _, ratio, one_ulp = smoke.wgmma_grad_error(torch, m32.to(dtype),
                                                   ref32, rounding)
        assert ratio <= 1.0, (gname, ratio)
        if scale != 1.0:
            continue
        assert one_ulp > 1.0, (gname, one_ulp)
        bumped = (m32 + 4 * rounding).to(dtype)
        assert smoke.wgmma_grad_error(torch, bumped, ref32, rounding)[1] > 1


def test_c17_needs_the_subnormal_floor_in_fp16(monkeypatch):
    """At a training step's dO scale, fp16 ds values below the normal
    range round by up to half a subnormal spacing, far more than u of
    themselves: without the floor term (``P_UNDERFLOW``) the bound refuses
    the model itself, with it the model passes."""
    case = CASES["llama_gqa_causal_300"]
    x = _inputs(case, torch.float16, 3, TRAIN_SCALE)
    ref32 = _plain(x, case)["dq"]
    ratios = []
    for floor in (smoke.P_UNDERFLOW["float16"], 0.0):
        monkeypatch.setitem(smoke.P_UNDERFLOW, "float16", floor)
        m32, _, rounding = _model(x, case, torch.float16)["dq"]
        ratios.append(smoke.wgmma_grad_error(
            torch, m32.to(torch.float16), ref32, rounding)[1])
    assert ratios[0] <= 1.0 < ratios[1], ratios


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [1.0, TRAIN_SCALE], ids=["unit", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_kernel_imitation_passes_the_tight_check(name, scale, dtype):
    """The kernels' arithmetic, imitated with another summation order,
    exp2 and 64-row tiles, agrees with the model within ``ulp + slack +
    tol max``, and with the fp32 plain version within the C17 bound, at
    unit and at training scale."""
    case = CASES[name]
    x = _inputs(case, dtype, 7, scale)
    model = _model(x, case, dtype)
    got = _kernel_sim(x, case, dtype)
    for gname, ref32 in _plain(x, case).items():
        m32, slack, rounding = model[gname]
        _, tight, _ = smoke.grad_model_error(torch, got[gname], m32, slack)
        assert tight <= 1.0, (gname, tight)
        _, ratio, _ = smoke.wgmma_grad_error(torch, got[gname], ref32,
                                             rounding)
        assert ratio <= 1.0, (gname, ratio)


def _fault_ratios(dtype, fault):
    case = CASES["llama_gqa_causal_300"]
    x = _inputs(case, dtype, 7)
    model = _model(x, case, dtype)
    got = _kernel_sim(x, case, dtype, fault)
    gname = FAULT_GRAD[fault]
    m32, slack, rounding = model[gname]
    _, tight, _ = smoke.grad_model_error(torch, got[gname], m32, slack)
    _, rule, _ = smoke.wgmma_grad_error(torch, got[gname],
                                        _plain(x, case)[gname], rounding)
    return tight, rule


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fault", FAULTS)
def test_bwd_tight_check_refuses_planted_faults(fault, dtype):
    """Each planted fault moves some element of the gradient it reaches
    past the tight check's allowance at Llama-3-8B's head widths."""
    tight, _ = _fault_ratios(dtype, fault)
    assert tight > 1.0, tight


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_c17_bound_alone_lets_a_fault_through(dtype):
    """The C17 bound is worst case: ``u |dS| |K|`` over a long causal row
    is several times the row's dq, so a kernel that rounds ds at another
    point (before the scale) passes it though every dq moves. The tight
    check refuses it."""
    tight, rule = _fault_ratios(dtype, "scale_after_rounding")
    assert rule <= 1.0 < tight, (rule, tight)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_dead_rows_get_zero_dq_and_add_nothing(dtype):
    """Rows with no valid key (rows 0..39 at kv_offset 40): the model and
    the imitation give them exactly zero dq, and with dO zero on every
    other row, exactly zero dk and dv."""
    case = CASES["dead_rows"]
    q, k, v, dout, lse, delta = _inputs(case, dtype, 11)
    dead = case[8] - case[7]
    dout[:, :, dead:] = 0
    out, _ = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       *case[6:7], None, *case[7:])
    x = (q, k, v, dout, lse, tfa.bwd_delta(out.to(dtype), dout))
    assert bool((lse[:, :, :dead] == tfa.NEG_INF).all())
    model = _model(x, case, dtype)
    got = _kernel_sim(x, case, dtype)
    for res in (got, {n: m[0] for n, m in model.items()}):
        assert float(res["dq"][:, :, :dead].abs().max()) == 0.0
        assert float(res["dk"].abs().max()) == 0.0
        assert float(res["dv"].abs().max()) == 0.0
    # and their dO does reach the forward's output: the mean of V
    assert float(out[:, :, :dead].abs().max()) > 1e-2


#: the fp32 plain backward against the interpret-mode Pallas backward:
#: the same fp32 recurrences, dots and GQA sums in other orders
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_plain_backward_matches_interpret_bwd(name):
    """``flash_attention_bwd_plain`` (what a CPU tensor runs and the card
    holds both variants against) against ``jax.vjp`` of the JAX package's
    ``flash_attention`` in interpret mode, whose custom VJP is ``_bwd``
    with its two Pallas kernels, at Llama-3-8B's head widths."""
    case = CASES[name]
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    x = _inputs(case, torch.float32, 13)
    q, k, v, dout = (t.numpy() for t in x[:4])

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, q_offset=qo,
                                   kv_offset=ko, interpret=True,
                                   kernel_layout=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal, None, qo, ko)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, None,
                                        causal, None, qo, ko)
    for which, g_, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = float(np.abs(g_.numpy() - w).max() / np.abs(w).max())
        assert err <= GRAD_RTOL, (which, err)
