"""The tensor-core variant of the port's flash attention forward (B1).

What the CUDA kernel cannot show on a CPU, tested here at small sizes:
which variant a call takes (``fwd_variant``), which operands its TMA
reads in place (``tma_operand``), and the checks ``chip_smoke.py`` holds
it to on the card. The kernel rounds the softmax weights to q's dtype
before ``P V`` while the reference dots in fp32 (ROADMAP C15).
``chip_smoke.rounding_model`` models those rounding points in plain
torch. Against the fp32 plain version and the JAX package's
interpret-mode Pallas kernel on the same seeded inputs, the model must
pass the worst-case bound (``wgmma_out_error``). A CPU imitation of the
kernel's arithmetic must pass the tight check against the model
(``model_error``), and the same imitation with a fault planted (a stale
V tile, a dropped correction, a skipped last tile) must fail it: the
check used on the card is itself tested.
"""
import importlib
import importlib.util
from pathlib import Path

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
    (torch.float32, 256, "simt")])
def test_fwd_variant(dtype, head_dim, want):
    assert tfa.fwd_variant(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim,exc", [
    (torch.float64, 128, TypeError), (torch.int8, 64, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 32, ValueError)])
def test_fwd_variant_raises(dtype, head_dim, exc):
    with pytest.raises(exc):
        tfa.fwd_variant(dtype, head_dim)


def _fused_views(b, s, hq, hk, d, dtype=torch.bfloat16):
    """q, k and v as SDPA gets them from one fused projection: ``[b, s,
    h, d]`` slices of a ``[b, s, (hq + 2 hk) d]`` tensor."""
    fused = torch.randn(b, s, (hq + 2 * hk) * d).to(dtype)
    heads = fused.view(b, s, hq + 2 * hk, d)
    return heads[:, :, :hq], heads[:, :, hq:hq + hk], heads[:, :, hq + hk:]


def tma_same(t):
    return tfa.tma_operand(t) is t


@pytest.mark.parametrize("d", [64, 128])
def test_tma_operand_reads_aligned_views_in_place(d):
    for t in _fused_views(2, 40, 4, 2, d):
        assert not t.is_contiguous()
        assert tma_same(t)
        assert tma_same(t.transpose(1, 2))          # kernel layout view


@pytest.mark.parametrize("how", ["base", "row_stride", "head_dim_stride"])
def test_tma_operand_copies_what_tma_cannot_read(how):
    base = torch.randn(2 * 40 * 257 + 64).to(torch.bfloat16)
    if how == "base":         # starts 2 bytes past an aligned address
        t = base[1:1 + 2 * 40 * 4 * 64].view(2, 40, 4, 64)
    elif how == "row_stride":  # rows 4 * 64 + 1 elements apart
        t = base.as_strided((2, 40, 4, 64), (40 * 257, 257, 64, 1))
    else:                     # head_dim not the unit-stride axis
        t = base[:2 * 40 * 4 * 64].view(2, 40, 64, 4).transpose(2, 3)
    got = tfa.tma_operand(t)
    assert got is not t and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, t)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tma_operand_copies_a_broadcast_view(axis):
    """An axis longer than 1 with stride 0 (an expanded view) passes the
    16-byte test (0 bytes) but TMA cannot step along it: it is copied."""
    shape = [2, 40, 4, 64]
    small = shape.copy()
    small[axis] = 1
    t = torch.randn(small).to(torch.bfloat16).expand(shape)
    assert t.stride(axis) == 0
    got = tfa.tma_operand(t)
    assert got is not t and got.is_contiguous()
    assert torch.equal(got, t)


def test_tma_operand_ignores_strides_of_length_one_axes():
    """An axis of extent 1 is never stepped along, so its stride does not
    need TMA's alignment."""
    t = torch.randn(1, 40, 4, 64).to(torch.bfloat16)
    odd = t.as_strided(t.shape, (3, 256, 64, 1))
    assert tma_same(odd)


# (b, hq, hk, sq, sk, d, causal, q_offset, kv_offset): Llama-3-8B's head
# widths and GQA cut to 300 tokens, and the dead-row case (rows 0..39 see
# no key; the reference's tiles are 64 x 100)
MODEL_CASES = {
    "llama_gqa_causal_300": (1, 32, 8, 300, 300, 128, True, 0, 0),
    "dead_rows": (1, 32, 8, 64, 100, 128, True, 0, 40),
}
LOG2E = 1.4426950408889634
FAULTS = ("stale_v", "no_correction", "skip_last_tile")


def _rounded_inputs(case, dtype, seed):
    b, hq, hk, sq, sk, d = case[:6]
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for shape in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def _model(q, k, v, case, dtype):
    causal, qo, ko = case[6:]
    return smoke.rounding_model(torch, tfa, q, k, v, causal, qo, ko, dtype)


def _kernel_sim(q, k, v, dtype, fault=None):
    """The tensor-core kernel's arithmetic on a causal case with both
    offsets 0, as far as the CPU can imitate it: key tiles of 128 in
    order, scores summed in another order than the model's (in fp64, then
    rounded to fp32), ``p = exp2((s - m) log2 e)`` as the kernel's exp2f
    computes it, P rounded to ``dtype``, fp32 l and accumulator. A fault
    a kernel could have can be planted: ``stale_v``, tile 1's P V reads
    tile 0's V (a ring stage read before its refill); ``no_correction``,
    tile 1 does not rescale the accumulator by ``exp(m - m')``;
    ``skip_last_tile``, the walk ends before the last, ragged tile.
    Returns out in ``dtype``."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.double().reshape(b, hk, g * sq, d)
    rows = torch.arange(sq).repeat(g)[:, None]
    m = torch.full((b, hk, g * sq, 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hk, g * sq, d))
    starts = list(range(0, sk, 128))
    if fault == "skip_last_tile":
        starts = starts[:-1]
    for t, j in enumerate(starts):
        kj = k[:, :, j:j + 128]
        vj = v[:, :, j - 128:j] if (fault, t) == ("stale_v", 1) \
            else v[:, :, j:j + 128]
        s = (qg @ kj.double().transpose(-1, -2)).float() * d ** -0.5
        s = torch.where(rows >= j + torch.arange(kj.shape[2]), s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2((s - m_new) * LOG2E)
        c = torch.exp2((m - m_new) * LOG2E)
        l = l * c + p.sum(-1, keepdim=True)
        c_acc = 1.0 if (fault, t) == ("no_correction", 1) else c
        acc = acc * c_acc + p.to(dtype).float() @ vj.float()
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(b, hq, sq, d).to(dtype)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_rounding_model_in_fp32_is_the_plain_recurrence(name):
    """With fp32 weights the model computes the plain version's output
    bit for bit: the same tiles, key ranges and dead rows."""
    case = MODEL_CASES[name]
    q, k, v = _rounded_inputs(case, torch.float32, 5)
    causal, qo, ko = case[6:]
    want, _ = tfa.flash_attention_plain(q, k, v, causal, None, qo, ko)
    out32, _ = _model(q, k, v, case, torch.float32)
    assert torch.equal(out32, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_rounding_model_passes_the_rule_and_a_perturbation_fails(name, dtype):
    """The model passes the C15 bound against the fp32 plain version, the
    one-ulp rule would refuse it, a bump of four times the bound's weight
    term fails the bound, and a stale V tile fails the tight check."""
    case = MODEL_CASES[name]
    causal, qo, ko = case[6:]
    q, k, v = _rounded_inputs(case, dtype, len(name))
    ref32, _ = tfa.flash_attention_plain(*(x.float() for x in (q, k, v)),
                                         causal, None, qo, ko)
    out32, slack = _model(q, k, v, case, dtype)
    _, ratio, one_ulp = smoke.wgmma_out_error(torch, out32.to(dtype), ref32, v)
    assert ratio <= 1.0, ratio
    # the rounding is visible: the one-ulp rule of the fp32-accumulating
    # kernels would refuse it
    assert one_ulp > 1.0, one_ulp
    # the C15 bound is finite: four times its weight term fails it
    u = smoke.P_ROUNDOFF[str(dtype).removeprefix("torch.")]
    bumped = (out32 + 4 * u * float(v.float().abs().max())).to(dtype)
    assert smoke.wgmma_out_error(torch, bumped, ref32, v)[1] > 1.0
    stale = v.clone()
    n = min(64, v.shape[2] // 2)
    stale[:, :, n:2 * n] = v[:, :, :n]
    bad32, _ = _model(q, k, stale, case, dtype)
    _, tight, _ = smoke.model_error(torch, bad32.to(dtype), out32, slack)
    assert tight > 1.0, tight


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_imitation_passes_the_tight_check(dtype):
    """The kernel's arithmetic, imitated with another score order and
    exp2, agrees with the model within ``ulp + slack + 1e-5``, though not
    always within ``ulp + 1e-5``: some weights round the other way."""
    case = MODEL_CASES["llama_gqa_causal_300"]
    q, k, v = _rounded_inputs(case, dtype, 7)
    out32, slack = _model(q, k, v, case, dtype)
    got = _kernel_sim(q, k, v, dtype)
    _, tight, _ = smoke.model_error(torch, got, out32, slack)
    assert tight <= 1.0, tight
    ref32, _ = tfa.flash_attention_plain(*(x.float() for x in (q, k, v)))
    _, ratio, _ = smoke.wgmma_out_error(torch, got, ref32, v)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fault", FAULTS)
def test_tight_check_refuses_planted_faults(fault, dtype):
    """Each planted fault moves the output of some row past the tight
    check's allowance at Llama-3-8B's head widths."""
    case = MODEL_CASES["llama_gqa_causal_300"]
    q, k, v = _rounded_inputs(case, dtype, 7)
    out32, slack = _model(q, k, v, case, dtype)
    got = _kernel_sim(q, k, v, dtype, fault)
    _, tight, _ = smoke.model_error(torch, got, out32, slack)
    assert tight > 1.0, tight


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_model_against_interpret_kernel_dead_rows(dtype):
    """The C15 bound against the JAX package's Pallas kernel in interpret
    mode on the same rounded inputs (fp32 in the kernel): its dead rows
    return the mean of V over the reference tile, and so does the model,
    within the bound."""
    case = MODEL_CASES["dead_rows"]
    causal, qo, ko = case[6:]
    q, k, v = _rounded_inputs(case, dtype, 3)
    want, want_lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), causal=causal,
        q_offset=qo, kv_offset=ko, interpret=True)
    out32, _ = _model(q, k, v, case, dtype)
    _, lse = tfa.flash_attention_plain(*(x.float() for x in (q, k, v)),
                                       causal, None, qo, ko)
    want = torch.from_numpy(np.array(want))
    _, ratio, _ = smoke.wgmma_out_error(torch, out32.to(dtype), want, v)
    assert ratio <= 1.0, ratio
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
    dead = ko - qo
    mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(
        q.shape[1] // v.shape[1], 1)
    _, ratio_dead, _ = smoke.wgmma_out_error(
        torch, out32[:, :, :dead].to(dtype), mean_v.expand(-1, -1, dead, -1),
        v)
    assert ratio_dead <= 1.0, ratio_dead
