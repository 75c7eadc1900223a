"""SDPA's three routes in the port (``nn/functional.py``) against the
reference (``paddle_tpu/nn/functional/common.py:571``) on the CPU.

* ``"sdpa"`` (masks, dropout): against the reference's SDPA, forward and
  gradients through its tape, fp32 (1e-5, both sum fp32 einsums in
  different orders).
* ``"flash_attn"``: against the reference's Pallas kernel in interpret
  mode, called directly (on the CPU the reference's SDPA takes the dense
  route, its flash gate needs a TPU), on the dtypes the reference's rope
  gives a bf16 model (q and k fp32, v bf16), forward and ``jax.vjp``
  gradients (1e-5 of each output's max: both cast v up exactly and run
  fp32; the bf16 dv within one bf16 roundoff, ``BF16_TOL``).
* ``"sdpa_chunked"``: against ``xla_attention``, forward and gradients,
  with both packages on the same blocks; and no ``seq_q x seq_k`` plane
  is materialised, forward or backward. The route's thresholds are held
  by the predicate alone (running them would take GiBs).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.nn import functional as F
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
#: where v is bf16, what is rounded to bf16 (the chunked route's weights
#: before ``P V`` and ``P^T dO``, a bf16 dv) may round the other way
#: where the two packages' fp32 values straddle a rounding point: one
#: bf16 roundoff (2^-8) of the output's max
BF16_TOL = 2.0 ** -8


def _rel(got, want):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _qkv(b, sq, sk, hq, hk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32),
            rng.randn(b, sq, hq, d).astype(np.float32))


# -- the route predicate ----------------------------------------------------------

@pytest.mark.parametrize("case,want", [
    (((1, 128, 8, 64), (1, 128, 8, 64), False, False), "flash_attn"),
    (((1, 128, 8, 64), (1, 128, 8, 64), True, False), "sdpa"),
    (((1, 128, 8, 64), (1, 128, 8, 64), False, True), "sdpa"),
    (((1, 127, 8, 64), (1, 127, 8, 64), False, False), "sdpa"),
    (((1, 128, 8, 96), (1, 128, 8, 96), False, False), "sdpa"),
    # one 4096 x 4096 plane, head_dim off flash's grid
    (((1, 4096, 1, 32), (1, 4096, 1, 32), False, False), "sdpa_chunked"),
    (((1, 4096, 1, 32), (1, 4095, 1, 32), False, False), "sdpa"),
    # 1 GiB of fp32 logits with a small plane: 8 x 32 x 1024 x 1024
    (((8, 1024, 32, 32), (8, 1024, 8, 32), False, False), "sdpa_chunked"),
    (((8, 1024, 31, 32), (8, 1024, 31, 32), False, False), "sdpa"),
    (((8, 1, 32, 32), (8, 1 << 20, 8, 32), False, False), "sdpa"),
    (((1, 4096, 1, 32), (1, 4096, 1, 32), True, False), "sdpa"),
    (((1, 4096, 1, 64), (1, 4096, 1, 64), False, False), "flash_attn"),
])
def test_route_predicate_at_the_reference_thresholds(case, want):
    assert F.sdpa_route(*case) == want


@pytest.mark.parametrize("route,shape", [
    ("flash_attn", (1, 128, 2, 64)), ("sdpa", (1, 16, 2, 64))])
def test_route_names_the_op_the_policy_casts(route, shape):
    q = torch.randn(*shape)
    with debugging.collect_operator_stats() as st:
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            out = F.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert [r[0] for r in st.records] == [route]
    # white under O1: bf16; flash_attn is gray: the fp32 inputs stay
    assert out.dtype == (torch.bfloat16 if route == "sdpa"
                         else torch.float32)


# -- dense route: masks -----------------------------------------------------------

def _masks(b, sq, sk, seed):
    rng = np.random.RandomState(seed)
    keep = rng.rand(b, 1, sq, sk) > 0.3
    keep[..., 0] = True                      # every row sees a key
    return {"bool": keep,
            "additive": (rng.randn(b, 1, sq, sk) * 2).astype(np.float32),
            "bool_2d": keep[0, 0]}


def _jax_sdpa(q, k, v, dout, mask, causal):
    jq, jk, jv = (Tensor(jnp.asarray(x), stop_gradient=False)
                  for x in (q, k, v))
    out = JF.scaled_dot_product_attention(
        jq, jk, jv, attn_mask=None if mask is None else Tensor(
            jnp.asarray(mask)), is_causal=causal)
    (out * Tensor(jnp.asarray(dout))).sum().backward()
    return out, [np.asarray(t.grad._data) for t in (jq, jk, jv)]


def _torch_sdpa(q, k, v, dout, mask, causal, **kw):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(
        tq, tk, tv, attn_mask=None if mask is None else torch.as_tensor(
            mask), is_causal=causal, **kw)
    (out * torch.from_numpy(dout)).sum().backward()
    return out, [t.grad for t in (tq, tk, tv)]


@pytest.mark.parametrize("mask_kind", ["bool", "additive", "bool_2d", None])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_dense_route_matches_the_reference(mask_kind, causal, heads):
    b, sq, sk, d = 2, 12, 12, 16
    q, k, v, dout = _qkv(b, sq, sk, *heads, d, 11)
    mask = None if mask_kind is None else _masks(b, sq, sk, 4)[mask_kind]
    assert F.sdpa_route(q.shape, k.shape, mask is not None) == "sdpa"
    jout, jgrads = _jax_sdpa(q, k, v, dout, mask, causal)
    tout, tgrads = _torch_sdpa(q, k, v, dout, mask, causal)
    assert _rel(tout, jout._data) <= TOL
    for g, w in zip(tgrads, jgrads):
        assert _rel(g, w) <= TOL


def test_dense_route_mixed_dtypes_promote_like_jnp():
    """q and k fp32, v bf16 (a bf16 model's rope, C24): fp32 logits and
    output, as jnp promotes the product of fp32 weights with bf16 v."""
    q, k, v, _ = _qkv(1, 8, 8, 2, 2, 16, 5)
    mask = _masks(1, 8, 8, 2)["additive"]
    jout = JF.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v, jnp.bfloat16)),
        attn_mask=Tensor(jnp.asarray(mask)))
    tout = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k),
        torch.from_numpy(v).bfloat16(), attn_mask=torch.from_numpy(mask))
    assert str(jout._data.dtype) == "float32" and tout.dtype == torch.float32
    assert _rel(tout, jout._data) <= TOL


# -- dense route: dropout -----------------------------------------------------------

def _dropout_probe(p, seed, training=True):
    """Attention whose V is the identity over 64 keys: the output rows
    are the (dropped, rescaled) weights themselves."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 32, 2, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 64, 2, 64).astype(np.float32))
    v = torch.eye(64).expand(2, 2, 64, 64).transpose(1, 2).contiguous()
    gen = torch.Generator().manual_seed(seed)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=p,
                                         training=training, generator=gen)
    ref = F.scaled_dot_product_attention(q, k, v)
    return out, ref


def test_dropout_is_seeded_and_scaled():
    p = 0.25
    a, ref = _dropout_probe(p, 7)
    b, _ = _dropout_probe(p, 7)
    c, _ = _dropout_probe(p, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    rate = float(kept.float().mean())
    # 2 x 32 x 2 x 64 = 8192 draws: the kept share within 5 sigma of 0.75
    assert abs(rate - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / kept.numel())
    torch.testing.assert_close(a[kept], ref[kept] / (1 - p), rtol=1e-6,
                               atol=0)
    off, _ = _dropout_probe(p, 7, training=False)
    assert torch.equal(off, ref)
    # dropout takes the dense route even where flash would run
    assert F.sdpa_route((1, 128, 2, 64), (1, 128, 2, 64),
                        dropout=True) == "sdpa"


# -- flash route ---------------------------------------------------------------------

@pytest.mark.parametrize("v_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(128, 128), (160, 224)])
def test_flash_route_matches_the_reference_kernel(v_dtype, sq, sk):
    b, hq, hk, d = 1, 4, 2, 64
    q, k, v, dout = _qkv(b, sq, sk, hq, hk, d, sq + sk)
    jv = jnp.asarray(v, getattr(jnp, v_dtype))

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=True,
                                   q_offset=sk - sq, interpret=True)
    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jv)
    jgrads = vjp(jnp.asarray(dout))
    tq, tk = (torch.tensor(x, requires_grad=True) for x in (q, k))
    tv = torch.tensor(v).to(getattr(torch, v_dtype)).requires_grad_()
    assert F.sdpa_route(tq.shape, tk.shape) == "flash_attn"
    tout = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    (tout * torch.from_numpy(dout)).sum().backward()
    assert tout.dtype == torch.float32 == getattr(torch, str(jout.dtype))
    assert _rel(tout, jout) <= TOL
    for t, w in zip((tq, tk, tv), jgrads):
        assert str(t.grad.dtype)[6:] == str(w.dtype)
        assert _rel(t.grad, w) <= (TOL if t.dtype == torch.float32
                                   else BF16_TOL)


def test_flash_route_casts_back_to_q_dtype():
    """Mixed with a 16-bit q: the kernels run fp32 and the output is q's
    dtype, as the Pallas kernel returns it."""
    q, k, v, _ = _qkv(1, 128, 128, 2, 2, 64, 3)
    tq = torch.from_numpy(q).bfloat16()
    out = F.scaled_dot_product_attention(tq, torch.from_numpy(k),
                                         torch.from_numpy(v), is_causal=True)
    want = jfa.flash_attention(jnp.asarray(tq.float().numpy(), jnp.bfloat16),
                               jnp.asarray(k), jnp.asarray(v), causal=True,
                               interpret=True)
    assert out.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(out, want) <= 2.0 ** -8


# -- chunked route ---------------------------------------------------------------

CHUNK_CASES = {
    # name: b, sq, sk, hq, hk, d, causal, blocks (q, k)
    "causal_gqa": (2, 64, 64, 4, 2, 32, True, (16, 32)),
    "causal_offset": (1, 32, 96, 2, 1, 32, True, (16, 32)),
    "full_mha": (1, 48, 64, 2, 2, 16, False, (16, 32)),
    "one_block": (1, 64, 64, 2, 2, 32, True, (512, 1024)),
}


@pytest.mark.parametrize("v_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_chunked_route_matches_xla_attention(name, v_dtype, monkeypatch):
    b, sq, sk, hq, hk, d, causal, (bq, bk) = CHUNK_CASES[name]
    monkeypatch.setenv("PADDLE_TPU_XFA_BLOCK_Q", str(bq))
    monkeypatch.setenv("PADDLE_TPU_XFA_BLOCK_K", str(bk))
    q, k, v, dout = _qkv(b, sq, sk, hq, hk, d, len(name))
    qt, kt, vt, dt = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v,
                                                              dout))
    q_off = sk - sq if causal else 0
    jv = jnp.asarray(vt, getattr(jnp, v_dtype))

    def f(q_, k_, v_):
        return jfa.xla_attention(q_, k_, v_, causal=causal, q_offset=q_off)
    jout, vjp = jax.vjp(f, jnp.asarray(qt), jnp.asarray(kt), jv)
    jgrads = vjp(jnp.asarray(dt))
    tq, tk = (torch.tensor(x, requires_grad=True) for x in (qt, kt))
    tv = torch.tensor(vt).to(getattr(torch, v_dtype)).requires_grad_()
    tout = F.chunked_attention(tq, tk, tv, causal=causal, q_offset=q_off,
                               block_q=bq, block_k=bk)
    (tout * torch.from_numpy(dt)).sum().backward()
    assert tout.dtype == torch.float32
    tol = TOL if v_dtype == "float32" else BF16_TOL
    assert _rel(tout, jout) <= tol
    for t, w in zip((tq, tk, tv), jgrads):
        assert str(t.grad.dtype)[6:] == str(w.dtype)
        assert _rel(t.grad, w) <= tol


def test_chunked_route_through_sdpa_and_ragged_blocks():
    """The public call at blocks that do not divide the sequences (the
    reference's tier falls back to its q-chunked one there; the same
    function) against the dense route."""
    q, k, v, dout = _qkv(1, 72, 88, 2, 1, 32, 9)
    got = F.chunked_attention(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (q, k, v)), causal=True,
                              q_offset=16, block_q=20, block_k=24)
    want = F.scaled_dot_product_attention(*(torch.from_numpy(x)
                                            for x in (q, k, v)),
                                          is_causal=True)
    assert _rel(got.transpose(1, 2), want) <= TOL


class _Largest(TorchDispatchMode):
    """The largest tensor any op returns while active."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_chunked_route_never_holds_a_logits_plane():
    b, h, s, d, bq, bk = 1, 2, 256, 16, 32, 64
    q, k, v, dout = (torch.from_numpy(x).transpose(1, 2).contiguous()
                     for x in _qkv(b, s, s, h, h, d, 2))
    with _Largest() as fwd:
        out, lse = F._chunked_fwd(q, k, v, True, 0, bq, bk)
    with _Largest() as bwd:
        F._chunked_bwd(q, k, v, out, lse, dout, True, 0, bq, bk)
    plane = b * h * s * s
    # one block's scores: b h bq bk = 4096 elements, against 131072
    assert fwd.numel <= max(b * h * bq * bk, b * h * s * d)
    assert bwd.numel <= max(b * h * bq * bk, b * h * s * d)
    assert max(fwd.numel, bwd.numel) * 16 <= plane


# -- the model --------------------------------------------------------------------

def test_llama_attn_mask_matches_the_reference():
    """``LlamaForCausalLM(ids, attn_mask=)``: the mask replaces the causal
    one (``is_causal = attn_mask is None``), as in the reference."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2, max_position_embeddings=64))
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2,
                                           max_position_embeddings=64),
                             device="cpu")
    pt.load_jax_state(tm, {k: np.asarray(v)
                           for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 128, (2, 12))
    causal = np.tril(np.ones((12, 12), bool))
    pad = np.ones((2, 1, 12, 12), bool)
    pad[1, ..., :3] = False                   # left padding of row 1
    pad[1, 0, :3, 0] = True                    # pad queries see one key
    for mask in (causal, causal & pad, np.where(causal, 0.0, -1e9).astype(
            np.float32)):
        want = jm(Tensor(jnp.asarray(ids)), attn_mask=Tensor(
            jnp.asarray(mask)))
        got = tm(ids, attn_mask=mask)
        assert _rel(got, want._data) <= TOL
    plain = tm(ids)
    assert _rel(tm(ids, attn_mask=causal), plain.detach().numpy()) <= TOL
