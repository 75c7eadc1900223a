"""The port's transformer layers (``paddle_tpu_torch/nn/layers/
transformer.py``) against the reference's (``paddle_tpu/nn/layers/
transformer.py``) on shared weights, fp32, CPU: ``MultiHeadAttention``
with bool and additive masks and both caches, the encoder and decoder
layers and stacks (post- and pre-norm), ``Transformer``, and
``generate_square_subsequent_mask``; outputs and gradients within
``rtol = atol = 1e-5``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.functional import sdpa_route
from torch_zoo_common import (arrays_of, close, close_grads, cpu_device,  # noqa: F401
                              jt, npy, one_torch_thread)

D, HEADS, B, SQ, SK = 32, 4, 2, 5, 7


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, cpu_device):  # noqa: F811
    yield


def _pair(jcls, tcls, *args, seed=0, **kw):
    """The reference's layer from ``seed`` and the port's with its
    weights."""
    paddle.seed(seed)
    jl = jcls(*args, **kw)
    tl = tcls(*args, **kw)
    pt.load_jax_state(tl, arrays_of(jl))
    return jl, tl


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _backward(out, cot, lib):
    if lib == "jax":
        (out * jt(cot)).sum().backward()
    else:
        (out * torch.from_numpy(cot)).sum().backward()


def _mask(kind):
    rng = np.random.RandomState(4)
    if kind == "bool":
        m = rng.rand(B, 1, SQ, SK) > 0.3
        m[..., 0] = True                       # every query sees a key
        return m
    if kind == "float":
        return (rng.randn(B, 1, SQ, SK) * 2).astype(np.float32)
    return None


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_multi_head_attention_matches_reference(mask):
    jl, tl = _pair(jnn.MultiHeadAttention, pt.nn.MultiHeadAttention, D,
                   HEADS)
    q, kv = _x(B, SQ, D), _x(B, SK, D, seed=2)
    m = _mask(mask)
    jout = jl(jt(q), jt(kv), jt(kv), None if m is None else jt(m))
    tout = tl(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
              None if m is None else torch.from_numpy(m))
    close(tout, jout, f"MHA out, mask {mask}")
    cot = _x(B, SQ, D, seed=3)
    _backward(jout, cot, "jax")
    _backward(tout, cot, "torch")
    close_grads(tl, jl, f"MHA, mask {mask}")


def test_multi_head_attention_caches_match_reference():
    """An incremental ``Cache`` grows one step at a time; a
    ``StaticCache`` holds a memory's projections."""
    jl, tl = _pair(jnn.MultiHeadAttention, pt.nn.MultiHeadAttention, D,
                   HEADS, seed=1)
    x, mem = _x(B, 4, D), _x(B, SK, D, seed=2)
    jc = jl.gen_cache(jt(x))
    tc = tl.gen_cache(torch.from_numpy(x))
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (B, 0, HEADS, D // HEADS)
    for i in range(4):
        step = x[:, i:i + 1]
        jout, jc = jl(jt(step), cache=jc)
        tout, tc = tl(torch.from_numpy(step), cache=tc)
        close(tout, jout, f"incremental step {i}")
        close(tc.k, jc.k, f"cache k after step {i}")
    js = jl.gen_cache(jt(mem), type=jnn.MultiHeadAttention.StaticCache)
    ts = tl.gen_cache(torch.from_numpy(mem),
                      type=pt.nn.MultiHeadAttention.StaticCache)
    close(ts.v, js.v, "static cache v")
    close(tl(torch.from_numpy(x), cache=ts), jl(jt(x), cache=js),
          "attention over a static cache")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_reference(normalize_before):
    paddle.seed(2)
    jlayer = jnn.TransformerEncoderLayer(D, HEADS, 64, dropout=0.0,
                                         normalize_before=normalize_before,
                                         activation="gelu")
    jenc = jnn.TransformerEncoder(jlayer, 2, norm=jnn.LayerNorm(D)
                                  if normalize_before else None)
    tlayer = pt.nn.TransformerEncoderLayer(D, HEADS, 64, dropout=0.0,
                                           normalize_before=normalize_before,
                                           activation="gelu")
    tenc = pt.nn.TransformerEncoder(tlayer, 2, norm=pt.nn.LayerNorm(D)
                                    if normalize_before else None)
    pt.load_jax_state(tenc, arrays_of(jenc))
    src = _x(B, SK, D)
    m = (np.random.RandomState(5).randn(B, 1, 1, SK) * 3).astype(np.float32)
    jout = jenc(jt(src), jt(m))
    tout = tenc(torch.from_numpy(src), torch.from_numpy(m))
    close(tout, jout, f"encoder out, normalize_before={normalize_before}")
    cot = _x(B, SK, D, seed=6)
    _backward(jout, cot, "jax")
    _backward(tout, cot, "torch")
    close_grads(tenc, jenc, "encoder")


def test_decoder_with_caches_matches_reference():
    """The decoder stack whole, then a token at a time over the caches
    ``gen_cache`` makes (incremental self-attention, static
    cross-attention)."""
    paddle.seed(3)
    jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        D, HEADS, 64, dropout=0.0), 2)
    tdec = pt.nn.TransformerDecoder(pt.nn.TransformerDecoderLayer(
        D, HEADS, 64, dropout=0.0), 2)
    pt.load_jax_state(tdec, arrays_of(jdec))
    jdec.eval()
    tdec.eval()
    tgt, mem = _x(B, 4, D), _x(B, SK, D, seed=2)
    causal = np.tril(np.ones((4, 4), bool))
    close(tdec(torch.from_numpy(tgt), torch.from_numpy(mem),
               torch.from_numpy(causal)),
          jdec(jt(tgt), jt(mem), jt(causal)), "decoder, causal bool mask")
    jc = jdec.gen_cache(jt(mem))
    tc = tdec.gen_cache(torch.from_numpy(mem))
    for i in range(4):
        step = tgt[:, i:i + 1]
        jout, jc = jdec(jt(step), jt(mem), cache=jc)
        tout, tc = tdec(torch.from_numpy(step), torch.from_numpy(mem),
                        cache=tc)
        close(tout, jout, f"decoder step {i}")


def test_transformer_matches_reference():
    jl, tl = _pair(jnn.Transformer, pt.nn.Transformer, d_model=D, nhead=HEADS,
                   num_encoder_layers=2, num_decoder_layers=2,
                   dim_feedforward=64, dropout=0.0, normalize_before=True,
                   seed=4)
    assert list(tl.state_dict()) == list(jl.state_dict())
    src, tgt = _x(B, SK, D), _x(B, 4, D, seed=2)
    jmask = jnn.Transformer.generate_square_subsequent_mask(4)
    tmask = pt.nn.Transformer.generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(npy(tmask), npy(jmask))
    jout = jl(jt(src), jt(tgt), tgt_mask=jmask)
    tout = tl(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    close(tout, jout, "transformer out")
    cot = _x(B, 4, D, seed=7)
    _backward(jout, cot, "jax")
    _backward(tout, cot, "torch")
    close_grads(tl, jl, "transformer")


def test_encoder_without_mask_takes_the_flash_route_non_causal():
    """At head_dim 64 and 128 queries, no mask: the port's SDPA takes the
    flash route, non-causal (B1 on a CUDA tensor; its plain version
    here); the reference's CPU SDPA takes its einsum. Same values."""
    d, heads, s = 128, 2, 128
    assert sdpa_route((1, s, heads, d // heads),
                      (1, s, heads, d // heads)) == "flash_attn"
    jl, tl = _pair(jnn.MultiHeadAttention, pt.nn.MultiHeadAttention, d,
                   heads, seed=5)
    x = _x(1, s, d)
    close(tl(torch.from_numpy(x)), jl(jt(x)), "MHA on the flash route")
