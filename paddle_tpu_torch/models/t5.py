"""T5 encoder-decoder (port of ``paddle_tpu/models/t5.py``; PaddleNLP's
``transformers/t5/modeling.py``): relative-position-bias attention
without the ``1/sqrt(d)`` scale, pre-RMSNorm blocks, a ReLU or gated-GeLU
feed-forward, one bias table a stack (its first block owns it), an
embedding shared by both stacks and the head (scaled by ``d_model **
-0.5`` when tied), and greedy ``generate`` with a decoder-side
:class:`~paddle_tpu_torch.models.generation.KVCache`.

The attention is the reference's op ``"t5_attention"``, plain torch as
the reference's is plain jnp: logits plus the bias, a ``-1e30`` causal
mask in the decoder's self-attention, ``exp(lg - max)`` normalised by
``max(sum, 1e-30)``. The buckets are numpy, as the reference computes
them (a torch ``log`` could move a bucket at a boundary).

``T5ForConditionalGeneration(config, device=None, seed=0)``:
``device=None`` means ``"cuda"`` and raises where CUDA is absent; the
parameters are drawn from a ``torch.Generator`` seeded with ``seed``,
each by the reference's initializer. ``from_pretrained`` loads a local
HF checkpoint (:mod:`~paddle_tpu_torch.models.pretrained`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import amp
from .._device import resolve_device
from ..amp import sites
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import Layer, LayerList
from ..nn.layers.common import Dropout, Embedding, Linear
from ..nn.layers.norm import RMSNorm
from ._seeded import materialize
from .generation import KVCache
from .llama import LlamaPretrainingCriterion


class T5Config:
    def __init__(self, vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                 num_layers=6, num_decoder_layers=None, num_heads=8,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128, dropout_rate=0.1,
                 layer_norm_epsilon=1e-6, feed_forward_proj="relu",
                 initializer_factor=1.0, pad_token_id=0,
                 decoder_start_token_id=0, eos_token_id=1,
                 tie_word_embeddings=True, **kw):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = num_decoder_layers or num_layers
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        self.feed_forward_proj = feed_forward_proj
        self.initializer_factor = initializer_factor
        self.pad_token_id = pad_token_id
        self.decoder_start_token_id = decoder_start_token_id
        self.eos_token_id = eos_token_id
        self.tie_word_embeddings = tie_word_embeddings
        for k, v in kw.items():
            setattr(self, k, v)


def t5_tiny(**kw):
    kw.setdefault("vocab_size", 128)
    kw.setdefault("d_model", 64)
    kw.setdefault("d_kv", 16)
    kw.setdefault("d_ff", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    return T5Config(**kw)


def _relative_bucket(rel, bidirectional, num_buckets, max_dist):
    """T5's bucket of each relative distance, in numpy (the reference's
    own arithmetic)."""
    rel = np.asarray(rel)
    if bidirectional:
        num_buckets //= 2
        base = (rel > 0).astype(np.int64) * num_buckets
        rel = np.abs(rel)
    else:
        base = np.zeros_like(rel)
        rel = -np.minimum(rel, 0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_dist / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return base + np.where(is_small, rel, large)


def _attention(q, k, v, bias, causal):
    """The reference's ``"t5_attention"`` body on ``[b, s, heads, d]``
    tensors in their (already cast) dtype."""
    lg = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        lg = torch.add(*amp.promote(lg, bias))
    if causal:
        ql, kl = q.shape[1], k.shape[1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        lg = torch.where(keep, lg, -1e30)
    w = torch.exp(lg - lg.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", *amp.promote(w, v))


class T5Attention(Layer):
    def __init__(self, config, is_decoder, has_relative_bias=False,
                 is_cross=False):
        super().__init__()
        cfg = config
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.is_cross = is_cross
        inner = cfg.num_heads * cfg.d_kv
        init = Normal(0.0, cfg.initializer_factor * (cfg.d_model ** -0.5))
        self.q = Linear(cfg.d_model, inner, weight_attr=init, bias_attr=False)
        self.k = Linear(cfg.d_model, inner, weight_attr=init, bias_attr=False)
        self.v = Linear(cfg.d_model, inner, weight_attr=init, bias_attr=False)
        self.o = Linear(inner, cfg.d_model, weight_attr=init,
                        bias_attr=False)
        self.has_relative_bias = has_relative_bias
        if has_relative_bias:
            self.relative_attention_bias = Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads,
                weight_attr=init)

    def _bias(self, q_len, k_len, q_offset=0):
        """``[1, heads, q_len, k_len]`` relative position bias."""
        ctx = np.arange(q_len)[:, None] + q_offset
        mem = np.arange(k_len)[None, :]
        buckets = _relative_bucket(
            mem - ctx, bidirectional=not self.is_decoder,
            num_buckets=self.cfg.relative_attention_num_buckets,
            max_dist=self.cfg.relative_attention_max_distance)
        emb = self.relative_attention_bias(torch.as_tensor(
            buckets, device=self.relative_attention_bias.weight.device))
        return sites.unsqueeze(sites.transpose(emb, (2, 0, 1)), 0)

    def _heads(self, x, n):
        return sites.reshape(x, x.shape[0], n, self.cfg.num_heads,
                             self.cfg.d_kv)

    def forward(self, hidden, kv_source=None, bias=None, cache=None):
        cfg = self.cfg
        b, s, _ = hidden.shape
        src = hidden if kv_source is None else kv_source
        q = self._heads(self.q(hidden), s)
        if self.is_cross and cache is not None:
            # the encoder's states are fixed across decode: K/V once
            store = getattr(cache, "_cross", None)
            if store is None:
                store = cache._cross = {}
            if id(self) not in store:
                store[id(self)] = (
                    self._heads(self.k(src), src.shape[1]).detach(),
                    self._heads(self.v(src), src.shape[1]).detach())
            k, v = store[id(self)]
        else:
            k = self._heads(self.k(src), src.shape[1])
            v = self._heads(self.v(src), src.shape[1])
        if cache is not None and not self.is_cross:
            k, v = cache.update(self, k, v)          # decoder self-attention
        args = amp.amp_cast_inputs("t5_attention", [q, k, v] + (
            [bias] if bias is not None else []))
        out = _attention(*args[:3], args[3] if bias is not None else None,
                         self.is_decoder and not self.is_cross)
        return self.o(sites.reshape(out, b, s, cfg.num_heads * cfg.d_kv))


class T5FF(Layer):
    def __init__(self, config):
        super().__init__()
        cfg = config
        init = Normal(0.0, cfg.initializer_factor * (cfg.d_model ** -0.5))
        self.gated = cfg.feed_forward_proj.startswith("gated")
        self.wi = Linear(cfg.d_model, cfg.d_ff, weight_attr=init,
                         bias_attr=False)
        if self.gated:
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, weight_attr=init,
                               bias_attr=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, weight_attr=init,
                         bias_attr=False)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x):
        h = self.wi(x)
        # the gated variant's GeLU is the tanh approximation (HF's
        # "gated-gelu")
        h = (sites.multiply(F.gelu(h, approximate=True), self.wi_1(x))
             if self.gated else F.relu(h))
        return self.wo(self.dropout(h))


class T5Block(Layer):
    def __init__(self, config, is_decoder, has_relative_bias):
        super().__init__()
        cfg = config
        self.is_decoder = is_decoder
        self.norm1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.self_attn = T5Attention(cfg, is_decoder, has_relative_bias)
        if is_decoder:
            self.norm_cross = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
            self.cross_attn = T5Attention(cfg, is_decoder, is_cross=True)
        self.norm2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ff = T5FF(cfg)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, enc=None, bias=None, cache=None):
        x = sites.add(x, self.dropout(self.self_attn(
            self.norm1(x), bias=bias, cache=cache)))
        if self.is_decoder and enc is not None:
            x = sites.add(x, self.dropout(self.cross_attn(
                self.norm_cross(x), kv_source=enc, cache=cache)))
        return sites.add(x, self.dropout(self.ff(self.norm2(x))))


class T5Stack(Layer):
    def __init__(self, config, is_decoder):
        super().__init__()
        cfg = config
        self.cfg = cfg
        self.is_decoder = is_decoder
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        # one relative bias table a stack; block 0 owns it
        self.blocks = LayerList([
            T5Block(cfg, is_decoder, has_relative_bias=(i == 0))
            for i in range(n)])
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, hidden, enc=None, cache=None):
        s = hidden.shape[1]
        q_off = cache.pos if (cache is not None and self.is_decoder) else 0
        bias = self.blocks[0].self_attn._bias(s, s + q_off, q_offset=q_off)
        hidden = self.dropout(hidden)
        for blk in self.blocks:
            hidden = blk(hidden, enc=enc, bias=bias, cache=cache)
        if cache is not None and self.is_decoder:
            cache.advance(s)
        return self.final_norm(hidden)


class T5ForConditionalGeneration(Layer):
    """The encoder-decoder LM. ``forward(input_ids, decoder_input_ids=None,
    labels=None, encoder_outputs=None, cache=None)`` gives the logits, or
    ``(loss, logits)`` with ``labels`` (the decoder's inputs are then the
    labels shifted right when not given; -100 ignored). With
    ``tie_word_embeddings=False`` the head is its own unscaled
    ``lm_head``."""

    @classmethod
    def from_pretrained(cls, model_dir, dtype="float32", device=None,
                        **overrides):
        """Build from a local HF T5 checkpoint directory on ``device``
        (:mod:`~paddle_tpu_torch.models.pretrained`), every weight
        rounded to ``dtype``; ``overrides`` replace config fields."""
        from .pretrained import load_t5_from_hf, t5_config_from_hf
        dev = resolve_device(device)
        cfg = t5_config_from_hf(model_dir, **overrides)
        return load_t5_from_hf(cls(cfg, device=dev), model_dir, dtype=dtype)

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        cfg = config
        with torch.device("meta"):
            self.shared = Embedding(cfg.vocab_size, cfg.d_model,
                                    weight_attr=Normal(
                                        0.0, cfg.initializer_factor))
            self.encoder = T5Stack(cfg, is_decoder=False)
            self.decoder = T5Stack(cfg, is_decoder=True)
            self.lm_head = None if cfg.tie_word_embeddings else Linear(
                cfg.d_model, cfg.vocab_size,
                weight_attr=Normal(0.0, cfg.initializer_factor),
                bias_attr=False)
        materialize(self, device, seed)
        self.criterion = LlamaPretrainingCriterion()

    @property
    def device(self):
        return self.shared.weight.device

    def _ids(self, ids):
        return None if ids is None else torch.as_tensor(
            ids, dtype=torch.long, device=self.device)

    def _shift_right(self, labels):
        start = torch.full((labels.shape[0], 1),
                           self.config.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        shifted = torch.cat([start, labels[:, :-1]], dim=1)
        # ignored positions (-100) become the pad token as decoder inputs
        return torch.where(shifted == -100, self.config.pad_token_id,
                           shifted)

    def encode(self, input_ids):
        return self.encoder(self.shared(self._ids(input_ids)))

    def forward(self, input_ids, decoder_input_ids=None, labels=None,
                encoder_outputs=None, cache=None):
        if encoder_outputs is None:
            encoder_outputs = self.encode(input_ids)
        labels = self._ids(labels)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("need decoder_input_ids or labels")
            decoder_input_ids = self._shift_right(labels)
        dec = self.decoder(self.shared(self._ids(decoder_input_ids)),
                           enc=encoder_outputs, cache=cache)
        if self.lm_head is not None:
            logits = self.lm_head(dec)
        else:
            logits = sites.matmul_t(
                sites.multiply(dec, self.config.d_model ** -0.5),
                self.shared.weight)
        if labels is None:
            return logits
        return self.criterion(logits, labels), logits

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, eos_token_id=None):
        """Greedy decode: the encoder runs once, the decoder a token a step
        over a :class:`KVCache` (cross-attention K/V kept after the first
        step). Returns ``[b, 1 + new]`` int64 ids, the start token first;
        a row that emitted ``eos`` continues with it, and decoding stops
        once every row has."""
        was_training = self.training
        self.eval()
        try:
            ids = self._ids(input_ids)
            eos = (self.config.eos_token_id if eos_token_id is None
                   else eos_token_id)
            enc = self.encode(ids)
            b = ids.shape[0]
            cache = KVCache()
            out = torch.full((b, 1), self.config.decoder_start_token_id,
                             dtype=torch.long, device=ids.device)
            cur = out
            finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
            for _ in range(max_new_tokens):
                logits = self.forward(None, decoder_input_ids=cur,
                                      encoder_outputs=enc, cache=cache)
                nxt = logits[:, -1].float().argmax(-1)
                if eos is not None:
                    nxt = torch.where(finished, int(eos), nxt)
                    finished |= nxt == eos
                out = torch.cat([out, nxt[:, None]], dim=1)
                cur = nxt[:, None]
                if eos is not None and bool(finished.all()):
                    break
            return out
        finally:
            if was_training:
                self.train()


__all__ = ["T5Config", "T5ForConditionalGeneration", "t5_tiny"]
