"""Llama causal LM (port of ``paddle_tpu/models/llama.py``): RMSNorm
pre-norm, RoPE, grouped-query attention, SwiGLU MLP, and the causal-LM
loss for training (``LlamaPretrainingCriterion``), with optional
per-layer activation recompute.

Linear layers are ``torch.nn.Linear`` (``nn.layers.common.Linear``)
with ``[out, in]`` weights; the parameter names are the reference's, so
``state_dict()`` keys match and
:func:`paddle_tpu_torch.convert.load_jax_state` only transposes.

Every op of the forward and the loss is the reference's, by name, at the
same boundary (``embedding``, ``rms_norm``, ``linear``, ``reshape``,
``fused_rope``, ``flash_attn`` / ``sdpa_chunked`` / ``sdpa``, ``add``,
``fused_swiglu``, ``matmul`` for a tied head, ``causal_lm_loss``): its
inputs cast by the AMP policy (:mod:`paddle_tpu_torch.amp`), mixed float
dtypes promoted as jnp promotes them. So a bf16 model without AMP
computes as the reference's does: the rope's fp32 tables make q and k
fp32, and from layer 0's attention on the activations are fp32 on bf16
weights (ROADMAP C24); under ``auto_cast(level="O2")`` they stay in the
AMP dtype but for the norms.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import amp
from .._device import resolve_device
from ..amp import sites
from ..nn.functional import scaled_dot_product_attention
from ..nn.layers.common import Embedding, Linear
from ..nn.layers.norm import RMSNorm
from ..ops import fused
from .generation import GenerationMixin, SlotPagedKVCache


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, initializer_range=0.02,
                 tie_word_embeddings=False, use_recompute=False,
                 recompute_granularity="full", dtype="float32"):
        """``dtype`` is kept for the reference's ``from_pretrained``,
        its only reader; parameters are always created in float32, as
        the reference's are. A bf16 model is made with
        ``model.to(torch.bfloat16)`` or ``amp.decorate(level="O2")``."""
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.tie_word_embeddings = tie_word_embeddings
        self.use_recompute = use_recompute
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama3_8b(**kw):
    """Llama-3-8B widths."""
    return LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       max_position_embeddings=8192, rms_norm_eps=1e-5,
                       rope_theta=500000.0, **kw)


def llama_tiny(**kw):
    """CI-sized config exercising GQA + RoPE + SwiGLU."""
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 176)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("num_key_value_heads", 2)
    kw.setdefault("max_position_embeddings", 128)
    return LlamaConfig(**kw)


def _linear(i, o):
    return Linear(i, o, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, config):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m)
        self.up_proj = _linear(h, m)
        self.down_proj = _linear(m, h)

    def forward(self, x):
        return self.down_proj(fused.fused_swiglu(self.gate_proj(x),
                                                 self.up_proj(x)))


class LlamaAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.q_proj = _linear(h, self.num_heads * self.head_dim)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim)
        self.o_proj = _linear(self.num_heads * self.head_dim, h)

    def forward(self, hidden, cos, sin, attn_mask=None, position_ids=None,
                cache=None):
        b, s, _ = hidden.shape
        q = sites.reshape(self.q_proj(hidden), b, s, self.num_heads,
                          self.head_dim)
        k = sites.reshape(self.k_proj(hidden), b, s, self.num_kv_heads,
                          self.head_dim)
        v = sites.reshape(self.v_proj(hidden), b, s, self.num_kv_heads,
                          self.head_dim)
        q, k = fused.fused_rotary_position_embedding(
            q, k, sin=sin, cos=cos, position_ids=position_ids)
        if cache is not None:
            # the cache owns the KV layout and the attention over it
            out = cache.attend(self, q, k, v)
        else:
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
                training=self.training)
        return self.o_proj(sites.reshape(out, b, s,
                                         self.num_heads * self.head_dim))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, hidden, cos, sin, attn_mask=None, position_ids=None,
                cache=None):
        hidden = sites.add(hidden, self.self_attn(
            self.input_layernorm(hidden), cos, sin, attn_mask, position_ids,
            cache))
        return sites.add(hidden,
                         self.mlp(self.post_attention_layernorm(hidden)))


def _amp_contexts():
    """``checkpoint``'s ``context_fn``: the recompute in backward, which
    runs outside the forward's ``auto_cast`` block, replays the forward
    under the AMP state the forward had, so it casts as it did."""
    return contextlib.nullcontext(), amp._restored(amp._snapshot())


class LlamaModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def init_rope(self, device):
        """One RoPE table pair for every layer (the reference keeps a copy
        per layer with the same contents)."""
        c = self.config
        cos, sin = fused.rope_freqs(c.head_dim, c.max_position_embeddings,
                                    c.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def _apply(self, fn, recurse=True):
        # the RoPE tables stay fp32 when the model is cast (``.to(dtype)``,
        # ``.bfloat16()``), as the reference's plain arrays do (Mixtral's
        # model shares this method: no ``super()``)
        nn.Module._apply(self, fn, recurse)
        cos = getattr(self, "rope_cos", None)
        if cos is not None and cos.dtype != torch.float32:
            self.init_rope(cos.device)
        return self

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                cache=None):
        hidden = self.embed_tokens(input_ids)
        if cache is not None and position_ids is None:
            position_ids = torch.arange(cache.pos, cache.pos
                                        + input_ids.shape[1],
                                        device=input_ids.device)
        # per-layer recompute (reference ``:213-223``): each layer's
        # activations are dropped after its forward and recomputed in
        # backward, so attention's forward runs twice per step. As in the
        # reference, every recompute_granularity recomputes whole layers
        recompute = (self.config.use_recompute and self.training
                     and cache is None)
        for layer in self.layers:
            if recompute:
                hidden = checkpoint(layer, hidden, self.rope_cos,
                                    self.rope_sin, attn_mask, position_ids,
                                    use_reentrant=False,
                                    context_fn=_amp_contexts)
            else:
                hidden = layer(hidden, self.rope_cos, self.rope_sin,
                               attn_mask, position_ids, cache)
        hidden = self.norm(hidden)
        # a slot cache's step ends in its own end_step(), outside any
        # captured forward
        if cache is not None and not isinstance(cache, SlotPagedKVCache):
            cache.advance(input_ids.shape[1])
        return hidden


class LlamaPretrainingCriterion(nn.Module):
    """Causal-LM loss (reference ``:231-253``), the op
    ``"causal_lm_loss"``: log-softmax in fp32 whatever the logits' dtype
    (after the AMP policy's cast), ``ignore_index`` labels dropped, mean
    over the valid tokens (``max(count, 1)`` of them)."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        logits, labels = amp.amp_cast_inputs("causal_lm_loss",
                                             [logits, labels])
        lg = logits.float()
        logp = lg - torch.logsumexp(lg, dim=-1, keepdim=True)
        valid = labels != self.ignore_index
        safe = torch.where(valid, labels, 0)
        tok = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
        tok = torch.where(valid, tok, 0.0)
        return -tok.sum() / valid.sum().clamp_min(1)


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """``LlamaForCausalLM(config, device=None, seed=0)``.

    ``device=None`` means ``"cuda"`` and raises where CUDA is absent. The
    parameters are allocated directly on ``device`` in float32 and
    filled from a ``torch.Generator`` seeded with ``seed``: linear and
    embedding weights from N(0, initializer_range), norm weights 1.
    With ``config.tie_word_embeddings`` there is no ``lm_head``: the
    logits are the hidden states times the embedding's weight (reference
    ``:273``), one parameter for both.
    ``generate`` comes from :class:`GenerationMixin`.
    """

    supports_cache = True

    @classmethod
    def from_pretrained(cls, model_dir, dtype="float32", device=None,
                        **overrides):
        """Build from a local HF Llama checkpoint directory
        (``config.json`` plus safetensors or ``pytorch_model*.bin``;
        :mod:`~paddle_tpu_torch.models.pretrained`) on ``device``, every
        weight rounded to ``dtype`` in float32 parameters, as the
        reference's are. ``overrides`` replace config fields."""
        from .pretrained import llama_config_from_hf, load_llama_from_hf
        dev = resolve_device(device)
        cfg = llama_config_from_hf(model_dir, dtype=dtype, **overrides)
        return load_llama_from_hf(cls(cfg, device=dev), model_dir,
                                  dtype=dtype)

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.llama = LlamaModel(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else _linear(config.hidden_size,
                                         config.vocab_size))
        self.to_empty(device=dev)
        self.llama.init_rope(dev)
        self.criterion = LlamaPretrainingCriterion()
        self.reset_parameters(seed)

    @property
    def device(self):
        return self.llama.norm.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=gen)

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None, cache=None):
        """``input_ids [batch, seq]`` -> logits ``[batch, seq, vocab]``,
        or ``(loss, logits)`` when ``labels [batch, seq]`` are given (the
        labels of each position, already shifted by the caller; -100 is
        ignored). ``attn_mask`` (bool: True where a query sees a key; or
        float, added to the logits; broadcastable to ``[batch, heads,
        seq, seq]``) replaces the causal mask in cache-free attention, as
        in the reference (``:178``); a cache ignores it.
        ``position_ids`` ([seq] or [batch, seq]) may be a tensor or an
        array; with a cache and no positions they start at
        ``cache.pos``."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, dtype=torch.long,
                                           device=self.device)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=self.device)
        hidden = self.llama(input_ids, attn_mask, position_ids, cache)
        if self.lm_head is None:
            # the reference's ``matmul(hidden, w, transpose_y=True)``
            h, w = amp.promote(*amp.amp_cast_inputs(
                "matmul", [hidden, self.llama.embed_tokens.weight]))
            logits = nn.functional.linear(h, w)
        else:
            logits = self.lm_head(hidden)
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        return self.criterion(logits, labels), logits
