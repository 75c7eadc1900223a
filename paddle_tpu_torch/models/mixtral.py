"""Mixtral sparse-MoE causal LM (port of ``paddle_tpu/models/mixtral.py``;
PaddleNLP's ``mixtral/modeling.py``): Llama's attention, RMSNorm and RoPE,
with the dense SwiGLU MLP replaced by top-k routed SwiGLU experts and the
router's load-balance aux loss.

The sparse block is the GShard dispatch of
:mod:`paddle_tpu_torch.incubate.distributed.models.moe` over stacked
expert weights ``w_gate``, ``w_up [E, h, m]`` and ``w_down [E, m, h]``,
the reference's op ``"mixtral_moe"``: the router's logits in fp32, the
experts' products as einsums, which promote to fp32 beside the fp32
dispatch tensors, as jnp's do. Attention is the port's
:class:`~paddle_tpu_torch.models.llama.LlamaAttention`, so a Mixtral
reaches every kernel a Llama does: B1-B3 without a cache, B4 under
``generate(use_paged_cache=True)``, kernels 6 and 8 under the continuous
engine, whose ticks route their padding tokens too (they take capacity,
as in the reference).

``MixtralForCausalLM(config, device=None, seed=0)``: ``device=None`` means
``"cuda"`` and raises where CUDA is absent; the parameters are drawn from
a ``torch.Generator`` seeded with ``seed``, each by the reference's
initializer."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..amp import sites
from ..incubate.distributed.models.moe import (dispatch_combine, einsum,
                                               moe_capacity)
from ..nn.initializer import Normal, XavierUniform
from ..nn.layer import Layer, LayerList
from ..nn.layers.common import Embedding, Linear
from ..nn.layers.norm import RMSNorm
from ._seeded import materialize
from .generation import GenerationMixin, SlotPagedKVCache
from .llama import (LlamaAttention, LlamaConfig, LlamaModel,
                    LlamaPretrainingCriterion, _amp_contexts)


class MixtralConfig(LlamaConfig):
    def __init__(self, num_local_experts=8, num_experts_per_tok=2,
                 router_aux_loss_coef=0.02, moe_capacity_factor=2.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_local_experts = num_local_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.router_aux_loss_coef = router_aux_loss_coef
        self.moe_capacity_factor = moe_capacity_factor


def mixtral_8x7b(**kw):
    """Mixtral-8x7B widths (46.7 B parameters, 12.9 B active a token)."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("intermediate_size", 14336)
    kw.setdefault("num_hidden_layers", 32)
    kw.setdefault("num_attention_heads", 32)
    kw.setdefault("num_key_value_heads", 8)
    kw.setdefault("max_position_embeddings", 32768)
    kw.setdefault("rope_theta", 1e6)
    return MixtralConfig(**kw)


def mixtral_tiny(**kw):
    """CI-sized: routing, GQA, RoPE and SwiGLU experts."""
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 96)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("num_key_value_heads", 2)
    kw.setdefault("max_position_embeddings", 128)
    kw.setdefault("num_local_experts", 4)
    return MixtralConfig(**kw)


class MixtralSparseMoeBlock(Layer):
    """Top-k routed SwiGLU experts. The capacity ``C = ceil(S cf k / E)``
    comes from the token count; a token past its expert's capacity keeps
    its residual path alone. ``forward`` returns ``(out, aux)``, the
    router's load-balance loss ``coef E sum_e mean(P_e) frac_e`` riding
    the return value, so it crosses a recompute boundary; it is also
    kept as ``self.aux_loss``."""

    def __init__(self, config):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        e = config.num_local_experts
        self.num_experts = e
        self.top_k = config.num_experts_per_tok
        self.capacity_factor = config.moe_capacity_factor
        self.aux_coef = config.router_aux_loss_coef
        self.gate = Linear(h, e, weight_attr=Normal(
            0.0, config.initializer_range), bias_attr=False)
        self.w_gate = self.create_parameter(
            [e, h, m], default_initializer=XavierUniform())
        self.w_up = self.create_parameter(
            [e, h, m], default_initializer=XavierUniform())
        self.w_down = self.create_parameter(
            [e, m, h], default_initializer=XavierUniform())
        self.aux_loss = None

    def forward(self, x):
        shape = x.shape
        d = shape[-1]
        s = math.prod(shape[:-1])
        e, k = self.num_experts, self.top_k
        capacity = moe_capacity(s, e, k, self.capacity_factor)
        xa, gw, wg, wu, wd = amp.amp_cast_inputs(
            "mixtral_moe", [x, self.gate.weight, self.w_gate, self.w_up,
                            self.w_down])
        tok = xa.reshape(s, d)
        # the gate's weight is [E, h] here, [h, E] in the reference
        logits = tok.float() @ gw.float().T

        def experts(ein):                   # [E, C, h] -> [E, C, h]
            hidden = torch.nn.functional.silu(
                einsum("ecd,edm->ecm", ein, wg)) * einsum(
                "ecd,edm->ecm", ein, wu)
            return einsum("ecm,emd->ecd", hidden, wd)

        out, probs, frac = dispatch_combine(tok, logits, capacity, k,
                                            experts)
        aux = self.aux_coef * e * (probs.mean(0) * frac).sum()
        self.aux_loss = aux
        return out.reshape(shape).to(xa.dtype), aux


class MixtralDecoderLayer(Layer):
    def __init__(self, config):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        # the reference's LlamaAttention draws its projections from
        # N(0, initializer_range); the port's Llama sets them in its own
        # reset_parameters
        for p in self.self_attn.parameters():
            p.initializer = Normal(0.0, config.initializer_range)
        self.block_sparse_moe = MixtralSparseMoeBlock(config)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, hidden, cos, sin, attn_mask=None, position_ids=None,
                cache=None):
        hidden = sites.add(hidden, self.self_attn(
            self.input_layernorm(hidden), cos, sin, attn_mask, position_ids,
            cache))
        moe_out, aux = self.block_sparse_moe(
            self.post_attention_layernorm(hidden))
        return sites.add(hidden, moe_out), aux


class MixtralModel(Layer):
    """``MixtralModel(config, device=None, seed=0)``: ids -> the final
    norm's hidden states; :meth:`aux_losses` gives the last forward's
    per-layer router losses (returned through any recompute boundary).
    The cache advances after the forward, but a :class:`SlotPagedKVCache`,
    whose ``end_step`` advances it."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.embed_tokens = Embedding(
                config.vocab_size, config.hidden_size,
                weight_attr=Normal(0.0, config.initializer_range))
            self.layers = LayerList([MixtralDecoderLayer(config)
                                     for _ in range(config.num_hidden_layers)])
            self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        dev = materialize(self, device, seed)
        if dev.type != "meta":
            self.init_rope(dev)
        self._aux_losses = []

    # one fp32 RoPE table pair for every layer, kept fp32 when the model
    # is cast: Llama's own
    init_rope = LlamaModel.init_rope
    _apply = LlamaModel._apply

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                cache=None):
        hidden = self.embed_tokens(input_ids)
        if cache is not None and position_ids is None:
            position_ids = torch.arange(cache.pos,
                                        cache.pos + input_ids.shape[1],
                                        device=input_ids.device)
        recompute = (self.config.use_recompute and self.training
                     and cache is None)
        auxes = []
        for layer in self.layers:
            if recompute:
                hidden, aux = checkpoint(
                    layer, hidden, self.rope_cos, self.rope_sin, attn_mask,
                    position_ids, use_reentrant=False,
                    context_fn=_amp_contexts)
            else:
                hidden, aux = layer(hidden, self.rope_cos, self.rope_sin,
                                    attn_mask, position_ids, cache)
            auxes.append(aux)
        self._aux_losses = auxes
        hidden = self.norm(hidden)
        if cache is not None and not isinstance(cache, SlotPagedKVCache):
            cache.advance(input_ids.shape[1])
        return hidden

    def aux_losses(self):
        return list(self._aux_losses)


class MixtralForCausalLM(GenerationMixin, Layer):
    """``forward(input_ids, labels=None, attn_mask=None, position_ids=None,
    cache=None)`` as ``LlamaForCausalLM``'s; with labels the loss is the
    causal-LM loss plus every layer's router aux loss."""

    supports_cache = True

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.mixtral = MixtralModel(config, device="meta")
            self.lm_head = (None if config.tie_word_embeddings else Linear(
                config.hidden_size, config.vocab_size,
                weight_attr=Normal(0.0, config.initializer_range),
                bias_attr=False))
        self.mixtral.init_rope(materialize(self, device, seed))
        self.criterion = LlamaPretrainingCriterion()

    @property
    def device(self):
        return self.mixtral.norm.weight.device

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None, cache=None):
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, dtype=torch.long,
                                           device=self.device)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=self.device)
        hidden = self.mixtral(input_ids, attn_mask, position_ids, cache)
        if self.lm_head is None:
            logits = sites.matmul_t(hidden, self.mixtral.embed_tokens.weight)
        else:
            logits = self.lm_head(hidden)
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        loss = self.criterion(logits, labels)
        for aux in self.mixtral.aux_losses():
            loss = sites.add(loss, aux)
        return loss, logits

    @staticmethod
    def sharding_rules():
        """Llama's rules, with the stacked expert weights sharded over the
        expert-parallel axis (``"dp"``) on dim 0 and the routers
        replicated. Data for the distributed package."""
        mp = "mp"
        return [
            (r"embed_tokens\.weight$", (mp, None)),
            (r"(q_proj|k_proj|v_proj)\.weight$", (None, mp)),
            (r"o_proj\.weight$", (mp, None)),
            (r"lm_head\.weight$", (None, mp)),
            (r"(w_gate|w_up|w_down)$", ("dp", None, None)),
            (r".*", ()),
        ]


__all__ = ["MixtralConfig", "MixtralModel", "MixtralForCausalLM",
           "MixtralSparseMoeBlock", "mixtral_8x7b", "mixtral_tiny"]
