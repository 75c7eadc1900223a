"""GPT causal LM (port of ``paddle_tpu/models/gpt.py``; PaddleNLP's GPT
``modeling.py``): learned positions, pre-LN blocks with a fused QKV
projection and a tanh-approximate GeLU MLP, and a head tied to the word
embedding.

Attention goes through the cache when there is one (``cache.attend``:
the concat cache's SDPA, the paged decode kernel B4, the ragged kernels
6 and 8 under the continuous engine), else through causal SDPA (the
flash kernels B1-B3 on a CUDA tensor at 128 or more queries, no active
dropout, head_dim 64 or 128). GPT has no rope, so k keeps the model's
dtype and the KV pools take it: a bf16 GPT serves on bf16 pages, with
or without AMP. Attention dropout (``attention_probs_dropout_prob``,
0.1 by default) sends a training call down SDPA's ``"sdpa"`` route with
the port's generator of the device; set it and ``hidden_dropout_prob``
to 0.0 to train on the flash kernels.

``GPTForCausalLM(config, device=None, seed=0)``: ``device=None`` means
``"cuda"`` and raises where CUDA is absent; the parameters are drawn from
a ``torch.Generator`` seeded with ``seed``, each by the reference's
initializer. The reference's pipeline description (``build_gpt_pipe``,
``GPTForCausalLMPipe`` and its stages) needs the pipeline layers of the
distributed package, which the port does not have yet.
"""
from __future__ import annotations

import torch

from ..amp import sites
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import Layer, LayerList
from ..nn.layers.common import Dropout, Embedding, Linear
from ..nn.layers.norm import LayerNorm
from ._seeded import materialize
from .generation import (GenerationMixin, SlotPagedKVCache,
                         dropout_generator)
from .llama import LlamaPretrainingCriterion


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_recompute=False, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute
        for k, v in kwargs.items():
            setattr(self, k, v)


def gpt3_1p3b(**kw):
    """GPT-3 1.3B (``BASELINE.json`` configs[3]): 24 layers, hidden 2048,
    16 heads of 128."""
    return GPTConfig(vocab_size=50304, hidden_size=2048,
                     num_hidden_layers=24, num_attention_heads=16,
                     max_position_embeddings=2048, **kw)


def gpt_tiny(**kw):
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("max_position_embeddings", 128)
    return GPTConfig(**kw)


class GPTAttention(Layer):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        init = Normal(0.0, config.initializer_range)
        self.qkv_proj = Linear(h, 3 * h, weight_attr=init)
        self.out_proj = Linear(h, h, weight_attr=init)
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, hidden, cache=None):
        b, s, h = hidden.shape
        qkv = sites.reshape(self.qkv_proj(hidden), b, s, 3, self.num_heads,
                            self.head_dim)
        q, k, v = (sites.getitem(qkv, (slice(None), slice(None), i))
                   for i in range(3))
        if cache is not None:
            out = cache.attend(self, q, k, v, training=self.training,
                               dropout_p=self.dropout_p)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout_p,
                training=self.training, generator=dropout_generator(
                    self.dropout_p, self.training, q.device))
        return self.out_proj(sites.reshape(out, b, s, h))


class GPTDecoderLayer(Layer):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        init = Normal(0.0, config.initializer_range)
        self.norm1 = LayerNorm(h, config.layer_norm_epsilon)
        self.self_attn = GPTAttention(config)
        self.norm2 = LayerNorm(h, config.layer_norm_epsilon)
        self.linear1 = Linear(h, config.intermediate_size, weight_attr=init)
        self.linear2 = Linear(config.intermediate_size, h, weight_attr=init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, hidden, cache=None):
        hidden = sites.add(hidden, self.dropout(
            self.self_attn(self.norm1(hidden), cache)))
        ff = self.linear2(F.gelu(self.linear1(self.norm2(hidden)),
                                 approximate=True))
        return sites.add(hidden, self.dropout(ff))


class GPTEmbeddings(Layer):
    def __init__(self, config):
        super().__init__()
        init = Normal(0.0, config.initializer_range)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, weight_attr=init)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        return self.dropout(sites.add(self.word_embeddings(input_ids),
                                      self.position_embeddings(position_ids)))


class GPTModel(Layer):
    """``GPTModel(config, device=None, seed=0)``: ids -> the final
    LayerNorm's hidden states. With a cache and no positions they start
    at ``cache.pos``; the cache advances after the forward, but a
    :class:`SlotPagedKVCache`, whose ``end_step`` advances it."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.embeddings = GPTEmbeddings(config)
            self.decoder = LayerList([
                GPTDecoderLayer(config)
                for _ in range(config.num_hidden_layers)])
            self.final_norm = LayerNorm(config.hidden_size,
                                        config.layer_norm_epsilon)
        materialize(self, device, seed)

    def forward(self, input_ids, position_ids=None, cache=None):
        if cache is not None and position_ids is None:
            position_ids = torch.arange(cache.pos,
                                        cache.pos + input_ids.shape[1],
                                        device=input_ids.device)
        hidden = self.embeddings(input_ids, position_ids)
        for layer in self.decoder:
            hidden = layer(hidden, cache)
        hidden = self.final_norm(hidden)
        if cache is not None and not isinstance(cache, SlotPagedKVCache):
            cache.advance(input_ids.shape[1])
        return hidden


class GPTForCausalLM(GenerationMixin, Layer):
    """The tied head: logits are the hidden states times the word
    embedding's weight (the reference's op ``"matmul"``). ``generate``
    comes from :class:`GenerationMixin`; the continuous engine serves it
    as it serves Llama."""

    supports_cache = True

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config, device="meta")
        materialize(self, device, seed)
        self.criterion = LlamaPretrainingCriterion()

    @property
    def device(self):
        return self.gpt.final_norm.weight.device

    def forward(self, input_ids, labels=None, position_ids=None,
                cache=None):
        """``input_ids [batch, seq]`` (a tensor or an array) -> logits
        ``[batch, seq, vocab]``, or ``(loss, logits)`` with ``labels``
        (already shifted; -100 ignored)."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, dtype=torch.long,
                                           device=self.device)
        hidden = self.gpt(input_ids, position_ids, cache)
        logits = sites.matmul_t(hidden,
                                self.gpt.embeddings.word_embeddings.weight)
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        return self.criterion(logits, labels), logits

    @staticmethod
    def sharding_rules():
        """``(parameter-name regex, partition spec)`` over the hybrid
        mesh's axes, the reference's: Megatron column-parallel QKV and
        ``linear1``, row-parallel ``out_proj`` and ``linear2``, a
        vocab-parallel embedding. Data for the distributed package."""
        mp = "mp"
        return [
            (r"word_embeddings\.weight$", (mp, None)),
            (r"qkv_proj\.weight$", (None, mp)),
            (r"qkv_proj\.bias$", (mp,)),
            (r"out_proj\.weight$", (mp, None)),
            (r"linear1\.weight$", (None, mp)),
            (r"linear1\.bias$", (mp,)),
            (r"linear2\.weight$", (mp, None)),
            (r".*", ()),
        ]


__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt3_1p3b",
           "gpt_tiny"]
