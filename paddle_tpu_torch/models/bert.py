"""BERT / ERNIE encoders (port of ``paddle_tpu/models/bert.py``; PaddleNLP's
``transformers/{bert,ernie}/modeling.py``): token, position and segment
embeddings, a post-LN :class:`~paddle_tpu_torch.nn.TransformerEncoder`
and a tanh pooler, with the sequence-classification and pretraining
(tied MLM decoder plus NSP) heads. ``Ernie*`` is BERT with ERNIE's
default sizes. The embeddings' LayerNorm takes ``layer_norm_eps``
(1e-12); the encoder layers keep the layer's default 1e-5, as the
reference's do (``bert.py:106-111`` passes no epsilon).

A ``[batch, seq]`` padding mask becomes the additive ``(1 - m) * -1e4``
over the keys, in fp32, so such a call takes SDPA's ``"sdpa"`` route;
without a mask, an eval forward of at least 128 tokens at head_dim 64
takes the flash route, non-causal (the kernel B1 on a CUDA tensor).

Every model constructor takes ``device=None`` (``"cuda"``; without CUDA
it raises unless given ``device="cpu"``) and ``seed=0``: the parameters
are drawn from a ``torch.Generator`` seeded with it, each by the
reference's initializer. Parameter names are the reference's, so
:func:`paddle_tpu_torch.convert.load_jax_state` carries weights across.
"""
from __future__ import annotations

import torch

from ..amp import sites
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import Layer
from ..nn.layers.common import Dropout, Embedding, Linear
from ..nn.layers.norm import LayerNorm
from ..nn.layers.transformer import (TransformerEncoder,
                                     TransformerEncoderLayer)
from ._seeded import materialize


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 num_labels=2, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.num_labels = num_labels
        for k, v in kwargs.items():
            setattr(self, k, v)


def bert_base(**kw):
    """BERT-base widths (``BASELINE.json`` configs[1])."""
    return BertConfig(**kw)


def bert_tiny(**kw):
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 128)
    return BertConfig(**kw)


class BertEmbeddings(Layer):
    def __init__(self, config):
        super().__init__()
        init = Normal(0.0, config.initializer_range)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, weight_attr=init)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, weight_attr=init)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        emb = sites.add(self.word_embeddings(input_ids),
                        self.position_embeddings(position_ids))
        if token_type_ids is None:
            # absent segment ids mean segment 0: its embedding is added
            token_type_ids = torch.zeros_like(input_ids)
        emb = sites.add(emb, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, config):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            weight_attr=Normal(0.0, config.initializer_range))

    def forward(self, hidden):
        return F.tanh(self.dense(sites.getitem(hidden, (slice(None), 0))))


def _tensor(x, device, dtype=None):
    return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                  device=device)


class _Model(Layer):
    """A model built on the meta device and materialised from a seed."""

    @property
    def device(self):
        return next(torch.nn.Module.parameters(self)).device


class BertModel(_Model):
    """``BertModel(config, device=None, seed=0)``; ``forward`` returns
    ``(sequence_output [b, s, h], pooled_output [b, h])``."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.embeddings = BertEmbeddings(config)
            enc_layer = TransformerEncoderLayer(
                config.hidden_size, config.num_attention_heads,
                config.intermediate_size, dropout=config.hidden_dropout_prob,
                activation=config.hidden_act,
                attn_dropout=config.attention_probs_dropout_prob,
                act_dropout=0.0, normalize_before=False)
            self.encoder = TransformerEncoder(enc_layer,
                                              config.num_hidden_layers)
            self.pooler = BertPooler(config)
        materialize(self, device, seed)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        dev = self.device
        input_ids = _tensor(input_ids, dev)
        token_type_ids = _tensor(token_type_ids, dev)
        position_ids = _tensor(position_ids, dev, torch.long)
        attention_mask = _tensor(attention_mask, dev)
        if attention_mask is not None and attention_mask.dim() == 2:
            # a [b, s] padding mask -> additive [b, 1, 1, s], in fp32
            attention_mask = ((1.0 - attention_mask.float()) * -1e4)[
                :, None, None, :]
        hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        hidden = self.encoder(hidden, attention_mask)
        return hidden, self.pooler(hidden)


class BertForSequenceClassification(_Model):
    """``forward(...)`` gives the logits ``[b, num_labels]``, or ``(loss,
    logits)`` with ``labels [b]``."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.bert = BertModel(config, device="meta")
            self.dropout = Dropout(config.hidden_dropout_prob)
            self.classifier = Linear(
                config.hidden_size, config.num_labels,
                weight_attr=Normal(0.0, config.initializer_range))
        materialize(self, device, seed)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        labels = _tensor(labels, logits.device, torch.long)
        return F.cross_entropy(logits, labels), logits


class BertForPretraining(_Model):
    """The MLM head (a transform, its LayerNorm and a decoder tied to the
    word embedding, plus ``mlm_bias``) and the NSP head. ``forward``
    gives ``(mlm_logits, nsp_logits)``, or ``(loss, mlm_logits,
    nsp_logits)`` with ``masked_lm_labels`` (-100 ignored) and optionally
    ``next_sentence_labels``."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.bert = BertModel(config, device="meta")
            init = Normal(0.0, config.initializer_range)
            self.transform = Linear(config.hidden_size, config.hidden_size,
                                    weight_attr=init)
            self.transform_norm = LayerNorm(config.hidden_size,
                                            config.layer_norm_eps)
            self.mlm_bias = self.create_parameter([config.vocab_size],
                                                  is_bias=True)
            self.nsp = Linear(config.hidden_size, 2, weight_attr=init)
        materialize(self, device, seed)

    def forward(self, input_ids, token_type_ids=None, masked_lm_labels=None,
                next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        mlm_logits = sites.add(
            sites.matmul_t(h, self.bert.embeddings.word_embeddings.weight),
            self.mlm_bias)
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is None:
            return mlm_logits, nsp_logits
        dev = mlm_logits.device
        labels = _tensor(masked_lm_labels, dev, torch.long)
        loss = F.cross_entropy(
            sites.reshape(mlm_logits, -1, mlm_logits.shape[-1]),
            sites.reshape(labels, -1), ignore_index=-100)
        if next_sentence_labels is not None:
            nsp = _tensor(next_sentence_labels, dev, torch.long)
            loss = sites.add(loss, F.cross_entropy(nsp_logits,
                                                   sites.reshape(nsp, -1)))
        return loss, mlm_logits, nsp_logits


class ErnieConfig(BertConfig):
    def __init__(self, **kwargs):
        kwargs.setdefault("vocab_size", 40000)
        kwargs.setdefault("type_vocab_size", 4)
        super().__init__(**kwargs)


class ErnieModel(BertModel):
    pass


class ErnieForSequenceClassification(BertForSequenceClassification):
    """BERT's classifier under ERNIE's name: ``ernie`` is ``bert``, one
    module under two attribute names. ``state_dict`` lists its tensors
    once, under ``bert.``, as the reference's does."""

    def __init__(self, config, device=None, seed=0):
        super().__init__(config, device, seed)
        self.ernie = self.bert


__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "bert_base", "bert_tiny"]
