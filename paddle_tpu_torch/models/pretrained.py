"""Hugging Face checkpoints from a local directory (port of
``paddle_tpu/models/pretrained.py``): ``config.json`` plus
``*.safetensors`` shards (with or without ``model.safetensors.index.json``)
or ``pytorch_model*.bin``, into Llama, GPT (the GPT-2 layout), BERT and T5.
Nothing is downloaded.

The names map as the reference maps them, and so do its errors: a model
parameter the checkpoint leaves unmapped raises ``ValueError`` (BERT's
optional ``pooler.`` only warns), so does a shape that does not fit, and
a directory without weights raises ``IOError``. Each tensor is rounded
to ``dtype`` (as the reference's ``astype``) and copied into its
parameter, which keeps its own dtype and device.

Layouts: the reference stores a ``Linear`` weight ``[in, out]`` and
transposes every HF ``[out, in]`` projection on load; the port's Linears
are ``[out, in]`` already (:mod:`paddle_tpu_torch.convert`), so a tensor
is transposed here exactly when the reference's rule and the port's
Linear layout disagree: HF Linears pass through, GPT-2's ``Conv1D``
weights (``[in, out]`` in HF) are transposed.

Safetensors are read without the ``safetensors`` package: an 8-byte
little-endian header length, a JSON header ``{name: {dtype, shape,
data_offsets}}`` (and ``__metadata__``), then the raw little-endian
bytes, memory-mapped and viewed with ``torch.frombuffer`` (bf16 needs no
numpy). Every shape is checked against the header before any parameter
is written, and then one tensor at a time goes to its parameter's
device, so host memory holds about one tensor, not the checkpoint.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
import warnings

import torch

from ..convert import _linear_weights
from ..framework.dtype import convert_dtype

__all__ = ["load_hf_config", "llama_config_from_hf", "bert_config_from_hf",
           "t5_config_from_hf", "load_llama_from_hf", "load_gpt_from_hf",
           "load_bert_from_hf", "load_t5_from_hf"]

#: safetensors dtype codes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
             "F16": torch.float16, "BF16": torch.bfloat16,
             "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
             "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


class _Entry:
    """One checkpoint tensor: its shape, and its values on demand."""

    __slots__ = ("shape", "_load")

    def __init__(self, shape, load):
        self.shape = tuple(shape)
        self._load = load

    def load(self):
        return self._load()


def _safetensors_entries(path):
    """``{name: _Entry}`` of one safetensors file, its data memory-mapped
    (copy-on-write, so ``torch.frombuffer`` gets a writable buffer)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if os.path.getsize(path) > 8 + n else None)
    start = 8 + n
    out = {}
    for name, rec in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(rec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {rec['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        lo, hi = rec["data_offsets"]
        shape = tuple(rec["shape"])

        def load(dtype=dtype, lo=lo, hi=hi, shape=shape):
            if hi == lo:
                return torch.empty(shape, dtype=dtype)
            count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
            return torch.frombuffer(buf, dtype=dtype, count=count,
                                    offset=start + lo).reshape(shape)

        out[name] = _Entry(shape, load)
    return out


def _read_hf_weights(model_dir):
    """``{name: _Entry}`` of every tensor: the safetensors shards in
    sorted file order, else the ``pytorch_model*.bin`` files (read with
    ``weights_only=True``); a later file's tensor replaces an earlier one
    of the same name, as in the reference's dict."""
    entries = {}
    st_files = sorted(f for f in os.listdir(model_dir)
                      if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            part = _safetensors_entries(os.path.join(model_dir, fname))
            for k in sorted(part):
                entries[k] = part[k]
        return entries
    bin_files = sorted(f for f in os.listdir(model_dir)
                       if f.startswith("pytorch_model")
                       and f.endswith(".bin"))
    if bin_files:
        for fname in bin_files:
            sd = torch.load(os.path.join(model_dir, fname),
                            map_location="cpu", weights_only=True,
                            mmap=True)
            for k, v in sd.items():
                entries[k] = _Entry(v.shape, lambda v=v: v)
        return entries
    raise IOError(f"no model.safetensors / pytorch_model*.bin under "
                  f"{model_dir}")


def load_hf_config(model_dir):
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _strip_prefix(name, prefixes):
    for p in prefixes:
        if name.startswith(p):
            return name[len(p):]
    return name


def _check_fully_mapped(own, mapped, arch, optional=()):
    """Every parameter must come from the checkpoint: an unmapped one
    would keep its seeded values. ``optional`` prefixes (BERT's pooler,
    absent from MLM-only exports) only warn, as HF's own loader does."""
    missing = [k for k in own if k not in mapped]
    soft = [k for k in missing if any(k.startswith(p) for p in optional)]
    hard = [k for k in missing if k not in soft]
    if hard:
        raise ValueError(
            f"{arch} checkpoint left parameters unmapped (their seeded "
            f"values would stay): {hard[:8]}")
    if soft:
        warnings.warn(f"{arch} checkpoint omits optional parameters "
                      f"(left as initialized): {soft[:8]}", RuntimeWarning,
                      stacklevel=3)


def _fill(model, plan, dtype, arch, optional=()):
    """Copy ``plan`` (``{target: (entry, transposed_by_reference)}``) into
    ``model``: each tensor in the port's layout (transposed where the
    reference's rule and the port's Linear layout disagree), shape
    checked against the header first, then rounded to ``dtype`` and
    copied into its parameter. Returns ``model``."""
    own = model.state_dict()
    linear = _linear_weights(model)
    moves = []
    for tgt, (entry, ref_t) in plan.items():
        flip = ref_t != (tgt in linear)
        shape = entry.shape[::-1] if flip else entry.shape
        if shape != tuple(own[tgt].shape):
            raise ValueError(
                f"shape mismatch for {tgt}: checkpoint {entry.shape} does "
                f"not fit the model's {tuple(own[tgt].shape)}")
        moves.append((tgt, entry, flip))
    _check_fully_mapped(own, plan, arch, optional)
    dt = convert_dtype(dtype)
    with torch.no_grad():
        for tgt, entry, flip in moves:
            dst = own[tgt]
            src = entry.load()
            src = (src.T if flip else src).to(dst.device)
            if src.dtype != dt:
                src = src.to(dt)
            dst.copy_(src)
    return model


def load_llama_from_hf(model, model_dir, dtype="float32"):
    """Fill a ``LlamaForCausalLM`` from an HF Llama checkpoint directory.
    A tied model takes no ``lm_head`` (its head is the embedding)."""
    own = model.state_dict()
    plan = {}
    for name, entry in _read_hf_weights(model_dir).items():
        n = _strip_prefix(name, ("model.",))
        if n.startswith("layers.") or n in ("embed_tokens.weight",
                                            "norm.weight"):
            tgt = "llama." + n
        elif name == "lm_head.weight":
            tgt = "lm_head.weight"
        else:
            continue          # rotary inv_freq buffers and the like
        if tgt not in own:
            continue
        plan[tgt] = (entry, len(entry.shape) == 2
                     and tgt != "llama.embed_tokens.weight")
    return _fill(model, plan, dtype, "Llama")


def llama_config_from_hf(model_dir, **overrides):
    from .llama import LlamaConfig
    cfg = load_hf_config(model_dir)
    fields = dict(
        vocab_size=cfg.get("vocab_size", 32000),
        hidden_size=cfg.get("hidden_size", 4096),
        intermediate_size=cfg.get("intermediate_size", 11008),
        num_hidden_layers=cfg.get("num_hidden_layers", 32),
        num_attention_heads=cfg.get("num_attention_heads", 32),
        num_key_value_heads=cfg.get("num_key_value_heads"),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
    )
    fields.update(overrides)
    return LlamaConfig(**fields)


_GPT_BLOCK = ((".attn.c_attn.", ".self_attn.qkv_proj."),
              (".attn.c_proj.", ".self_attn.out_proj."),
              (".mlp.c_fc.", ".linear1."), (".mlp.c_proj.", ".linear2."),
              (".ln_1.", ".norm1."), (".ln_2.", ".norm2."))


def load_gpt_from_hf(model, model_dir, dtype="float32"):
    """Fill a ``GPTForCausalLM`` from an HF GPT-2 checkpoint directory.
    GPT-2's ``Conv1D`` weights are ``[in, out]`` in HF, the reference's
    layout, so they are transposed into the port's Linears; only a true
    HF Linear (``lm_head``) would pass through."""
    own = model.state_dict()
    plan = {}
    for name, entry in _read_hf_weights(model_dir).items():
        n = _strip_prefix(name, ("transformer.",))
        tgt = None
        if n == "wte.weight":
            tgt = "gpt.embeddings.word_embeddings.weight"
        elif n == "wpe.weight":
            tgt = "gpt.embeddings.position_embeddings.weight"
        elif n.startswith("ln_f."):
            tgt = "gpt.final_norm." + n[len("ln_f."):]
        elif n.startswith("h."):
            tgt = "gpt.decoder." + n[2:]
            for hf, ours in _GPT_BLOCK:
                tgt = tgt.replace(hf, ours)
        elif name == "lm_head.weight":
            tgt = "lm_head.weight"
        if tgt is None or tgt not in own:
            continue
        plan[tgt] = (entry, tgt == "lm_head.weight"
                     and len(entry.shape) == 2)
    return _fill(model, plan, dtype, "GPT")


def bert_config_from_hf(model_dir, **overrides):
    from .bert import BertConfig
    cfg = load_hf_config(model_dir)
    fields = dict(
        vocab_size=cfg.get("vocab_size", 30522),
        hidden_size=cfg.get("hidden_size", 768),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size", 3072),
        hidden_act=cfg.get("hidden_act", "gelu"),
        hidden_dropout_prob=cfg.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=cfg.get(
            "attention_probs_dropout_prob", 0.1),
        max_position_embeddings=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
    )
    fields.update(overrides)
    return BertConfig(**fields)


_BERT_LAYER = ((".attention.self.query.", ".self_attn.q_proj."),
               (".attention.self.key.", ".self_attn.k_proj."),
               (".attention.self.value.", ".self_attn.v_proj."),
               (".attention.output.dense.", ".self_attn.out_proj."),
               (".attention.output.LayerNorm.", ".norm1."),
               (".intermediate.dense.", ".linear1."),
               (".output.dense.", ".linear2."),
               (".output.LayerNorm.", ".norm2."))
_BERT_TABLES = ("word_embeddings", "position_embeddings",
                "token_type_embeddings")


def load_bert_from_hf(model, model_dir, dtype="float32"):
    """Fill a ``BertModel`` from an HF BERT checkpoint directory (post-LN
    names: ``attention.output.LayerNorm`` is ``norm1``,
    ``output.LayerNorm`` ``norm2``; old TF exports' ``LayerNorm.gamma`` /
    ``beta`` are read as ``weight`` / ``bias``). A checkpoint without the
    pooler only warns."""
    own = model.state_dict()
    plan = {}
    for name, entry in _read_hf_weights(model_dir).items():
        n = _strip_prefix(name, ("bert.",))
        n = n.replace(".LayerNorm.gamma", ".LayerNorm.weight") \
             .replace(".LayerNorm.beta", ".LayerNorm.bias")
        tgt = None
        if n.startswith("embeddings."):
            tgt = n.replace(".LayerNorm.", ".layer_norm.")
        elif n.startswith("encoder.layer."):
            tgt = "encoder.layers." + n[len("encoder.layer."):]
            for hf, ours in _BERT_LAYER:
                tgt = tgt.replace(hf, ours)
        elif n.startswith("pooler.dense."):
            tgt = n
        if tgt is None or tgt not in own:
            continue
        plan[tgt] = (entry, len(entry.shape) == 2
                     and not any(t in tgt for t in _BERT_TABLES))
    return _fill(model, plan, dtype, "BERT", optional=("pooler.",))


def t5_config_from_hf(model_dir, **overrides):
    from .t5 import T5Config
    cfg = load_hf_config(model_dir)
    fields = dict(
        vocab_size=cfg.get("vocab_size", 32128),
        d_model=cfg.get("d_model", 512),
        d_kv=cfg.get("d_kv", 64),
        d_ff=cfg.get("d_ff", 2048),
        num_layers=cfg.get("num_layers", 6),
        num_decoder_layers=cfg.get("num_decoder_layers"),
        num_heads=cfg.get("num_heads", 8),
        relative_attention_num_buckets=cfg.get(
            "relative_attention_num_buckets", 32),
        relative_attention_max_distance=cfg.get(
            "relative_attention_max_distance", 128),
        dropout_rate=cfg.get("dropout_rate", 0.1),
        layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=cfg.get("feed_forward_proj", "relu"),
        pad_token_id=cfg.get("pad_token_id", 0),
        decoder_start_token_id=cfg.get("decoder_start_token_id", 0),
        eos_token_id=cfg.get("eos_token_id", 1),
        tie_word_embeddings=cfg.get("tie_word_embeddings", True),
    )
    fields.update(overrides)
    return T5Config(**fields)


def _t5_target(n):
    """The reference's name of HF T5 tensor ``n``: ``block.N.layer.K``,
    K=0 the self-attention, the decoder's K=1 the cross-attention, the
    last K the feed-forward."""
    tgt = n
    for stack, dec in (("encoder.", False), ("decoder.", True)):
        if not n.startswith(stack + "block."):
            continue
        parts = n.split(".")           # stack, block, N, layer, K, ...
        bi, k = parts[2], int(parts[4])
        rest = ".".join(parts[5:])
        if k == 0:
            rest = rest.replace("SelfAttention.", "self_attn.") \
                       .replace("layer_norm.", "norm1.")
        elif dec and k == 1:
            rest = rest.replace("EncDecAttention.", "cross_attn.") \
                       .replace("layer_norm.", "norm_cross.")
        elif k == (2 if dec else 1):
            rest = rest.replace("DenseReluDense.wi_0.", "ff.wi.") \
                       .replace("DenseReluDense.wi_1.", "ff.wi_1.") \
                       .replace("DenseReluDense.wi.", "ff.wi.") \
                       .replace("DenseReluDense.wo.", "ff.wo.") \
                       .replace("layer_norm.", "norm2.")
        tgt = f"{stack}blocks.{bi}.{rest}"
    return tgt.replace("encoder.final_layer_norm.", "encoder.final_norm.") \
              .replace("decoder.final_layer_norm.", "decoder.final_norm.")


def load_t5_from_hf(model, model_dir, dtype="float32"):
    """Fill a ``T5ForConditionalGeneration`` from an HF T5 checkpoint
    directory. The stacks' ``embed_tokens`` are tied copies of
    ``shared`` and are skipped; an untied (v1.1 / Flan) model takes the
    checkpoint's ``lm_head``."""
    own = model.state_dict()
    plan = {}
    for name, entry in _read_hf_weights(model_dir).items():
        if name in ("shared.weight", "encoder.embed_tokens.weight",
                    "decoder.embed_tokens.weight", "lm_head.weight"):
            if name == "lm_head.weight" and "lm_head.weight" in own:
                plan["lm_head.weight"] = (entry, True)
            elif name == "shared.weight":
                plan["shared.weight"] = (entry, False)
            continue
        tgt = _t5_target(name)
        if tgt not in own:
            continue
        plan[tgt] = (entry, len(entry.shape) == 2
                     and "relative_attention_bias" not in tgt
                     and tgt != "shared.weight")
    return _fill(model, plan, dtype, "T5")
