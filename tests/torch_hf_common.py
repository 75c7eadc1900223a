"""Hugging Face checkpoint directories for the pretrained-loading parity
tests (``tests/test_torch_pretrained{,_zoo}.py``): HF-named tensors in
HF's layouts drawn from a numpy generator (Llama, GPT-2, BERT, T5), and
a writer of ``config.json`` plus safetensors shards (by the
``safetensors`` package) or ``pytorch_model.bin``. Not a test module (no
``test_`` prefix)."""
import json

import numpy as np
import torch
from safetensors.numpy import save_file as save_np
from safetensors.torch import save_file as save_torch


LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             rms_norm_eps=1e-5, rope_theta=10000.0)


def w(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def norm(rng, n):
    return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)


def llama_tensors(rng, tied=False, c=LLAMA):
    h, m = c["hidden_size"], c["intermediate_size"]
    d = h // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * d
    out = {"model.embed_tokens.weight": w(rng, c["vocab_size"], h, scale=1)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "self_attn.q_proj.weight": w(rng, h, h),
            p + "self_attn.k_proj.weight": w(rng, kv, h),
            p + "self_attn.v_proj.weight": w(rng, kv, h),
            p + "self_attn.o_proj.weight": w(rng, h, h),
            p + "self_attn.rotary_emb.inv_freq": w(rng, d // 2),
            p + "mlp.gate_proj.weight": w(rng, m, h),
            p + "mlp.up_proj.weight": w(rng, m, h),
            p + "mlp.down_proj.weight": w(rng, h, m),
            p + "input_layernorm.weight": norm(rng, h),
            p + "post_attention_layernorm.weight": norm(rng, h)})
    out["model.norm.weight"] = norm(rng, h)
    if not tied:
        out["lm_head.weight"] = w(rng, c["vocab_size"], h)
    return out


def gpt_tensors(rng, c):
    h, ff = c.hidden_size, c.intermediate_size
    out = {"transformer.wte.weight": w(rng, c.vocab_size, h, scale=0.5),
           "transformer.wpe.weight": w(rng, c.max_position_embeddings, h,
                                        scale=0.1)}
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        out.update({
            p + "ln_1.weight": norm(rng, h), p + "ln_1.bias": w(rng, h),
            p + "attn.c_attn.weight": w(rng, h, 3 * h),
            p + "attn.c_attn.bias": w(rng, 3 * h),
            p + "attn.c_proj.weight": w(rng, h, h),
            p + "attn.c_proj.bias": w(rng, h),
            p + "attn.bias": np.tril(np.ones((1, 1, 8, 8), np.float32)),
            p + "ln_2.weight": norm(rng, h), p + "ln_2.bias": w(rng, h),
            p + "mlp.c_fc.weight": w(rng, h, ff),
            p + "mlp.c_fc.bias": w(rng, ff),
            p + "mlp.c_proj.weight": w(rng, ff, h),
            p + "mlp.c_proj.bias": w(rng, h)})
    out["transformer.ln_f.weight"] = norm(rng, h)
    out["transformer.ln_f.bias"] = w(rng, h)
    return out


def bert_tensors(rng, c, pooler=True, tf_names=False):
    h, ff = c.hidden_size, c.intermediate_size
    g, b = ("gamma", "beta") if tf_names else ("weight", "bias")
    out = {"bert.embeddings.word_embeddings.weight":
           w(rng, c.vocab_size, h, scale=0.5),
           "bert.embeddings.position_embeddings.weight":
           w(rng, c.max_position_embeddings, h, scale=0.1),
           "bert.embeddings.token_type_embeddings.weight":
           w(rng, c.type_vocab_size, h, scale=0.1),
           f"bert.embeddings.LayerNorm.{g}": norm(rng, h),
           f"bert.embeddings.LayerNorm.{b}": w(rng, h),
           "bert.embeddings.position_ids":
           np.arange(c.max_position_embeddings, dtype=np.int64)[None]}
    for i in range(c.num_hidden_layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out[p + f"attention.self.{name}.weight"] = w(rng, h, h)
            out[p + f"attention.self.{name}.bias"] = w(rng, h)
        out.update({
            p + "attention.output.dense.weight": w(rng, h, h),
            p + "attention.output.dense.bias": w(rng, h),
            p + f"attention.output.LayerNorm.{g}": norm(rng, h),
            p + f"attention.output.LayerNorm.{b}": w(rng, h),
            p + "intermediate.dense.weight": w(rng, ff, h),
            p + "intermediate.dense.bias": w(rng, ff),
            p + "output.dense.weight": w(rng, h, ff),
            p + "output.dense.bias": w(rng, h),
            p + f"output.LayerNorm.{g}": norm(rng, h),
            p + f"output.LayerNorm.{b}": w(rng, h)})
    if pooler:
        out["bert.pooler.dense.weight"] = w(rng, h, h)
        out["bert.pooler.dense.bias"] = w(rng, h)
    out["cls.predictions.bias"] = w(rng, c.vocab_size)
    return out


def t5_tensors(rng, c):
    dm, inner, ff = c.d_model, c.num_heads * c.d_kv, c.d_ff
    gated = c.feed_forward_proj.startswith("gated")
    shared = w(rng, c.vocab_size, dm, scale=1)
    out = {"shared.weight": shared, "encoder.embed_tokens.weight": shared,
           "decoder.embed_tokens.weight": shared}
    for stack, n in (("encoder", c.num_layers),
                     ("decoder", c.num_decoder_layers)):
        for i in range(n):
            p = f"{stack}.block.{i}.layer."
            subs = [("0", "SelfAttention")]
            if stack == "decoder":
                subs.append(("1", "EncDecAttention"))
            for k, kind in subs:
                for x in "qkv":
                    out[f"{p}{k}.{kind}.{x}.weight"] = w(rng, inner, dm)
                out[f"{p}{k}.{kind}.o.weight"] = w(rng, dm, inner)
                out[f"{p}{k}.layer_norm.weight"] = norm(rng, dm)
            if i == 0:
                out[f"{p}0.SelfAttention.relative_attention_bias.weight"] = \
                    w(rng, c.relative_attention_num_buckets, c.num_heads,
                       scale=0.5)
            k = "2" if stack == "decoder" else "1"
            wis = ("wi_0", "wi_1") if gated else ("wi",)
            for wi in wis:
                out[f"{p}{k}.DenseReluDense.{wi}.weight"] = w(rng, ff, dm)
            out[f"{p}{k}.DenseReluDense.wo.weight"] = w(rng, dm, ff)
            out[f"{p}{k}.layer_norm.weight"] = norm(rng, dm)
        out[f"{stack}.final_layer_norm.weight"] = norm(rng, dm)
    if not c.tie_word_embeddings:
        out["lm_head.weight"] = w(rng, c.vocab_size, dm)
    return out


def write_dir(path, config, tensors, shards=1, fmt="safetensors",
              bf16=False):
    """An HF checkpoint directory: ``config.json`` and the tensors in
    ``shards`` safetensors files with an index (bf16 through torch), or
    one ``pytorch_model.bin``."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   path / "pytorch_model.bin")
        return path
    names = list(tensors)
    index = {}
    for s in range(shards):
        part = names[s::shards]
        fname = (f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
                 if shards > 1 else "model.safetensors")
        if bf16:
            save_torch({k: torch.from_numpy(tensors[k]).to(
                torch.bfloat16 if tensors[k].dtype == np.float32
                else torch.from_numpy(tensors[k]).dtype) for k in part},
                str(path / fname))
        else:
            save_np({k: tensors[k] for k in part}, str(path / fname))
        index.update({k: fname for k in part})
    if shards > 1:
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": index}))
    return path


def ids_of(b, s, seed=0, hi=128):
    return np.random.RandomState(seed).randint(2, hi, (b, s)).astype(
        np.int64)
