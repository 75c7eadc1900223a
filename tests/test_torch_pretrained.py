"""Hugging Face Llama checkpoints through the port's
``models/pretrained.py`` against the reference's
(``paddle_tpu/models/pretrained.py``): the same local directories,
written in the HF layout from a numpy seed (``tests/torch_hf_common.py``;
the safetensors files by the ``safetensors`` package, which the reference
reads with and the port does not), load into both packages, and the
logits agree at ``rtol = atol = 1e-5``: GQA, tied and untied heads, a
sharded directory with its index, ``pytorch_model.bin``, a bf16
checkpoint and ``dtype="bfloat16"``; the port's safetensors reader
against the package's, and the reference's errors and configs. GPT-2,
BERT and T5 are in ``tests/test_torch_pretrained_zoo.py``."""
import json

import numpy as np
import pytest
import torch
from safetensors.torch import save_file as save_torch

from paddle_tpu.models import llama as jllama
from paddle_tpu.models import pretrained as jpre

from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import pretrained as tpre
from torch_hf_common import LLAMA, ids_of, llama_tensors, w, write_dir
from torch_zoo_common import close, jt, npy, one_torch_thread  # noqa: F401
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def _hf_llama_config(tied):
    return dict(LLAMA, architectures=["LlamaForCausalLM"],
                tie_word_embeddings=tied)


def _llama_pair(d, dtype="float32"):
    jm = jllama.LlamaForCausalLM.from_pretrained(str(d), dtype=dtype)
    tm = tllama.LlamaForCausalLM.from_pretrained(str(d), dtype=dtype,
                                                 device="cpu")
    return jm, tm


@pytest.mark.parametrize("layout", ["untied", "tied", "sharded", "bin"])
def test_llama_logits_match_reference(tmp_path, layout):
    tied = layout == "tied"
    tensors = llama_tensors(np.random.default_rng(1), tied=tied)
    d = write_dir(tmp_path / layout, _hf_llama_config(tied), tensors,
                  shards=2 if layout == "sharded" else 1,
                  fmt="bin" if layout == "bin" else "safetensors")
    jm, tm = _llama_pair(d)
    assert (tm.lm_head is None) == tied
    # the port keeps HF's [out, in]: a square projection read straight
    np.testing.assert_array_equal(
        npy(tm.llama.layers[1].self_attn.q_proj.weight),
        tensors["model.layers.1.self_attn.q_proj.weight"])
    ids = ids_of(2, 11)
    close(tm(ids), jm(jt(ids)), f"Llama {layout} logits")


def test_llama_bf16_checkpoint_and_dtype(tmp_path):
    """A bf16 checkpoint gives fp32 parameters holding its values (torch's
    bf16 -> fp32), the reference's too; ``dtype="bfloat16"`` on an fp32
    checkpoint rounds each weight to bf16 in fp32 parameters, as the
    reference's ``astype`` does, and the logits agree."""
    tensors = llama_tensors(np.random.default_rng(2))
    d16 = write_dir(tmp_path / "bf16", _hf_llama_config(False), tensors,
                    bf16=True)
    jm, tm = _llama_pair(d16)
    want = torch.from_numpy(tensors["model.layers.0.mlp.up_proj.weight"]
                            ).bfloat16().float()
    got = tm.llama.layers[0].mlp.up_proj.weight
    assert got.dtype == torch.float32 and torch.equal(got, want)
    ids = ids_of(2, 9, seed=3)
    close(tm(ids), jm(jt(ids)), "Llama bf16-checkpoint logits")
    d32 = write_dir(tmp_path / "fp32", _hf_llama_config(False), tensors)
    jm, tm = _llama_pair(d32, dtype="bfloat16")
    for name, p in tm.state_dict().items():
        assert p.dtype == torch.float32
        assert torch.equal(p, p.bfloat16().float()), name
    jsd = jm.state_dict()
    for name, p in tm.named_parameters():
        assert str(jsd[name].dtype) == "float32"
    np.testing.assert_array_equal(
        npy(tm.llama.layers[0].mlp.up_proj.weight), want.numpy())
    close(tm(ids), jm(jt(ids)), "Llama dtype=bfloat16 logits")


def test_safetensors_reader_dtypes(tmp_path):
    """Every dtype the loader takes, read by the port's own reader
    against what the ``safetensors`` package wrote, bit for bit; bf16
    without numpy."""
    rng = np.random.default_rng(3)
    ts = {"f32": torch.from_numpy(w(rng, 3, 5)),
          "f16": torch.from_numpy(w(rng, 4)).half(),
          "bf16": torch.from_numpy(w(rng, 2, 3)).bfloat16(),
          "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "empty": torch.zeros(0, 4)}
    save_torch(ts, str(tmp_path / "x.safetensors"))
    got = tpre._read_hf_weights(str(tmp_path))
    assert sorted(got) == sorted(ts)
    for k, v in ts.items():
        t = got[k].load()
        assert got[k].shape == tuple(v.shape), k
        assert t.dtype == v.dtype and torch.equal(t, v), k


def _both_raise(exc, load_j, load_t):
    with pytest.raises(exc) as ej:
        load_j()
    with pytest.raises(exc) as et:
        load_t()
    return str(ej.value), str(et.value)


def test_errors_are_the_references(tmp_path):
    """An unmapped parameter and a shape that does not fit raise
    ``ValueError`` naming the parameter; a directory without weights
    raises ``IOError``; a failed load leaves the model as it was."""
    tensors = llama_tensors(np.random.default_rng(7))
    cfg = _hf_llama_config(False)
    dropped = dict(tensors)
    del dropped["model.layers.1.mlp.down_proj.weight"]
    d = write_dir(tmp_path / "unmapped", cfg, dropped)
    msgs = _both_raise(ValueError,
                       lambda: jllama.LlamaForCausalLM.from_pretrained(str(d)),
                       lambda: tllama.LlamaForCausalLM.from_pretrained(
                           str(d), device="cpu"))
    assert all("llama.layers.1.mlp.down_proj.weight" in m for m in msgs)
    bad = dict(tensors)
    bad["model.layers.0.self_attn.k_proj.weight"] = w(
        np.random.default_rng(8), 64, 64)
    d = write_dir(tmp_path / "shape", cfg, bad)
    msgs = _both_raise(ValueError,
                       lambda: jllama.LlamaForCausalLM.from_pretrained(str(d)),
                       lambda: tllama.LlamaForCausalLM.from_pretrained(
                           str(d), device="cpu"))
    assert all("shape mismatch for llama.layers.0.self_attn.k_proj.weight"
               in m for m in msgs)
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**LLAMA), device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with pytest.raises(ValueError):
        tpre.load_llama_from_hf(tm, str(d))
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(cfg))
    _both_raise(IOError,
                lambda: jllama.LlamaForCausalLM.from_pretrained(str(empty)),
                lambda: tllama.LlamaForCausalLM.from_pretrained(
                    str(empty), device="cpu"))


def test_configs_equal_the_references(tmp_path):
    d = tmp_path / "cfg"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        _hf_llama_config(True), rope_theta=500000.0, d_model=32, d_kv=8,
        num_layers=3, num_heads=4, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False)))
    for name in ("llama_config_from_hf", "t5_config_from_hf",
                 "bert_config_from_hf"):
        want = vars(getattr(jpre, name)(str(d), vocab_size=99))
        got = vars(getattr(tpre, name)(str(d), vocab_size=99))
        shared = sorted(set(want) & set(got))
        assert len(shared) >= 10, name
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}, \
            name
