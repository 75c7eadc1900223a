"""Hugging Face GPT-2, BERT and T5 checkpoints through the port's
``models/pretrained.py`` against the reference's, on the same local
directories (``tests/torch_hf_common.py``): GPT-2's ``Conv1D`` layout,
BERT with and without its pooler and with TF's ``gamma`` / ``beta``
names, T5 tied ReLU and untied gated-GeLU. Outputs agree at ``rtol =
atol = 1e-5``, T5's untied gated-GeLU variant within 1e-5 of the largest
logit (ROADMAP C38)."""
import warnings

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import pretrained as jpre
from paddle_tpu.models import t5 as jt5

from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import pretrained as tpre
from paddle_tpu_torch.models import t5 as tt5
from torch_hf_common import (bert_tensors, gpt_tensors, ids_of, t5_tensors,
                             write_dir)
from torch_zoo_common import (close, close_to_scale, jt, npy,  # noqa: F401
                              one_torch_thread)
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def test_gpt2_conv1d_layout(tmp_path):
    cfg = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=256,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    tensors = gpt_tensors(np.random.default_rng(4), tgpt.GPTConfig(**cfg))
    d = write_dir(tmp_path / "gpt2", {"model_type": "gpt2"}, tensors)
    paddle.seed(0)
    jm = jpre.load_gpt_from_hf(jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg)),
                               str(d))
    tm = tpre.load_gpt_from_hf(
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu"), str(d))
    # Conv1D's [in, out] is transposed into the port's [out, in] Linear
    np.testing.assert_array_equal(
        npy(tm.gpt.decoder[0].self_attn.out_proj.weight),
        tensors["transformer.h.0.attn.c_proj.weight"].T)
    jm.eval()
    tm.eval()
    ids = ids_of(2, 10, seed=4)
    close(tm(ids), jm(jt(ids)), "GPT-2 logits")


@pytest.mark.parametrize("variant", ["pooler", "no-pooler", "tf-names"])
def test_bert_matches_reference(tmp_path, variant):
    tensors = bert_tensors(np.random.default_rng(5), tbert.bert_tiny(),
                           pooler=variant != "no-pooler",
                           tf_names=variant == "tf-names")
    d = write_dir(tmp_path / variant, {"model_type": "bert",
                                       "vocab_size": 128,
                                       "hidden_size": 64,
                                       "num_hidden_layers": 2,
                                       "num_attention_heads": 4,
                                       "intermediate_size": 128,
                                       "max_position_embeddings": 128},
                  tensors)
    kw = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg = jpre.bert_config_from_hf(str(d), **kw)
    tcfg = tpre.bert_config_from_hf(str(d), **kw)
    assert vars(tcfg) == vars(jcfg)
    paddle.seed(0)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jm = jpre.load_bert_from_hf(jbert.BertModel(jcfg), str(d))
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        tm = tpre.load_bert_from_hf(tbert.BertModel(tcfg, device="cpu"),
                                    str(d))
    warned = [[w for w in ws if issubclass(w.category, RuntimeWarning)
               and "pooler" in str(w.message)] for ws in (wj, wt)]
    assert bool(warned[0]) == bool(warned[1]) == (variant == "no-pooler")
    jm.eval()
    tm.eval()
    ids = ids_of(2, 12, seed=5)
    jseq, jpool = jm(jt(ids))
    tseq, tpool = tm(ids)
    close(tseq, jseq, f"BERT {variant} sequence output")
    if variant != "no-pooler":       # the pooler's seeded draws differ
        close(tpool, jpool, f"BERT {variant} pooled output")


@pytest.mark.parametrize("variant", ["tied-relu", "untied-gated-gelu"])
def test_t5_from_pretrained_matches_reference(tmp_path, variant):
    kw = dict(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2,
              num_heads=4, dropout_rate=0.0)
    check = close
    if variant == "untied-gated-gelu":
        kw.update(feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                  num_decoder_layers=3)
        check = close_to_scale
    tensors = t5_tensors(np.random.default_rng(6), tt5.T5Config(**kw))
    d = write_dir(tmp_path / variant, dict(kw, model_type="t5"), tensors)
    jm = jt5.T5ForConditionalGeneration.from_pretrained(str(d))
    tm = tt5.T5ForConditionalGeneration.from_pretrained(str(d),
                                                        device="cpu")
    assert (tm.lm_head is None) == (variant == "tied-relu")
    src, dec = ids_of(2, 9, seed=6), ids_of(2, 5, seed=7)
    check(tm(src, decoder_input_ids=dec),
          jm(jt(src), decoder_input_ids=jt(dec)), f"T5 {variant} logits")
