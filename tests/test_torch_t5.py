"""The port's T5 (``paddle_tpu_torch/models/t5.py``) against the
reference's (``paddle_tpu/models/t5.py``) on shared weights, fp32, CPU:
the relative-position buckets, logits, loss and gradients of the tied
ReLU and the untied gated-GeLU variants, greedy ``generate`` under the
near-tie rule (ROADMAP C29), and weight carry-over with one bias table a
stack."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd.tape import no_grad as jno_grad
from paddle_tpu.models import t5 as jt5

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import t5 as tt5
from torch_zoo_common import (arrays_of, assert_stream, close,  # noqa: F401
                              close_grads, close_to_scale, jt, npy,
                              one_torch_thread)
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def _pair(seed=0, **kw):
    paddle.seed(seed)
    jm = jt5.T5ForConditionalGeneration(jt5.t5_tiny(**kw))
    tm = tt5.T5ForConditionalGeneration(tt5.t5_tiny(**kw), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    return jm, tm


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(2, 128, (b, s)).astype(
        np.int64)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_equal_the_reference(bidirectional):
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    for buckets, dist in ((32, 128), (16, 20), (8, 7)):
        np.testing.assert_array_equal(
            tt5._relative_bucket(rel, bidirectional, buckets, dist),
            jt5._relative_bucket(rel, bidirectional, buckets, dist))


@pytest.mark.parametrize("variant", ["tied-relu", "untied-gated-gelu"])
def test_logits_loss_and_grads_match_reference(variant):
    """The tied ReLU variant element by element at ``rtol = atol = 1e-5``.
    The untied gated-GeLU variant within 1e-5 of each tensor's largest
    magnitude (ROADMAP C38): the tanh GeLU rounds differently in XLA and
    torch on a third of its inputs (one ulp), the gate multiplies that
    on, and the untied head, drawn from N(0, 1) by the reference's
    ``initializer_factor``, gives logits of ~30 whose elements near zero
    carry that scale's rounding (measured 2.4e-6 of the largest logit,
    7.8e-6 of a gradient's largest)."""
    kw = dict(dropout_rate=0.0)
    check = close
    if variant == "untied-gated-gelu":
        kw.update(feed_forward_proj="gated-gelu", tie_word_embeddings=False)
        check = close_to_scale
    jm, tm = _pair(seed=1, **kw)
    src, labels = _ids(2, 9, seed=1), _ids(2, 6, seed=2)
    labels[1, 4:] = -100                  # ignored: shifted in as pad ids
    jloss, jlogits = jm(jt(src), labels=jt(labels))
    tloss, tlogits = tm(src, labels=labels)
    check(tlogits, jlogits, f"{variant} logits")
    close(tloss, jloss, f"{variant} loss")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, variant, check)


def test_generate_matches_reference():
    jm, tm = _pair(seed=2)
    src = _ids(2, 7, seed=3)
    with jno_grad():
        want = np.asarray(jm.generate(jt(src), max_new_tokens=6,
                                      eos_token_id=-1)._data)
    got = tm.generate(src, max_new_tokens=6, eos_token_id=-1)
    assert got.dtype == torch.int64 and got.shape == want.shape == (2, 7)

    def ref_logits(row, prefix):
        dec = np.concatenate([[0], prefix])[None]
        with jno_grad():
            return np.asarray(jm(jt(src[row:row + 1]),
                                 decoder_input_ids=jt(dec))._data)[0, -1]

    assert_stream(got[:, 1:], want[:, 1:], ref_logits, "T5 generate")
    # the decoder's cached steps give the logits of a whole forward
    tm.eval()
    with torch.no_grad():
        full = tm(src, decoder_input_ids=got[:, :-1])
    np.testing.assert_array_equal(npy(full.argmax(-1)), npy(got[:, 1:]))


def test_weights_round_trip_with_one_bias_table_a_stack():
    jm, tm = _pair(seed=3)
    arrays = arrays_of(jm)
    assert list(tm.state_dict()) == list(arrays)
    tables = [k for k in arrays if "relative_attention_bias" in k]
    assert tables == ["encoder.blocks.0.self_attn.relative_attention_bias"
                      ".weight", "decoder.blocks.0.self_attn."
                      "relative_attention_bias.weight"]
    back = pt.jax_layout(tm)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert tt5.T5Config().d_model == 512 and tt5.T5Config().num_heads == 8
