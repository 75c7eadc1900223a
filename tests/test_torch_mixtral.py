"""The port's Mixtral (``paddle_tpu_torch/models/mixtral.py``) against the
reference's (``paddle_tpu/models/mixtral.py``) on shared weights, fp32,
CPU: logits, the loss with every layer's router aux loss, gradients,
recompute, layer 0's routing plan on captured hidden states (bit-equal
or a reported near-tie), the AMP dtype trace, and weight carry-over of
the stacked experts. Its serving paths are in
``tests/test_torch_mixtral_serving.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.models import mixtral as jmix

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.models import mixtral as tmix
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from torch_zoo_common import (  # noqa: F401
    arrays_of, close, close_grads, jax_amp_trace, jt, npy, one_torch_thread,
    torch_amp_trace)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def _pair(seed=0, **kw):
    kw.setdefault("max_position_embeddings", 128)
    paddle.seed(seed)
    jm = jmix.MixtralForCausalLM(jmix.mixtral_tiny(**kw))
    tm = tmix.MixtralForCausalLM(tmix.mixtral_tiny(**kw), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    jm, tm = _pair()
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int64)


def test_logits_and_loss_with_aux_match_reference(models):
    jm, tm = models
    ids, labels = _ids(2, 12), _ids(2, 12, seed=1)
    jloss, jlogits = jm(jt(ids), labels=jt(labels))
    tloss, tlogits = tm(ids, labels=labels)
    close(tlogits, jlogits, "logits")
    close(tloss, jloss, "loss with aux")
    jaux, taux = jm.mixtral.aux_losses(), tm.mixtral.aux_losses()
    assert len(taux) == len(jaux) == 2
    for i, (t, j) in enumerate(zip(taux, jaux)):
        close(t, j, f"layer {i} router aux loss")


@pytest.mark.parametrize("recompute", [False, True])
def test_training_grads_match_reference(recompute):
    """Train mode; with ``use_recompute`` the aux losses cross the
    recompute boundary as return values (both packages)."""
    jm, tm = _pair(seed=1, use_recompute=recompute)
    ids, labels = _ids(2, 10, seed=2), _ids(2, 10, seed=3)
    jloss, _ = jm(jt(ids), labels=jt(labels))
    tloss, _ = tm(ids, labels=labels)
    close(tloss, jloss, f"training loss, recompute={recompute}")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, f"Mixtral step, recompute={recompute}")


def test_routing_plan_on_captured_hidden_states(models):
    """Layer 0's router input captured in both packages; the plans
    bit-equal, or differing only at rows whose reference top-k and
    (k+1)-th probabilities are within two fp32 roundoffs."""
    jm, tm = models
    ids = _ids(2, 16, seed=4)
    jblock = jm.mixtral.layers[0].block_sparse_moe
    tblock = tm.mixtral.layers[0].block_sparse_moe
    seen = {}
    jfwd = type(jblock).forward

    def jcapture(self, x):
        seen.setdefault("jax", np.asarray(x._data))
        return jfwd(self, x)

    def tcapture(module, args):
        seen.setdefault("torch", args[0].detach().numpy())

    handle = tblock.register_forward_pre_hook(tcapture)
    type(jblock).forward = jcapture
    try:
        jm(jt(ids))
        tm(ids)
    finally:
        type(jblock).forward = jfwd
        handle.remove()
    close(seen["torch"], seen["jax"], "layer 0 router input")
    h = seen["jax"].reshape(-1, 64)
    s, e, k = h.shape[0], tblock.num_experts, tblock.top_k
    cap = tmoe.moe_capacity(s, e, k, tblock.capacity_factor)
    jw = np.asarray(arrays_of(jm)[
        "mixtral.layers.0.block_sparse_moe.gate.weight"])
    jp, jd, _ = (np.asarray(a) for a in jmoe.plan_dispatch(
        jnp.asarray(h) @ jnp.asarray(jw), cap, k))
    logits = torch.from_numpy(h) @ tblock.gate.weight.detach().T
    _, td, _ = tmoe.plan_dispatch(logits, cap, k)
    srt = np.sort(jp, -1)[:, ::-1]
    for r in np.nonzero((npy(td) != jd).any((1, 2)))[0]:
        gap = srt[r, k - 1] - srt[r, k]
        assert gap <= 2 * 2.0 ** -24 * srt[r, 0], (r, gap)


def test_amp_dtype_trace_matches_reference(monkeypatch):
    """Under O2 bf16, op by op: ``mixtral_moe`` casts its five tensors as
    the reference's apply does (it is on neither AMP list)."""
    jm, tm = _pair(seed=2)
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    ids = _ids(2, 8, seed=6)

    def jrun():
        with jamp.auto_cast(level="O2", dtype="bfloat16"):
            return jm(jt(ids), labels=jt(ids))[0]

    def trun():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return tm(ids, labels=ids)[0]
    _, trace = jax_amp_trace(jrun, monkeypatch)
    loss, ttrace = torch_amp_trace(trun)
    assert ttrace == trace
    assert ("mixtral_moe", ("float32",) + ("bfloat16",) * 4,
            ("bfloat16",) * 5) in ttrace
    assert torch.isfinite(loss)


def test_weights_round_trip_and_sharding_rules(models):
    jm, tm = models
    arrays = arrays_of(jm)
    assert list(tm.state_dict()) == list(arrays)
    w = "mixtral.layers.0.block_sparse_moe.w_gate"
    assert arrays[w].shape == tuple(tm.state_dict()[w].shape) == (4, 64, 96)
    back = pt.jax_layout(tm)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert tmix.MixtralForCausalLM.sharding_rules() == \
        jmix.MixtralForCausalLM.sharding_rules()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmix.MixtralForCausalLM(tmix.mixtral_tiny())
