"""The rest of the port's training surface against the JAX package:
``nn.clip_grad_norm_`` and ``nn.clip_grad_value_``, Llama with
``tie_word_embeddings``, and ``paddle.load`` / ``paddle.save``
(``framework/io.py``), on the CPU."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Parameter as JParameter, Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.nn import clip_grad as jclip
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.nn import clip_grad as tclip
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x,
                      dtype=np.float32)


# ---------------------------------------------------------------------------
# clip_grad_norm_ and clip_grad_value_
# ---------------------------------------------------------------------------

def _clip_pairs(dtype, seed):
    rng = np.random.RandomState(seed)
    gs = [(rng.randn(*s) * 0.7).astype(np.float32)
          for s in ((4, 5), (7,), (3, 3))]
    jps, tps = [], []
    for g in gs:
        jp = JParameter(jnp.zeros(g.shape, getattr(jnp, dtype)))
        jp.grad = Tensor(jnp.asarray(g, getattr(jnp, dtype)))
        tp = torch.nn.Parameter(torch.zeros(g.shape,
                                            dtype=getattr(torch, dtype)))
        tp.grad = torch.from_numpy(g).to(getattr(torch, dtype))
        jps.append(jp)
        tps.append(tp)
    # a parameter with no grad is passed over
    jps.append(JParameter(jnp.zeros(2)))
    tps.append(torch.nn.Parameter(torch.zeros(2)))
    return jps, tps


#: a clipped grad, relative: in fp32 the scales agree within 1e-6 (the
#: p-th powers and roots round differently: XLA's pow, PyTorch's); in
#: bf16 one ulp (the rounding of the product back to bf16 may differ)
CLIP_RTOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", [2.0, 1.0, 3.0, math.inf])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm_matches_reference(dtype, norm_type, max_norm):
    """The total within 1e-6 (relative; the same fp32 sums, or the same
    largest magnitude for inf), each clipped grad within one ulp of its
    dtype (the reference's inf-norm scale is in the grads' dtype, as the
    port's is)."""
    seed = {2.0: 2, 1.0: 1, 3.0: 3, math.inf: 5}[norm_type]
    jps, tps = _clip_pairs(dtype, seed)
    want = float(_np(jclip.clip_grad_norm_(jps, max_norm, norm_type)))
    got = tclip.clip_grad_norm_(tps, max_norm, norm_type)
    assert abs(float(got) - want) <= 1e-6 * want
    for jp, tp in zip(jps[:-1], tps[:-1]):
        assert tp.grad.dtype == getattr(torch, dtype)
        w = _np(jp.grad)
        assert np.all(np.abs(tp.grad.float().numpy() - w)
                      <= CLIP_RTOL[dtype] * np.abs(w))
    assert tps[-1].grad is None
    if max_norm > want:                     # no clipping: grads untouched
        for tp, orig in zip(tps[:-1], _clip_pairs(dtype, seed)[1][:-1]):
            assert torch.equal(tp.grad, orig.grad)


def test_clip_grad_norm_edge_cases():
    assert float(tclip.clip_grad_norm_([torch.nn.Parameter(torch.ones(2))],
                                       1.0)) == 0.0
    # a generator, as model.parameters() gives, and a single tensor
    ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(2)]
    for p in ps:
        p.grad = torch.full((3,), 2.0)
    total = tclip.clip_grad_norm_(iter(ps), 1.0)
    assert abs(float(total) - 24 ** 0.5) <= 1e-6 * 24 ** 0.5
    assert abs(float(torch.cat([p.grad for p in ps]).norm()) - 1.0) <= 1e-6
    assert float(tclip.clip_grad_norm_(ps[0], 10.0)) > 0
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([1.0, float("nan"), 2.0])
    with pytest.raises(RuntimeError, match="not finite"):
        tclip.clip_grad_norm_(p, 1.0, error_if_nonfinite=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_grad_value_matches_reference(dtype):
    jps, tps = _clip_pairs(dtype, seed=11)
    jclip.clip_grad_value_(jps, 0.3)
    tclip.clip_grad_value_(tps, 0.3)
    for jp, tp in zip(jps[:-1], tps[:-1]):
        np.testing.assert_array_equal(tp.grad.float().numpy(),
                                      _np(jp.grad))
        assert float(tp.grad.float().abs().max()) <= 0.3 + 2e-3
    assert tps[-1].grad is None


# ---------------------------------------------------------------------------
# tied word embeddings
# ---------------------------------------------------------------------------

#: head_dim 64 and 128 tokens: the port's SDPA takes the flash route
CFG = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
           num_hidden_layers=2, intermediate_size=688,
           max_position_embeddings=256, tie_word_embeddings=True)
STEPS = 3
#: the loss, and each gradient relative to its max (the matmuls sum in
#: other orders in XLA and PyTorch)
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5
#: the parameters after AdamW steps taken on the same (the reference's)
#: grads, relative to each one's max: the same elementwise fp32 ops, the
#: clip's global norm summed in another order
PARAM_RTOL = 1e-6
LR = 1e-3


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tied_runs():
    paddle.seed(1)
    jm = JaxLlama(jtiny(**CFG))
    for name, p in jm.named_parameters():
        p.name = name
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.load_jax_state(pt.LlamaForCausalLM(pt.llama_tiny(**CFG),
                                               device="cpu"), arrays)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 128, (2, 128)).astype(np.int64)
    labels = rng.randint(0, 128, (2, 128)).astype(np.int64)
    decay = lambda n: "norm" not in n               # noqa: E731
    jopt = JAdamW(learning_rate=LR, parameters=jm.parameters(),
                  grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                  apply_decay_param_fun=decay)
    jopt.fuse_step = False
    topt = pt.optimizer.AdamW(learning_rate=LR,
                              parameters=tm.named_parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                              apply_decay_param_fun=decay)
    out = {"arrays": arrays, "jax": [], "torch": [], "topt": topt, "tm": tm}
    linear = pt.convert._linear_weights(tm)
    for _ in range(STEPS):
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jgrads = {n: _np(p.grad).copy() for n, p in jm.named_parameters()}
        jopt.step()
        jopt.clear_grad()
        out["jax"].append(dict(loss=float(_np(jloss)), grads=jgrads, params={
            n: _np(p).copy() for n, p in jm.named_parameters()}))
        tloss, _ = tm(ids, labels=labels)
        tloss.backward()
        tgrads = pt.jax_layout(tm, {n: p.grad
                                    for n, p in tm.named_parameters()})
        # the step takes the reference's grads: Adam divides each grad
        # element by its own magnitude, so ulp-level differences of tiny
        # grads would move elements by up to lr apart and the two
        # trajectories would no longer compare the optimizers
        for n, p in tm.named_parameters():
            g = jgrads[n].T if n in linear else jgrads[n]
            p.grad = torch.from_numpy(np.ascontiguousarray(g))
        topt.step()
        topt.clear_grad()
        out["torch"].append(dict(loss=float(tloss.detach()), grads=tgrads,
                                 params=pt.jax_layout(
                                     tm, dict(tm.named_parameters()))))
    return out


def test_tied_model_has_no_lm_head_and_loads_the_reference_state(tied_runs):
    tm = tied_runs["tm"]
    assert tm.lm_head is None
    assert "lm_head.weight" not in tied_runs["arrays"]
    assert set(tm.state_dict()) == set(tied_runs["arrays"])
    # the fused engine sees the tied tensor once: one step count a step
    topt = tied_runs["topt"]
    emb = tm.llama.embed_tokens.weight
    assert sum(p is emb for p in topt._parameter_list) == 1
    assert topt.state[emb]["step"] == STEPS
    assert topt._fused_engine.dispatches["eager"] == 0
    assert topt._fused_engine.dispatches["fused"] == 2 * STEPS


@pytest.mark.parametrize("step", range(STEPS))
def test_tied_loss_grads_and_adamw_steps_match_jax(tied_runs, step):
    j, t = tied_runs["jax"][step], tied_runs["torch"][step]
    assert abs(t["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"])
    assert set(t["grads"]) == set(j["grads"]) == set(j["params"])
    for name, want in j["grads"].items():
        assert _rel(t["grads"][name], want) <= GRAD_RTOL, name
    moved = 0.0
    for name, want in j["params"].items():
        assert _rel(t["params"][name], want) <= PARAM_RTOL, name
        moved = max(moved, float(np.abs(want - tied_runs["arrays"][name])
                                 .max()))
    assert moved > 0.0


# ---------------------------------------------------------------------------
# paddle.load and paddle.save
# ---------------------------------------------------------------------------

def test_load_reads_a_file_the_reference_saved(tmp_path):
    rng = np.random.RandomState(4)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randint(0, 9, (5,)).astype(np.int64)
    jw = JParameter(jnp.asarray(w))
    jw.name = "w"
    tensor = paddle.to_tensor(b)
    obj = {"model": {"w": jw, "b": tensor}, "step": 7,
           "list": [paddle.to_tensor(w * 2), "x"], "tuple": (1.5, None)}
    path = str(tmp_path / "ref.pdparams")
    paddle.save(obj, path)
    got = pt.load(path, device="cpu")
    assert isinstance(got["model"]["w"], torch.nn.Parameter)
    np.testing.assert_array_equal(got["model"]["w"].detach().numpy(), w)
    # the reference stores what its Tensor held: int32 (JAX runs without
    # 64-bit types here)
    assert got["model"]["b"].dtype == torch.int32
    np.testing.assert_array_equal(got["model"]["b"].numpy(), b)
    np.testing.assert_array_equal(got["list"][0].numpy(), w * 2)
    assert got["list"][1] == "x" and got["step"] == 7
    assert got["tuple"] == (1.5, None)
    arrays = pt.load(path, return_numpy=True)
    assert isinstance(arrays["model"]["w"], np.ndarray)
    np.testing.assert_array_equal(arrays["model"]["w"], w)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is present: the default is valid")
        pt.load(path)


def test_load_a_reference_model_checkpoint_into_the_port(tmp_path):
    paddle.seed(3)
    jm = JaxLlama(jtiny())
    path = str(tmp_path / "llama.pdparams")
    paddle.save(jm.state_dict(), path)
    tm = pt.LlamaForCausalLM(pt.llama_tiny(), device="cpu", seed=5)
    pt.load_jax_state(tm, pt.load(path, return_numpy=True))
    ids = np.arange(12).reshape(1, 12) % 128
    want = _np(jm(paddle.to_tensor(ids)))
    got = tm(ids).detach().numpy()
    assert _rel(got, want) <= GRAD_RTOL


def test_save_round_trips_in_the_port(tmp_path):
    p = torch.nn.Parameter(torch.randn(4, 3))
    obj = {"p": p, "half": torch.randn(5).bfloat16(),
           "ids": torch.arange(6), "nested": [{"x": torch.ones(2)}, 3],
           "opt": {"w_moment1": torch.zeros(2), "w_step": 2}}
    path = str(tmp_path / "sub" / "ckpt.pdparams")
    pt.save(obj, path)
    got = pt.load(path, device="cpu")
    assert isinstance(got["p"], torch.nn.Parameter)
    assert torch.equal(got["p"], p)
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], obj["half"])
    assert torch.equal(got["ids"], obj["ids"])
    assert torch.equal(got["nested"][0]["x"], torch.ones(2))
    assert got["nested"][1] == 3 and got["opt"]["w_step"] == 2
    half = pt.load(path, return_numpy=True)["half"]
    np.testing.assert_array_equal(half, obj["half"].float().numpy())


def test_save_is_atomic(tmp_path):
    path = tmp_path / "ckpt.pdparams"
    pt.save({"a": torch.ones(2)}, str(path))
    with pytest.raises(Exception):
        pt.save({"a": torch.zeros(2), "bad": lambda: None}, str(path))
    # the old file is intact and no temporary is left behind
    assert torch.equal(pt.load(str(path), device="cpu")["a"], torch.ones(2))
    assert [f.name for f in tmp_path.iterdir()] == ["ckpt.pdparams"]
    assert tio._REFERENCE_PAYLOAD == ("paddle_tpu.framework.io",
                                      "_TensorPayload")
