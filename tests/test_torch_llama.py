"""Parity of the port's Llama (ops, norm, attention, model, ragged cache
forward) with the JAX reference on shared weights, fp32, CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models.generation import SlotPagedKVCache as JaxCache
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import fused as jfused

import paddle_tpu_torch as pt
from paddle_tpu_torch.models.generation import SlotPagedKVCache
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.norm import rms_norm
from paddle_tpu_torch.ops import fused

#: fp32 on both sides; the matmuls sum in different orders (XLA vs
#: PyTorch CPU), which moves logits by a few ulp of their magnitude
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


@pytest.fixture(autouse=True, scope="module")
def _no_reference_mesh():
    """The port's tests run the reference on one device. A test of the
    JAX package elsewhere in the worker can leave its global hybrid mesh
    installed (``group_sharded_parallel`` installs the default 8-way dp
    mesh over the virtual CPU devices, ROADMAP C28); under the grad tape
    the reference's ``shard_activation`` then pins a batch of 2 to dp 8
    and raises. No mesh for the module, the worker's own put back after
    (the port files that run the reference's model import this
    fixture)."""
    saved = mesh_mod.get_mesh() if mesh_mod.has_mesh() else None
    mesh_mod.reset_mesh()
    yield
    if saved is not None:
        mesh_mod.set_mesh(saved)


def _within_tol(got, want, what):
    """``assert_allclose`` at TOL, its message giving the observed error
    ``max |got - want| / (atol + rtol |want|)`` (<= 1 passes)."""
    ratio = float(np.max(np.abs(got - want)
                         / (TOL["atol"] + TOL["rtol"] * np.abs(want))))
    np.testing.assert_allclose(got, want, **TOL, err_msg=(
        f"{what}: max |got - want| / (atol + rtol |want|) = {ratio:.4g}, "
        f"TOL {TOL}"))


@pytest.fixture(scope="module")
def models(_no_reference_mesh):
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2,
                                           max_position_embeddings=256),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    tm.eval()
    return jm, tm, arrays


def test_load_jax_state_round_trip_and_guards(models):
    _, tm, arrays = models
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    own = tm.state_dict()
    assert set(own) == set(arrays)
    for name, t in own.items():
        back = t.numpy().T if name in linear else t.numpy()
        np.testing.assert_array_equal(back, arrays[name])
    fresh = pt.LlamaForCausalLM(pt.llama_tiny(max_position_embeddings=256),
                                device="cpu")
    missing = dict(arrays)
    del missing["llama.norm.weight"]
    with pytest.raises(KeyError):
        pt.load_jax_state(fresh, missing)
    with pytest.raises(KeyError):
        pt.load_jax_state(fresh, {**arrays, "extra.weight": np.zeros(1)})
    bad = dict(arrays)
    bad["lm_head.weight"] = bad["lm_head.weight"].T     # [out, in]: wrong
    with pytest.raises(ValueError):
        pt.load_jax_state(fresh, bad)


def test_seeded_init_is_reproducible():
    a = pt.LlamaForCausalLM(pt.llama_tiny(), device="cpu", seed=3)
    b = pt.LlamaForCausalLM(pt.llama_tiny(), device="cpu", seed=3)
    for (na, ta), (_, tb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(ta, tb), na
    w = a.llama.layers[0].self_attn.q_proj.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.005
    assert torch.equal(a.llama.norm.weight, torch.ones(64))


def test_ops_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 5, 2, 16).astype(np.float32)
    pos = np.asarray([7, 3, 0, 12, 5], np.int32)
    jcos, jsin = jfused.rope_freqs(16, 32, 500000.0)
    cos, sin = fused.rope_freqs(16, 32, 500000.0)
    np.testing.assert_allclose(cos.numpy(), _np(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), _np(jsin), **TOL)
    for p in (None, pos):
        jq, jk, _ = jfused.fused_rotary_position_embedding(
            Tensor(jnp.asarray(x)), Tensor(jnp.asarray(k)), sin=jsin,
            cos=jcos, position_ids=None if p is None else jnp.asarray(p))
        tq, tk = fused.fused_rotary_position_embedding(
            torch.from_numpy(x), torch.from_numpy(k), sin=sin, cos=cos,
            position_ids=None if p is None else torch.from_numpy(p).long())
        np.testing.assert_allclose(tq.numpy(), _np(jq), **TOL)
        np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    g = rng.randn(3, 8).astype(np.float32)
    u = rng.randn(3, 8).astype(np.float32)
    np.testing.assert_allclose(
        fused.fused_swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
        _np(jfused.fused_swiglu(Tensor(jnp.asarray(g)),
                                Tensor(jnp.asarray(u)))), **TOL)
    w = rng.rand(8).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(g), torch.from_numpy(w), 1e-5).numpy(),
        _np(JF.rms_norm(Tensor(jnp.asarray(g)), Tensor(jnp.asarray(w)),
                        1e-5)), **TOL)


@pytest.mark.parametrize("sq,sk", [(6, 6), (3, 9)])
def test_sdpa_gqa_causal_matches_jax(sq, sk):
    rng = np.random.RandomState(sq)
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, sk, 2, 16).astype(np.float32)
    v = rng.randn(2, sk, 2, 16).astype(np.float32)
    want = _np(JF.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), is_causal=True, training=False))
    got = scaled_dot_product_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cache_free_logits_match_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(5).randint(0, 128, (2, 13)).astype(np.int64)
    want = _np(jm(paddle.to_tensor(ids)))
    with torch.no_grad():
        got = tm(ids)
    _within_tol(got.numpy(), want, "cache-free logits")


def test_ragged_cache_forward_matches_jax(models):
    """Two ragged ticks through each package's SlotPagedKVCache: a mixed
    prefill tick (two prompts, one padding token), then a decode tick for
    both slots. The logits of every span token agree."""
    jm, tm, _ = models
    rng = np.random.RandomState(9)
    p0 = rng.randint(0, 128, 11).astype(np.int64)
    p1 = rng.randint(0, 128, 20).astype(np.int64)
    jc = JaxCache(2, page_size=8, max_len=64)
    tc = SlotPagedKVCache(2, page_size=8, max_len=64)
    for c in (jc, tc):
        c.assign(0, p0)
        c.assign(1, p1)
    ticks = [
        ([(0, 0, 11), (1, 11, 20)], np.concatenate([p0, p1, [0]]),
         np.concatenate([np.arange(11), np.arange(20), [0]])),
        ([(0, 0, 1), (1, 1, 1)], np.asarray([5, 9]), np.asarray([11, 20])),
    ]
    for spans, flat, pos in ticks:
        jc.begin_ragged(spans)
        with no_grad():      # the Pallas call has no JVP
            want = _np(jm.forward(Tensor(jnp.asarray(flat[None])), cache=jc,
                                  position_ids=pos.astype(np.int32)))
        tc.begin_ragged(spans, num_tokens=flat.size)
        with torch.no_grad():
            got = tm.forward(flat[None], cache=tc, position_ids=pos)
        tc.end_step()
        rows = np.concatenate([np.arange(qs, qs + n) for _, qs, n in spans])
        np.testing.assert_allclose(got.numpy()[0, rows], want[0, rows],
                                   **TOL)
    np.testing.assert_array_equal(tc.lens, jc.lens)
    np.testing.assert_array_equal(tc._tables, jc._tables)
