"""The port's weight-only int8 path against the JAX package: the weight
codec bit for bit, the plain version of kernel B10 against the
interpret-mode Pallas ``int8_matmul``, and ``quantize_linears`` on a
tiny Llama (count, dequantised weights, eval logits through B10's route,
train logits through ``.weight``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.quantization import int8_linear as jax_int8_linear
from paddle_tpu.quantization import quantize_linears as jax_quantize_linears

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.quantization import int8_linear, quantize_linears
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    x = x._data if isinstance(x, Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    """Largest error over the reference's largest magnitude."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(dtype):
    """Codes (the port's ``[N, K]`` against JAX's ``[K, N]`` transposed)
    and scales equal bit for bit. The codec runs in the weight's dtype,
    so a bf16 weight rounds the abs-max quotient and the division in
    bf16; a zero channel takes the 1e-8 floor."""
    rng = np.random.RandomState(0)
    w = (rng.randn(300, 200) * 0.05).astype(np.float32)     # [K, N]
    w[:, 7] = 0.0
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w.T.copy()).to(getattr(torch, dtype))
    jq, js = jqm.quantize_weight(jw)
    tq, ts = tqm.quantize_weight(tw)
    assert tq.dtype == torch.int8 and tq.shape == (200, 300)
    assert ts.dtype == torch.float32 and ts.shape == (200,)
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


#: (M, K, N), none a multiple of the reference's 128 tiles
SHAPES = [(5, 300, 200), (1, 130, 257), (20, 64, 33)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_matmul_plain_matches_interpret_kernel(shape):
    """fp32 within 1e-5 of the output's largest magnitude (the same fp32
    products, summed in another order); a bf16 ``x`` gives bf16 within
    one bf16 ulp of the reference's own bf16 output."""
    m, k, n = shape
    rng = np.random.RandomState(m + k + n)
    jq, js = jqm.quantize_weight(jnp.asarray(rng.randn(k, n), jnp.float32))
    x = rng.randn(m, k).astype(np.float32)
    tq = torch.from_numpy(np.asarray(jq).T.copy())
    ts = torch.from_numpy(np.array(js))
    want = np.asarray(jqm.int8_matmul(jnp.asarray(x), jq, js,
                                      interpret=True))
    got = tqm.int8_matmul(torch.from_numpy(x), tq, ts)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got.numpy(), want) <= 1e-5
    want_b = _np(jqm.int8_matmul(jnp.asarray(x, jnp.bfloat16), jq, js,
                                 interpret=True))
    got_b = tqm.int8_matmul(torch.from_numpy(x).bfloat16(), tq, ts)
    assert got_b.dtype == torch.bfloat16
    ulp = np.ldexp(1.0, np.frexp(np.abs(want_b))[1] - 8)
    assert (np.abs(_np(got_b) - want_b) <= ulp).all()
    assert tqm.int8_matmul.launches == 0


def test_int8_linear_with_bias_matches_jax():
    rng = np.random.RandomState(3)
    jq, js = jqm.quantize_weight(jnp.asarray(rng.randn(48, 40), jnp.float32))
    x = rng.randn(2, 3, 48).astype(np.float32)
    bias = rng.randn(40).astype(np.float32)
    want = _np(jax_int8_linear(Tensor(jnp.asarray(x)), jq, js,
                               Tensor(jnp.asarray(bias))))
    got = int8_linear(torch.from_numpy(x).requires_grad_(),
                      torch.from_numpy(np.asarray(jq).T.copy()),
                      torch.from_numpy(np.array(js)), torch.from_numpy(bias))
    assert got.shape == (2, 3, 40) and not got.requires_grad
    assert _rel(got.numpy(), want) <= 1e-5


def test_int8_matmul_refuses_other_devices():
    """Only a CPU tensor runs the plain version; any other device
    launches the kernel or raises (here: a tensor with no data)."""
    x = torch.empty((2, 16), device="meta")
    with pytest.raises(ValueError, match="no int8 matmul"):
        tqm.int8_matmul(x, torch.zeros((4, 16), dtype=torch.int8),
                        torch.ones(4))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2, max_position_embeddings=256))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2,
                                           max_position_embeddings=256),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


def test_quantize_linears_matches_jax(models):
    """The same count (7 per layer plus ``lm_head``), the same dequantised
    ``.weight`` bit for bit, unchanged ``state_dict`` keys, 0 on a second
    call; eval logits through the int8 route and train logits through
    ``.weight`` within 1e-5 of the JAX model's."""
    jm, tm = models
    keys = list(tm.state_dict())
    n = jax_quantize_linears(jm)
    assert quantize_linears(tm) == n == 15
    assert list(tm.state_dict()) == keys
    assert quantize_linears(tm) == 0 == jax_quantize_linears(jm)
    for name, arr in pt.jax_layout(tm).items():
        np.testing.assert_array_equal(arr, np.asarray(jm.state_dict()[name]))
    ids = np.random.RandomState(4).randint(0, 128, (2, 11))
    for train in (False, True):
        jm.train() if train else jm.eval()
        tm.train(train)
        want = _np(jm(paddle.to_tensor(ids)))
        got = tm(torch.as_tensor(ids))
        rel = _rel(_np(got), want)
        assert rel <= 1e-5, (f"{'train' if train else 'eval'} logits: "
                             f"observed rel err {rel:.3e} > limit 1e-5")
        # eval streams the int8 codes, train multiplies by .weight
        assert got.requires_grad == train
    tm.eval()


def test_int8_engine_refuses_cpu_unasked(models):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    _, tm = models
    quantize_linears(tm)
    with pytest.raises(RuntimeError):
        pt.ContinuousServingEngine(tm, kv_dtype="int8", weight_dtype="int8")
    eng = pt.ContinuousServingEngine(tm, device="cpu", kv_dtype="int8",
                                     weight_dtype="int8")
    assert eng.quantized_linears == 0           # nothing left to quantise
