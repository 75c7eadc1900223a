"""The port's gradient-communication layer against the reference's
(``paddle_tpu/distributed/comm``).

* The int8 and bf16 wire codecs on the same numpy inputs: codes, scales
  and decoded values equal bit for bit (tolerance 0), wire bytes equal.
* The bucketer's layout: ``signature()`` of a Llama's parameter list equal
  to the reference's at fuse 0, 1 and 32 MB, fp32 and int8-aligned.
* The exchange at dp 4: one 4-rank gloo world
  (``torch_dist_workers.comm_world``) against the reference's thread
  simulator (``dist.spawn``) on the same inputs: the quantized
  all-reduce and reduce-scatter, the bf16 wire, error-feedback residuals
  over three rounds and the int8 bucketed exchange bit for bit; the fp32
  bucketed exchange within 1e-6 of each tensor's largest value (gloo's
  ring sums four ranks in another order than numpy's mean); every case's
  ``CommStats`` summed over the port's ranks equal to the reference's
  (its thread ranks share one counter).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import comm as rcomm
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jtiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import comm
import torch_dist_workers as workers
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codec_inputs():
    rng = np.random.default_rng(0)
    mags = np.repeat(10.0 ** rng.integers(-3, 3, size=51), 100)[:5000]
    tiny = np.zeros(512, np.float32)
    tiny[300] = 1e-42                     # maxabs / 127 underflows fp32
    return {"scaled": (rng.normal(size=5000) * mags).astype(np.float32),
            "normal": np.random.default_rng(1).normal(size=1000)
            .astype(np.float32),
            "zero_and_tiny": tiny,
            "ties": (np.arange(-300, 300) / 2).astype(np.float32)}


@pytest.mark.parametrize("block_size", [64, 256, 1024])
@pytest.mark.parametrize("name", sorted(_codec_inputs()))
def test_int8_codec_bit_exact(name, block_size):
    x = _codec_inputs()[name]
    q, s = comm.quantize_blockwise(torch.tensor(x), block_size)
    rq, rs = rcomm.quantize_blockwise(x, block_size)
    np.testing.assert_array_equal(q.numpy(), rq)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  rs.view(np.uint32))
    d = comm.dequantize_blockwise(q, s, x.size, block_size)
    rd = rcomm.dequantize_blockwise(rq, rs, x.size, block_size)
    np.testing.assert_array_equal(d.numpy().view(np.uint32),
                                  rd.view(np.uint32))


def test_int8_codec_chunks_give_the_same_bits(monkeypatch):
    """The codec works a chunk of blocks at a time (``CHUNK`` elements):
    chunks of 3 blocks of 64 give the reference's codes and scales."""
    from paddle_tpu_torch.distributed.comm import quantization
    monkeypatch.setattr(quantization, "CHUNK", 192)
    x = _codec_inputs()["scaled"]
    q, s = comm.quantize_blockwise(torch.tensor(x), 64)
    rq, rs = rcomm.quantize_blockwise(x, 64)
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  rs.view(np.uint32))


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
def test_wire_encoding_bit_exact(scheme):
    from paddle_tpu.distributed.comm.quantization import (
        decode_wire, encode_wire)
    x = _codec_inputs()["scaled"]
    payload, wire = comm.encode_wire(torch.tensor(x), scheme, 256)
    rpayload, rwire = encode_wire(x, scheme, 256)
    assert wire == rwire and payload[0] == rpayload[0]
    for got, want in zip(payload[1:], rpayload[1:]):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        comm.decode_wire(payload, x.size, 256).numpy(),
        decode_wire(rpayload, x.size, 256))


@pytest.fixture(scope="module")
def llama_params(_no_reference_mesh):
    """(the reference's, the port's) parameters of one tiny Llama."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2))
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2),
                             device="cpu")
    jnames = [n for n, _ in jm.named_parameters()]
    assert jnames == [n for n, _ in tm.named_parameters()]
    return list(jm.parameters()), list(tm.parameters())


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("fuse", [0, 1, 32])
def test_llama_bucket_signature_equals_the_reference(llama_params, fuse,
                                                     quant):
    jps, tps = llama_params
    want = rcomm.GradientBucketer(jps, fuse_grad_size_in_MB=fuse,
                                  quantization=quant).signature()
    got = comm.GradientBucketer(tps, fuse_grad_size_in_MB=fuse,
                                quantization=quant).signature()
    assert got == want
    assert len(got) == {0: len(tps), 1: len(got), 32: 1}[fuse]


def test_mixed_dtype_signature_equals_the_reference():
    shapes = [((8,), "float32"), ((8,), "int32"), ((300,), "float32"),
              ((4, 4), "bfloat16"), ((10,), "float32")]
    jps = [paddle.to_tensor(np.zeros(s, np.float32)).astype(d)
           for s, d in shapes]
    tps = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    for quant in (None, "int8"):
        assert comm.GradientBucketer(
            tps, fuse_grad_size_in_MB=0.001, quantization=quant).signature() \
            == rcomm.GradientBucketer(
                jps, fuse_grad_size_in_MB=0.001,
                quantization=quant).signature()


# -- the exchange at dp 4


@pytest.fixture(scope="module")
def port():
    return workers.run_world(workers.comm_world, 4)


def _r_all_reduce_q():
    r = rdist.get_rank()
    x = np.random.default_rng(r).normal(size=600).astype(np.float32)
    t = paddle.to_tensor(x.copy())
    rcomm.all_reduce_quantized(t, op=rdist.ReduceOp.AVG, block_size=64)
    return x, t.numpy()


def _r_reduce_scatter_q():
    r = rdist.get_rank()
    parts = [np.full((8,), float(r + 10 * i), np.float32) for i in range(2)]
    out = paddle.zeros([8])
    rcomm.reduce_scatter_quantized(out, [paddle.to_tensor(p) for p in parts],
                                   op=rdist.ReduceOp.SUM, block_size=64)
    return out.numpy()


def _r_bf16():
    t = paddle.to_tensor(np.full(64, 1.0 + rdist.get_rank(), np.float32))
    rcomm.all_reduce_quantized(t, op=rdist.ReduceOp.AVG, scheme="bf16")
    return t.numpy()


def _r_byte_accounting():
    rcomm.all_reduce_quantized(paddle.to_tensor(np.ones(1024, np.float32)),
                               block_size=256)


def _r_dense_recorded():
    rdist.all_reduce(paddle.to_tensor(np.ones(256, np.float32)))


def _r_error_feedback():
    r = rdist.get_rank()
    residual = np.zeros(512, np.float32)
    got = [rcomm.allreduce_array(workers.ef_grads(r, k), op="avg",
                                 scheme="int8", block_size=128,
                                 residual=residual)
           for k in range(workers.EF_ROUNDS)]
    return got, residual.copy()


def _r_bucketed(quant, fuse, ef):
    def worker():
        r = rdist.get_rank()
        params = [paddle.to_tensor(np.zeros(s, np.float32))
                  for s in workers.BUCKET_SHAPES]
        b = rcomm.GradientBucketer(params, fuse_grad_size_in_MB=fuse,
                                   quantization=quant, block_size=64,
                                   error_feedback=ef)
        return [[np.asarray(a) for a in b.sync_arrays(
            workers.bucket_grads(r, k))] for k in range(2)], b.signature()
    return worker


#: case -> (the reference's world, its worker)
REFERENCE = {
    "all_reduce_quantized": (4, _r_all_reduce_q),
    "reduce_scatter_quantized": (2, _r_reduce_scatter_q),
    "bf16_scheme": (2, _r_bf16),
    "byte_accounting": (2, _r_byte_accounting),
    "dense_recorded": (2, _r_dense_recorded),
    "error_feedback_dp4": (4, _r_error_feedback),
    "bucketed_int8_ef": (4, _r_bucketed("int8", 0.01, True)),
    "bucketed_fp32": (4, _r_bucketed(None, 32, False)),
}


@pytest.fixture(scope="module")
def reference():
    """Each case on the reference's simulator: (results, CommStats)."""
    out = {}
    for case, (nprocs, worker) in REFERENCE.items():
        rcomm.reset_comm_stats()
        res = rdist.spawn(worker, nprocs=nprocs).results
        out[case] = (res, rcomm.get_comm_stats().as_dict())
    rcomm.reset_comm_stats()
    return out


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def test_all_reduce_quantized_bit_exact(port, reference):
    ref = reference["all_reduce_quantized"][0]
    exact = np.mean([x for x, _ in ref], axis=0)
    for r in range(4):
        x, got = port[r]["all_reduce_quantized"][0]
        np.testing.assert_array_equal(x, ref[r][0])
        np.testing.assert_array_equal(_bits(got), _bits(ref[r][1]))
        # the reference test's own bound
        np.testing.assert_allclose(got, exact, atol=0.05)


@pytest.mark.parametrize("case", ["reduce_scatter_quantized", "bf16_scheme"])
def test_two_rank_wire_bit_exact(port, reference, case):
    ref = reference[case][0]
    for r in range(2):
        np.testing.assert_array_equal(_bits(port[r][case][0]), _bits(ref[r]))
    assert port[2][case][0] is None and port[3][case][0] is None
    if case == "reduce_scatter_quantized":
        np.testing.assert_allclose(port[0][case][0], 1.0, atol=0.1)
        np.testing.assert_allclose(port[1][case][0], 21.0, atol=0.3)
    else:
        np.testing.assert_allclose(port[0][case][0], 1.5, rtol=1e-2)


def test_error_feedback_residuals_bit_exact(port, reference):
    ref = reference["error_feedback_dp4"][0]
    for r in range(4):
        got, residual = port[r]["error_feedback_dp4"][0]
        for g, w in zip(got, ref[r][0]):
            np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(residual), _bits(ref[r][1]))
        assert np.abs(residual).max() > 0


def test_bucketed_int8_exchange_bit_exact(port, reference):
    ref = reference["bucketed_int8_ef"][0]
    for r in range(4):
        got, sig, agree = port[r]["bucketed_int8_ef"][0]
        assert agree and sig == ref[r][1]
        for rounds_got, rounds_want in zip(got, ref[r][0]):
            for g, w in zip(rounds_got, rounds_want):
                np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bucketed_fp32_exchange_matches(port, reference):
    ref = reference["bucketed_fp32"][0]
    for r in range(4):
        got, sig, agree = port[r]["bucketed_fp32"][0]
        assert agree and sig == ref[r][1]
        for rounds_got, rounds_want, rounds_0 in zip(
                got, ref[r][0], port[0]["bucketed_fp32"][0][0]):
            for g, w, g0 in zip(rounds_got, rounds_want, rounds_0):
                assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
                np.testing.assert_array_equal(g, g0)   # ranks agree


@pytest.mark.parametrize("case", sorted(REFERENCE))
def test_comm_stats_equal_the_reference(port, reference, case):
    want = reference[case][1]
    stats = [port[r][case][1] for r in range(4)]
    for key in ("calls", "logical_bytes", "wire_bytes"):
        assert sum(s[key] for s in stats) == want[key], key
    kinds = {k for s in stats for k in s["by_kind"]}
    assert kinds == set(want["by_kind"])
    for k in kinds:
        for key in ("calls", "logical_bytes", "wire_bytes"):
            assert sum(s["by_kind"].get(k, {}).get(key, 0)
                       for s in stats) == want["by_kind"][k][key]
    assert max(s["quant_max_error"] for s in stats) == \
        want["quant_max_error"]
    assert all(s["host_staged"] == 0 for s in stats)
