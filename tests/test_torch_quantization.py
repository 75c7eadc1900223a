"""The port's quantization surface (``paddle_tpu_torch/quantization``)
against the JAX package's (``paddle_tpu/quantization/__init__.py``):
``fake_quant`` and its straight-through gradient, the observers and
quanters, the layers ``QAT.quantize`` swaps, ``calibrate``'s scales,
``convert``'s int8 codes and scales (bit-equal; Linear codes transposed,
ROADMAP C3), the converted ``QuantedLinear`` and ``QuantedConv2D``
forwards, ``load_jax_state`` / ``jax_layout`` over wrapped and converted
models, the AMP O2 dtype trace of ``"fake_quant"`` and ``"int8_linear"``,
and a PTQ-converted Llama serving as the ``weight_dtype="int8"``
engine does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.framework.core import Tensor

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.framework import core as tcore

from test_torch_amp_serving import _JaxTrace, _torch_records
from test_torch_serving import _drive_in_order

#: converted forwards: B10's plain version and the reference's
#: interpret-mode kernel sum K in other orders
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's layers on the CPU (their default device is the card)
    and one torch thread, both restored after."""
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _x(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# -- fake quantisation --------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_forward_and_gradient_match_the_reference(bits):
    """The quantise-dequantise values bit-equal to the reference's custom
    VJP primitive, and its straight-through gradient: the cotangent where
    ``|x| <= scale``, zero outside, none to the scale."""
    x = _x(0, 6, 40, scale=2.0)
    x[0, :3] = (1.5, -1.5, 0.0)
    scale = np.float32(1.5)
    qmax = float(2 ** (bits - 1) - 1)
    g = _x(1, 6, 40)
    want, vjp = jax.vjp(lambda a, s: jq._fake_quant(a, s, qmax),
                        jnp.asarray(x), jnp.asarray(scale))
    gx, gs = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.tensor(scale).requires_grad_(True)
    out = tq.fake_quant(tx, ts, bits)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gx))
    assert float(ts.grad) == float(gs) == 0.0
    assert (tx.grad.numpy()[np.abs(x) > scale] == 0).all()


def test_fake_quant_in_bf16_matches_the_reference():
    x = _x(2, 4, 64, scale=3.0)
    want = jq._fake_quant(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(2.5, jnp.bfloat16), 127.0)
    got = tq.fake_quant(torch.from_numpy(x).bfloat16(),
                        torch.tensor(2.5).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_observer_and_quanter_scales_match_the_reference():
    """The running abs-max (Python floats: the first observation, then
    the moving average) after each of five tensors, and the quanter's
    outputs bit-equal."""
    xs = [_x(3 + i, 5, 7, scale=1.0 + i) for i in range(5)]
    jo, to = jq.AbsmaxObserver(), tq.AbsmaxObserver(moving_rate=0.9)
    jf, tf = (jq.FakeQuanterWithAbsMaxObserver(),
              tq.FakeQuanterWithAbsMaxObserver())
    for x in xs:
        jo.observe(Tensor(jnp.asarray(x)))
        to.observe(torch.from_numpy(x))
        assert to.scale == jo.scale
        want = jf.quantize(Tensor(jnp.asarray(x)))
        got = tf.quantize(torch.from_numpy(x))
        assert tf.scale == jf.scale
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    twin = to._instance()
    assert twin is not to and twin.scale == to.scale


# -- the wrappers -------------------------------------------------------------

def _net(nn, flatten):
    """A conv, a nested Sequential of Linears and a Linear beside it, in
    either package."""

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.body = nn.Sequential(nn.Linear(64, 32), nn.ReLU(),
                                      nn.Linear(32, 16))
            self.head = nn.Linear(16, 10)

        def forward(self, x):
            return self.head(self.body(flatten(self.conv(x), 1)))
    return Net()


@pytest.fixture
def nets():
    paddle.seed(1)
    jn = _net(jnn, paddle.flatten)
    tn = _net(pt.nn, pt.flatten)
    pt.load_jax_state(tn, {k: np.asarray(v)
                           for k, v in jn.state_dict().items()})
    return jn, tn


def _wrapped(named):
    """``{name: wrapper class}`` of a ``named_sublayers()`` /
    ``named_modules()`` listing."""
    return {n: type(m).__name__ for n, m in named
            if type(m).__name__ in ("QuantedLinear", "QuantedConv2D")}


def _config(mod, quanter):
    q = getattr(mod, quanter)
    return mod.QuantConfig(activation=q(), weight=q())


def test_qat_swaps_the_same_layers(nets):
    """``QAT.quantize`` swaps exactly the ``Linear`` and ``Conv2D``
    layers, by exact type, at the same names; the parameters become
    ``<name>.inner.weight`` in both ``state_dict``s."""
    jn, tn = nets
    jq.QAT(_config(jq, "FakeQuanterWithAbsMaxObserver")).quantize(jn)
    tq.QAT(_config(tq, "FakeQuanterWithAbsMaxObserver")).quantize(tn)
    want = _wrapped(jn.named_sublayers())
    assert _wrapped(tn.named_modules()) == want == {
        "conv": "QuantedConv2D", "body.0": "QuantedLinear",
        "body.2": "QuantedLinear", "head": "QuantedLinear"}
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert "body.0.inner.weight" in tn.state_dict()
    assert tn.head.a_q is not tn.body[0].a_q        # one quanter a layer


def test_qat_step_matches_the_reference(nets):
    """A QAT forward and backward in train mode on both: the loss within
    1e-5, the quanters' scales equal, every gradient within 1e-5 (in the
    reference's layout)."""
    jn, tn = nets
    jq.QAT(_config(jq, "FakeQuanterWithAbsMaxObserver")).quantize(jn)
    tq.QAT(_config(tq, "FakeQuanterWithAbsMaxObserver")).quantize(tn)
    x = _x(7, 2, 3, 4, 4)
    jloss = (jn(Tensor(jnp.asarray(x))) ** 2).mean()
    jloss.backward()
    tloss = (tn(torch.from_numpy(x)) ** 2).mean()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(np.asarray(jloss._data)),
                               **TOL)
    for name in ("conv", "head"):
        jl, tl = getattr(jn, name), getattr(tn, name)
        assert tl.a_q.scale == pytest.approx(jl.a_q.scale, rel=1e-6)
        assert tl.w_q.scale == jl.w_q.scale
    jgrads = {n: np.asarray(p.grad._data) for n, p in jn.named_parameters()}
    tgrads = pt.convert.jax_layout(tn, {n: p.grad for n, p in
                                        tn.named_parameters()})
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def _calibrated(nets, batches=3):
    jn, tn = nets
    jq.PTQ(_config(jq, "AbsmaxObserver")).quantize(jn)
    tq.PTQ(_config(tq, "AbsmaxObserver")).quantize(tn)
    data = [(_x(20 + i, 2, 3, 4, 4), np.zeros(2)) for i in range(batches)]
    assert jq.calibrate(jn, data[1:]) == tq.calibrate(tn, data[1:]) \
        == batches - 1
    assert jq.calibrate(jn, data, steps=1) == tq.calibrate(
        tn, data, steps=1) == 1
    return jn, tn


def test_calibrate_gives_the_reference_scales(nets):
    jn, tn = _calibrated(nets)
    for name in ("conv", "body.0", "body.2", "head"):
        jl = dict(jn.named_sublayers())[name]
        tl = dict(tn.named_modules())[name]
        assert tl.w_q.scale == jl.w_q.scale
        assert tl.a_q.scale == pytest.approx(jl.a_q.scale, rel=1e-6)
    assert tn.training and jn.training       # restored after calibration


def test_convert_codes_scales_and_weights_bit_equal(nets):
    """After the same calibration, ``convert``: every Linear's codes
    ``[out, in]`` the reference's ``[in, out]`` transposed, the scales,
    the rewritten fp32 weights and the conv's codes, scales and filter
    bit-equal; ``act_scale`` from the activation observer."""
    jn, tn = _calibrated(nets, batches=4)
    jq.convert(jn)
    assert tq.PTQ(_config(tq, "AbsmaxObserver")).convert(tn) is tn
    for name in ("conv", "body.0", "body.2", "head"):
        jl = dict(jn.named_sublayers())[name]
        tl = dict(tn.named_modules())[name]
        codes = tl._w_int8.numpy()
        linear = name != "conv"
        np.testing.assert_array_equal(codes.T if linear else codes,
                                      np.asarray(jl._w_int8))
        np.testing.assert_array_equal(tl._w_scale.numpy(),
                                      np.asarray(jl._w_scale))
        w = tl.inner.weight.detach().numpy()
        assert tl.inner.weight.dtype == torch.float32
        np.testing.assert_array_equal(w.T if linear else w,
                                      np.asarray(jl.inner.weight._data))
        assert tl.act_scale == pytest.approx(jl.act_scale, rel=1e-6)
        assert tl.weight_scale == jl.weight_scale
        assert tl.int8_weight is tl._w_int8


def test_converted_forwards_match_the_reference(nets):
    """Converted, in eval: the Linears through B10's plain version (the
    reference's interpret-mode kernel) and the conv on the dequantised
    filter, end to end within 1e-5; in train mode the float path runs
    again."""
    jn, tn = _calibrated(nets)
    jq.convert(jn)
    tq.convert(tn)
    jn.eval()
    tn.eval()
    x = _x(30, 2, 3, 4, 4)
    with no_grad():
        want = np.asarray(jn(Tensor(jnp.asarray(x)))._data)
    got = tn(torch.from_numpy(x))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    conv_want = np.asarray(jn.conv(Tensor(jnp.asarray(x)))._data)
    np.testing.assert_allclose(tn.conv(torch.from_numpy(x)).numpy(),
                               conv_want, **TOL)
    tn.train()
    assert tn(torch.from_numpy(x)).requires_grad


def test_state_carries_wrapped_and_converted_models(nets):
    """``load_jax_state`` fills a QAT-wrapped port model from the wrapped
    reference's ``state_dict`` (``inner.`` names), and a converted one
    from it plus the reference's codes and scales (its attributes, under
    ``<layer>._w_int8`` / ``._w_scale``), the Linear codes transposed;
    ``jax_layout`` gives them back in the reference's layout; a missing
    or extra key raises."""
    jn, tn = _calibrated(nets)
    jq.convert(jn)
    tq.convert(tn)
    arrays = {k: np.asarray(v) for k, v in jn.state_dict().items()}
    for name, layer in jn.named_sublayers():
        if isinstance(layer, (jq.QuantedLinear, jq.QuantedConv2D)):
            arrays[f"{name}._w_int8"] = np.asarray(layer._w_int8)
            arrays[f"{name}._w_scale"] = np.asarray(layer._w_scale)
    paddle.seed(5)
    other = _net(pt.nn, pt.flatten)
    tq.PTQ(_config(tq, "AbsmaxObserver")).quantize(other)
    tq.convert(other)
    pt.load_jax_state(other, arrays)
    back = pt.convert.jax_layout(other)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert back[k].dtype == arrays[k].dtype
    np.testing.assert_array_equal(other.head._w_int8.numpy(),
                                  tn.head._w_int8.numpy())
    with pytest.raises(KeyError):
        pt.load_jax_state(other, {k: v for k, v in arrays.items()
                                  if not k.endswith("_w_int8")})


def test_o2_dtype_trace_of_fake_quant_and_int8_linear(nets, monkeypatch):
    """Under ``auto_cast(level="O2", dtype="bfloat16")``: a QAT Linear's
    forward (``"fake_quant"`` of the activation and of the weight, then
    ``"linear"``) and a converted one's (``"int8_linear"``, x, codes and
    scales), record for record the reference's."""
    jn, tn = nets
    x = _x(40, 3, 16)
    kw = dict(level="O2", dtype="bfloat16")
    jtrace = _JaxTrace(monkeypatch)
    cfg = ("FakeQuanterWithAbsMaxObserver",)
    jl = jq.QuantedLinear(jn.head, *(getattr(jq, c)() for c in cfg * 2))
    tl = tq.QuantedLinear(tn.head, *(getattr(tq, c)() for c in cfg * 2))
    with debugging.collect_operator_stats() as stats, \
            jamp.auto_cast(**kw), amp.auto_cast(**kw):
        jl(Tensor(jnp.asarray(x)))
        tl(torch.from_numpy(x))
        for layer in (jl, tl):
            layer.eval()
        jq.convert(jnn.Sequential(jl))
        tq.convert(pt.nn.Sequential(tl))
        with no_grad():
            jl(Tensor(jnp.asarray(x)))
        tl(torch.from_numpy(x))
    ttrace = _torch_records(stats)
    assert ttrace == jtrace.records
    names = [r[0] for r in ttrace]
    assert names == ["fake_quant", "fake_quant", "linear", "int8_linear"]
    assert ttrace[0] == ("fake_quant", ("float32", "float32"),
                         ("bfloat16", "bfloat16"))
    assert ttrace[3][2][0] == "bfloat16"


# -- a PTQ-converted Llama serves as the int8 engine ---------------------------

def test_ptq_converted_llama_serves_as_the_int8_engine():
    """``PTQ`` + ``calibrate`` + ``convert`` on a Llama (every Linear,
    the head included, swapped) gives the same codes as the
    ``weight_dtype="int8"`` engine's ``quantize_linears`` on the same
    seeded weights, and the same greedy streams through B10's plain
    version."""
    cfg = pt.llama_tiny(num_hidden_layers=2)
    ptq = pt.LlamaForCausalLM(cfg, device="cpu", seed=3)
    ref = pt.LlamaForCausalLM(cfg, device="cpu", seed=3)
    tq.PTQ(_config(tq, "AbsmaxObserver")).quantize(ptq)
    wrapped = [m for m in ptq.modules() if isinstance(m, tq.QuantedLinear)]
    assert len(wrapped) == 7 * 2 + 1
    prompts = [np.random.RandomState(i).randint(0, 128, (1, 9 + i))
               for i in range(4)]
    assert tq.calibrate(ptq, prompts) == 4
    assert all(m.a_q.scale > 0 and m.w_q.scale > 0 for m in wrapped)
    tq.convert(ptq)
    kw = dict(device="cpu", max_batch_size=2, max_len=64)
    got = _drive_in_order(pt.ContinuousServingEngine(ptq, **kw), prompts, 3)
    eng = pt.ContinuousServingEngine(ref, weight_dtype="int8", **kw)
    assert eng.quantized_linears == len(wrapped)
    want = _drive_in_order(eng, prompts, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ptq.lm_head._w_int8.numpy(),
                                  ref.lm_head.w_int8.numpy())
