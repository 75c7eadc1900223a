"""The port's ResNet (``paddle_tpu_torch/vision/models/resnet.py``) against
the reference's: ResNet-18 with 10 classes at 2 x 3 x 32 x 32 (CIFAR-10's
images), the reference's weights carried in, the same seeded images and
labels. In training mode: logits, the loss, every gradient, the BN
running statistics after the forward, and the parameters after one
``Momentum(momentum=0.9, weight_decay=L2Decay(1e-4))`` step; then the
logits in eval mode. ResNet-50's forward at batch 1. Under PaddleClas's
O2 bf16 recipe (``decorate`` then ``auto_cast``), the parameters'
dtypes and the dtype trace of a forward and loss, op by op.

Tolerances (fp32, relative to the largest magnitude of the reference's
tensor). At 32 x 32 ``layer4`` runs on 1 x 1 maps, so in training mode
its BatchNorms normalize each channel over the batch's two values: that
amplifies the roundoff of everything before it about a thousandfold
(measured: 2.9e-6 after ``layer3``, 3.2e-3 after ``layer4``, 4.7e-4 on
the logits, 2.3e-2 on the worst gradient end to end). So the forward
end to end is held to ``E2E_TOL``, and each stage (the stem, the four
layers, the head) to ``TOL`` on the reference's own input of that
stage, forward and backward (its output's cotangent the reference's),
but ``layer4``, whose own BatchNorms are such, to ``LAYER4_TOL``; the
Momentum step to ``TOL`` from the reference's gradients. Under O2 bf16
the trace and the logits are compared at batch 4, where no BatchNorm
averages over only two values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.autograd import tape as jtape
from paddle_tpu.framework.core import Tensor
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.vision import models as tmodels

TOL = 1e-5
E2E_TOL = 2e-3
#: ``layer4`` alone on the reference's input (its BatchNorms over two
#: values a channel; measured 3.0e-4 forward, 1.4e-3 on its input's
#: gradient)
LAYER4_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(arch, **kw):
    paddle.seed(0)
    jm = getattr(jmodels, arch)(**kw)
    tm = getattr(tmodels, arch)(**kw)
    pt.load_jax_state(tm, {k: np.asarray(v.numpy())
                           for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


def _stages(m):
    """The stem, the four layers and the head, as callables."""
    def stem(x):
        return m.maxpool(m.relu(m.bn1(m.conv1(x))))

    def head(x):
        return m.fc(m.avgpool(x).flatten(1))
    return [("stem", stem, [m.conv1, m.bn1]), ("layer1", m.layer1, [m.layer1]),
            ("layer2", m.layer2, [m.layer2]), ("layer3", m.layer3, [m.layer3]),
            ("layer4", m.layer4, [m.layer4]), ("head", head, [m.fc])]


def test_resnet18_train_forward_and_bn_stats_match_reference():
    jm, tm = _pair("resnet18", num_classes=10)
    x, y = _batch(2, 11)
    jlogits = jm(paddle.to_tensor(x))
    jloss = jnn.CrossEntropyLoss()(jlogits, paddle.to_tensor(y))
    tlogits = tm(torch.from_numpy(x))
    tloss = tnn.CrossEntropyLoss()(tlogits, torch.from_numpy(y))
    assert _err(tlogits.detach(), jlogits.numpy()) <= E2E_TOL
    assert _err(tloss.detach(), jloss.numpy()) <= E2E_TOL
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tstate = pt.jax_layout(tm)
    assert list(tstate) == list(jstate)
    for k in jstate:
        assert _err(tstate[k], jstate[k]) <= E2E_TOL, k
    jm.eval()
    tm.eval()
    assert _err(tm(torch.from_numpy(x)).detach(),
                jm(paddle.to_tensor(x)).numpy()) <= E2E_TOL


def test_resnet18_stages_forward_backward_match_reference():
    """Training mode, stage by stage on the reference's inputs: the
    outputs, the BN statistics, and with the reference's cotangent of the
    output, the input's and every parameter's gradient."""
    jm, tm = _pair("resnet18", num_classes=10)
    x, y = _batch(2, 11)
    jst, tst = _stages(jm), _stages(tm)
    ins, outs = [], []
    h = x
    for _, fn, _ in jst:
        leaf = paddle.to_tensor(h, stop_gradient=False)
        ins.append(leaf)
        outs.append(fn(leaf))
        h = np.asarray(outs[-1].numpy())
    jloss = jnn.CrossEntropyLoss()(outs[-1], paddle.to_tensor(y))
    jloss.backward()
    cot = None
    cots = [None] * len(jst)
    for k in reversed(range(len(jst))):
        if k < len(jst) - 1:
            cots[k] = cot
            (outs[k] * paddle.to_tensor(cot)).sum().backward()
        cot = np.asarray(ins[k].grad.numpy())
    for k, ((name, jfn, jmods), (_, tfn, tmods)) in enumerate(zip(jst, tst)):
        tol = LAYER4_TOL if name == "layer4" else TOL
        tin = torch.from_numpy(np.asarray(ins[k].numpy()).copy())
        tin.requires_grad_(True)
        tout = tfn(tin)
        assert _err(tout.detach(), outs[k].numpy()) <= tol, name
        if cots[k] is None:
            tnn.CrossEntropyLoss()(tout, torch.from_numpy(y)).backward()
        else:
            (tout * torch.from_numpy(cots[k])).sum().backward()
        assert _err(tin.grad, ins[k].grad.numpy()) <= tol, name
        for jmod, tmod in zip(jmods, tmods):
            tg = pt.jax_layout(tmod, {n: p.grad for n, p in
                                      tmod.named_parameters()})
            for n, p in jmod.named_parameters():
                assert _err(tg[n], p.grad.numpy()) <= tol, f"{name} {n}"
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tstate = pt.jax_layout(tm)
    for k in (k for k in jstate if k.endswith(("_mean", "_variance"))):
        tol = LAYER4_TOL if k.startswith("layer4") else TOL
        assert _err(tstate[k], jstate[k]) <= tol, k


def test_resnet18_momentum_step_matches_reference():
    """One ``Momentum(0.9, weight_decay=L2Decay(1e-4))`` step from the
    reference's gradients."""
    jm, tm = _pair("resnet18", num_classes=10)
    x, y = _batch(2, 11)
    jnn.CrossEntropyLoss()(jm(paddle.to_tensor(x)),
                           paddle.to_tensor(y)).backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tp = dict(tm.named_parameters())
    for n, g in jgrads.items():
        tp[n].grad = torch.from_numpy(
            np.ascontiguousarray(g.T if g.ndim == 2 else g))
    jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jm.parameters(),
                  weight_decay=jopt.L2Decay(1e-4)).step()
    topt.Momentum(learning_rate=0.1, momentum=0.9, parameters=tm.parameters(),
                  weight_decay=topt.L2Decay(1e-4)).step()
    tstate = pt.jax_layout(tm)
    for k, v in jm.named_parameters():
        assert _err(tstate[k], np.asarray(v.numpy())) <= TOL, k


def test_resnet50_forward_matches_reference():
    jm, tm = _pair("resnet50", num_classes=10)
    jm.eval()
    tm.eval()
    x, _ = _batch(1, 12)
    want = jm(paddle.to_tensor(x)).numpy()
    got = tm(torch.from_numpy(x)).detach()
    assert got.shape == (1, 10)
    assert _err(got, want) <= E2E_TOL
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())


def _dt(d):
    s = str(d).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


def _param_dtypes(model):
    return {n: _dt(p.dtype) for n, p in model.named_parameters()}


def _norm_net(nn):
    return nn.Sequential(nn.Linear(4, 6), nn.LayerNorm(6), nn.ReLU(),
                         nn.Linear(6, 8), nn.GroupNorm(2, 8),
                         nn.BatchNorm1D(8), nn.Linear(8, 2))


@pytest.mark.parametrize("which", ["resnet18", "norm_layers"])
def test_decorate_keeps_norm_layers_fp32_as_the_reference(which):
    if which == "resnet18":
        jm, tm = _pair("resnet18", num_classes=10)
    else:
        jm, tm = _norm_net(jnn), _norm_net(tnn)
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    tamp.decorate(tm, level="O2", dtype="bfloat16")
    want = _param_dtypes(jm)
    assert _param_dtypes(tm) == want
    assert {"bfloat16", "float32"} == set(want.values())
    assert all(_dt(b.dtype) == "float32" for b in tm.buffers())


def test_o2_dtype_trace_and_logits_equal_reference(monkeypatch):
    """PaddleClas's recipe: ``decorate(level="O2", dtype="bfloat16")``,
    the forward and ``CrossEntropyLoss`` under ``auto_cast`` at batch 4:
    the same op names, input dtypes and cast dtypes, call by call, and
    bf16 logits within four bf16 roundoffs of the reference's largest."""
    jm, tm = _pair("resnet18", num_classes=10)
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    tamp.decorate(tm, level="O2", dtype="bfloat16")
    x, y = _batch(4, 13)
    trace, inner = [], jtape._amp_cast_inputs

    def record(name, leaves):
        out = inner(name, leaves)
        if name != "cast":
            trace.append((name, tuple(_dt(a.dtype) for a in leaves
                                      if isinstance(a, Tensor)),
                          tuple(_dt(a.dtype) for a in out
                                if isinstance(a, Tensor))))
        return out

    monkeypatch.setattr(jtape, "_amp_cast_inputs", record)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jlogits = jm(paddle.to_tensor(x))
        jnn.CrossEntropyLoss()(jlogits, paddle.to_tensor(y))
    monkeypatch.setattr(jtape, "_amp_cast_inputs", inner)
    with debugging.collect_operator_stats() as stats:
        with tamp.auto_cast(level="O2", dtype="bfloat16"):
            tlogits = tm(torch.from_numpy(x))
            tnn.CrossEntropyLoss()(tlogits, torch.from_numpy(y))
    got = [(op, tuple(_dt(d) for d in ins), tuple(_dt(d) for d in cs))
           for op, ins, cs in stats.records]
    # the stem's 5, 8 blocks of 9, 3 downsamples of 3, then the pool,
    # flatten, linear and the loss
    assert len(trace) == 5 + 8 * 9 + 3 * 3 + 4
    assert got == trace
    assert tlogits.dtype == torch.bfloat16
    assert _err(tlogits.detach().float(),
                np.asarray(jlogits.numpy(), np.float32)) <= 4 * 2.0 ** -8


def test_layers_refuse_cpu_without_being_asked():
    """The layers' parameters land on the current device, CUDA unless
    ``set_device("cpu")`` was called: without a card a model raises
    rather than moving to the CPU (a fresh process, the default device)."""
    import subprocess
    import sys
    from pathlib import Path
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    code = ("import paddle_tpu_torch as pt\n"
            "try:\n"
            "    pt.vision.models.resnet18()\n"
            "except RuntimeError:\n"
            "    print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "raised", out.stderr
