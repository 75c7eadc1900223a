"""The port's PP-YOLOE training path (``paddle_tpu_torch/models/
ppyoloe.py``) against the reference's: ``ppyoloe_lite(num_classes=4)``
at 2 x 3 x 64 x 64, the reference's weights carried in, the batches of
``examples/train_ppyoloe_pipeline.py``'s dataset (imported from it: the
same augmentation and dense targets). One training-mode step: the
per-level outputs, ``DetectionLoss``, every gradient, BatchNorm's
running statistics, then the parameters after one AdamW step from the
reference's gradients; and the same step on the batch that the port's
``DataLoader`` hands out with two worker processes.
In eval mode: the outputs, ``decode`` on the reference's own outputs
(the sigmoid as ``1 / (1 + exp(-x))``, the anchor points, distance to
box), ``predict`` (boxes, scores and int64 labels after category-aware
NMS, the reference's kept set and order) and ``DetectionLoss`` with its
gradients on the reference's outputs. One file: the reference's model
compiles its eager ops once for all of them.

Tolerances, relative to each tensor's largest magnitude: the outputs,
the loss, the statistics, the AdamW step and the eval checks 1e-5 (measured: 5.8e-6 on
the outputs, the loss equal); the gradients end to end PR 18's
``E2E_TOL`` (2e-3, ``tests/test_torch_resnet.py``) for deep BatchNorm
nets: the backbone's last stage normalizes 2 x 2 maps over a batch of
two (measured 1.4e-5)."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import optimizer as jopt

import paddle_tpu_torch as pt
from paddle_tpu_torch import models as tmodels

from torch_vision_common import (TOL, err, model_pair, npy,  # noqa: F401
                                 port_on_cpu, run_both)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
from train_ppyoloe_pipeline import SyntheticDetection, collate  # noqa: E402

pytestmark = pytest.mark.usefixtures("port_on_cpu")

E2E_TOL = 2e-3


def pair():
    return model_pair(lambda: jmodels.ppyoloe_lite(num_classes=4),
                      lambda: tmodels.ppyoloe_lite(num_classes=4))


def batch_of(ds, idx=(0, 1)):
    return collate([ds[i] for i in idx])


def step(mod, model, batch, to):
    """A training-mode forward, ``DetectionLoss`` and backward of
    ``model`` on ``batch`` (arrays made tensors by ``to``): the per-level
    outputs and the loss."""
    imgs, tcls, treg, mask = batch
    cls, reg = model(to(imgs))
    loss = mod.DetectionLoss()(cls, reg, [to(t) for t in tcls],
                               [to(t) for t in treg], [to(m) for m in mask])
    loss.backward()
    return list(cls) + list(reg), loss


@pytest.fixture(scope="module")
def ref():
    """The reference's model and its one step (the expensive side: its
    eager ops compile one by one), shared by the module's tests."""
    ds = SyntheticDetection(size=4)
    batch = batch_of(ds)
    jm, _ = pair()
    outs, loss = step(jmodels, jm, batch, paddle.to_tensor)
    return dict(ds=ds, batch=batch, outs=[npy(o) for o in outs],
                loss=npy(loss), state={k: np.asarray(v.numpy()) for k, v
                                       in jm.state_dict().items()},
                grads={n: np.asarray(p.grad.numpy())
                       for n, p in jm.named_parameters()}, model=jm)


def _port_step(batch):
    _, tm = pair()
    outs, loss = step(tmodels, tm, batch, torch.from_numpy)
    return tm, outs, loss


def test_train_forward_loss_grads_and_bn_stats(ref):
    tm, outs, loss = _port_step(ref["batch"])
    for t, j in zip(outs, ref["outs"]):
        assert err(npy(t), j) <= TOL
    assert err(npy(loss), ref["loss"]) <= TOL
    grads = pt.jax_layout(tm, {n: p.grad for n, p in tm.named_parameters()})
    assert set(grads) == set(ref["grads"])
    for n, g in ref["grads"].items():
        assert err(grads[n], g) <= E2E_TOL, n
    state = pt.jax_layout(tm)
    assert list(state) == list(ref["state"])
    for k, v in ref["state"].items():
        assert err(state[k], v) <= TOL, k


def test_adamw_step_from_reference_grads(ref):
    jm = ref["model"]
    _, tm = pair()
    for (n, p), (_, jp) in zip(tm.named_parameters(), jm.named_parameters()):
        p.grad = torch.from_numpy(np.array(jp.grad.numpy()))
    pt.load_jax_state(tm, ref["state"])
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = pt.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jo.step()
    to.step()
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tstate = pt.jax_layout(tm)
    for k in jstate:
        assert err(tstate[k], jstate[k]) <= TOL, k
    assert any(err(jstate[k], ref["state"][k]) > 0 for k in jstate)


def test_step_through_two_worker_loader(ref):
    """The port's ``DataLoader`` with two workers and the example's
    collate hands out the collate of the dataset's first two samples;
    the port's step on it equals the reference's step on those arrays."""
    loader = pt.io.DataLoader(ref["ds"], batch_size=2, num_workers=2,
                              collate_fn=collate)
    got = next(iter(loader))
    flat = [got[0]] + [t for group in got[1:] for t in group]
    want = [ref["batch"][0]] + [t for group in ref["batch"][1:]
                                for t in group]
    for g, w in zip(flat, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    assert loader.stats["batches"] == 1
    batch = (got[0].numpy(),) + tuple([t.numpy() for t in group]
                                      for group in got[1:])
    _, _, loss = _port_step(batch)
    assert err(npy(loss), ref["loss"]) <= TOL


def test_chip_smoke_dataset_is_the_examples():
    """``chip_smoke.py``'s numpy copy of the example's dataset (phase
    12(b) feeds PP-YOLOE with it at 640 x 640) gives the example's
    arrays, and its collate the example's batch."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ours = smoke.DetectionData(size=3, img=96, classes=5)
    theirs = SyntheticDetection(size=3, img=96, classes=5)
    got = smoke.detection_collate([ours[i] for i in range(3)])
    want = collate([theirs[i] for i in range(3)])
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def models():
    batch = batch_of(SyntheticDetection(size=2))
    jm, tm = pair()
    jm.eval()
    tm.eval()
    jcls, jreg = jm(paddle.to_tensor(batch[0]))
    heads = {f"c{i}": npy(c) for i, c in enumerate(jcls)}
    heads.update({f"r{i}": npy(r) for i, r in enumerate(jreg)})
    return jm, tm, batch, heads


def test_eval_outputs_and_decode(models):
    jm, tm, batch, heads = models
    tcls, treg = tm(torch.from_numpy(batch[0]))
    for i, t in enumerate(list(tcls) + list(treg)):
        key = f"c{i}" if i < 3 else f"r{i - 3}"
        assert err(npy(t), heads[key]) <= TOL

    def call(model):
        return lambda c0, c1, c2, r0, r1, r2: model.decode([c0, c1, c2],
                                                           [r0, r1, r2])
    scores, boxes = run_both(call(jm), call(tm), heads)
    assert scores.dtype == torch.float32 and boxes.shape == (2, 84, 4)


def test_predict_keeps_reference_detections(models):
    jm, tm, batch, _ = models
    jdets = jm.predict(paddle.to_tensor(batch[0]), score_thresh=0.3,
                       top_k=10)
    tdets = tm.predict(torch.from_numpy(batch[0]), score_thresh=0.3,
                       top_k=10)
    assert len(tdets) == len(jdets) == 2
    for t, j in zip(tdets, jdets):
        assert len(j["labels"]) > 1
        assert t["labels"].dtype == np.int64
        np.testing.assert_array_equal(t["labels"], j["labels"])
        assert err(t["boxes"], j["boxes"]) <= TOL
        assert err(t["scores"], j["scores"]) <= TOL
    empty = tm.predict(torch.from_numpy(batch[0]), score_thresh=1.1)
    assert all(d["boxes"].shape == (0, 4) for d in empty)


def test_loss_on_reference_outputs(models):
    _, _, batch, heads = models
    _, tcls, treg, mask = batch

    def call(mod, to):
        def fn(c0, c1, c2, r0, r1, r2):
            return mod.DetectionLoss()(
                [c0, c1, c2], [r0, r1, r2], [to(t) for t in tcls],
                [to(t) for t in treg], [to(m) for m in mask])
        return fn
    run_both(call(jmodels, paddle.to_tensor),
             call(tmodels, torch.from_numpy), heads, tuple(heads))
