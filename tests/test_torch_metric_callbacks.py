"""The port's ``paddle.metric`` and ``paddle.callbacks`` against the
reference's (``paddle_tpu/metric/__init__.py``, ``paddle_tpu/
callbacks.py``) on the CPU: metric values on the same predictions, the
hook sequence ``Model.fit`` drives, and ``EarlyStopping``'s and
``ReduceLROnPlateau``'s decisions on one loss sequence."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import callbacks as jcb
from paddle_tpu import metric as jmetric

import paddle_tpu_torch as pt
from paddle_tpu_torch import callbacks as tcb
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.framework import core as tcore


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _scores(seed, n=40, c=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, (n, 1)).astype(np.int64))


def _np(x):
    return x.numpy() if isinstance(x, (paddle.Tensor, torch.Tensor)) \
        else np.asarray(x)


@pytest.mark.parametrize("topk", [1, (1, 5), (2, 3)])
def test_accuracy_matches_reference(topk):
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _scores(seed)
        jc = jm.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(_np(tc), _np(jc))
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == "acc"
    tm.reset()
    assert tm.count == [0] * len(tm.topk)


def test_accuracy_function_matches_reference():
    pred, label = _scores(4)
    for k in (1, 3):
        want = paddle.metric.accuracy(paddle.to_tensor(pred),
                                      paddle.to_tensor(label), k=k)
        got = tmetric.accuracy(torch.from_numpy(pred),
                               torch.from_numpy(label), k=k)
        assert float(got) == float(_np(want))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(name):
    jm, tm = getattr(jmetric, name)(), getattr(tmetric, name)()
    rng = np.random.RandomState(5)
    for _ in range(3):
        p = rng.rand(30, 1).astype(np.float32)
        y = (rng.rand(30, 1) > 0.4).astype(np.int64)
        jm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        tm.update(torch.from_numpy(p), torch.from_numpy(y))
    assert tm.accumulate() == pytest.approx(jm.accumulate(), abs=1e-12)
    assert tm.name() == jm.name()


class Recorder:
    """A callback mixin recording each hook's name, its step or epoch and
    the logs' keys."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def _rec(self, name, *args):
        logs = args[-1] or {}
        head = [a for a in args[:-1]]
        self.seen.append((name, *head, tuple(sorted(logs))))

    def on_train_begin(self, logs=None):
        self._rec("train_begin", logs)

    def on_train_end(self, logs=None):
        self._rec("train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._rec("epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._rec("epoch_end", epoch, logs)

    def on_train_batch_begin(self, step, logs=None):
        self._rec("batch_begin", step, logs)

    def on_train_batch_end(self, step, logs=None):
        self._rec("batch_end", step, logs)

    def on_eval_begin(self, logs=None):
        self._rec("eval_begin", logs)

    def on_eval_end(self, logs=None):
        self._rec("eval_end", logs)


def _data(n=10):
    rng = np.random.RandomState(6)
    return [(rng.randn(3).astype(np.float32), np.int64(rng.randint(0, 2)))
            for _ in range(n)]


def _fit(lib, cb_mod, tmp, **kw):
    rec = type("Rec", (Recorder, cb_mod.Callback), {})()
    lin = lib.nn.Linear(3, 2)
    model = lib.Model(lin)
    opt = lib.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    model.prepare(opt, lib.nn.CrossEntropyLoss(), lib.metric.Accuracy())
    model.fit(_data(), eval_data=_data(4), batch_size=4, epochs=2,
              shuffle=False, verbose=0, callbacks=[rec], save_dir=tmp, **kw)
    return rec.seen


def test_fit_drives_the_reference_hook_sequence(tmp_path):
    want = _fit(paddle, jcb, str(tmp_path / "ref"))
    got = _fit(pt, tcb, str(tmp_path / "port"))
    assert got == want
    assert ("eval_end", ("acc", "loss")) in got
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    assert _fit(pt, tcb, None, num_iters=4)[-2:] == _fit(
        paddle, jcb, None, num_iters=4)[-2:]


LOSSES = [1.0, 0.9, 0.95, 0.91, 0.92, 0.7, 0.71, 0.72, 0.73, 0.74, 0.69,
          0.75, 0.76]


def _early(cb_mod, **kw):
    cb = cb_mod.EarlyStopping(**kw)
    out = []
    for v in LOSSES:
        cb.on_eval_end({"loss": v, "acc": [1 - v]})
        out.append((cb.best, cb.wait, cb.stop_training))
    return out


@pytest.mark.parametrize("kw", [dict(patience=2), dict(patience=3,
                                                      min_delta=0.05),
                                dict(monitor="acc", patience=1),
                                dict(patience=2, baseline=0.8)])
def test_early_stopping_decides_as_the_reference(kw):
    assert _early(tcb, **kw) == _early(jcb, **kw)


def _plateau(lib, cb_mod, **kw):
    w = lib.to_tensor(np.ones(2, np.float32))
    opt = lib.optimizer.SGD(learning_rate=1.0, parameters=[w])
    cb = cb_mod.ReduceLROnPlateau(verbose=0, **kw)
    cb.set_model(type("M", (), {"_optimizer": opt})())
    out = []
    for v in LOSSES:
        cb.on_eval_end({"loss": v})
        out.append(opt.get_lr())
    return out


@pytest.mark.parametrize("kw", [dict(patience=2), dict(patience=1,
                                                      cooldown=2,
                                                      factor=0.5),
                                dict(patience=2, min_lr=0.05)])
def test_reduce_lr_on_plateau_decides_as_the_reference(kw):
    assert _plateau(pt, tcb, **kw) == pytest.approx(
        _plateau(paddle, jcb, **kw), rel=1e-12)


def test_lr_scheduler_and_log_writer_callbacks(tmp_path):
    lin = pt.nn.Linear(3, 2)
    sched = pt.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    model = pt.Model(lin)
    model.prepare(pt.optimizer.SGD(learning_rate=sched,
                                   parameters=lin.parameters()),
                  pt.nn.CrossEntropyLoss())
    writer = tcb.LogWriterCallback(str(tmp_path))
    model.fit(_data(8), batch_size=4, epochs=1, shuffle=False, verbose=0,
              callbacks=[tcb.LRScheduler(), writer])
    assert sched.last_epoch == 2
    rows = [json.loads(r) for r in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
