"""``paddle.Model``, ``summary`` and ``flops`` in the port
(``paddle_tpu_torch/hapi.py``) against the reference's
(``paddle_tpu/hapi.py``) on the CPU: one small conv network (conv,
BatchNorm, pooling, linear) in both packages with the reference's weights
carried across (``load_jax_state``), ``fit`` on the same unshuffled
samples (a partial last batch, two epochs, ``Momentum``, ``Accuracy``):
every step's loss within 1e-5 (relative) of the reference's, the
metrics equal; then ``evaluate``, ``predict``, ``train_batch``,
``eval_batch``, ``save``/``load`` (the reference's checkpoint read by the
port), ``summary`` and ``flops``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import callbacks as jcb

import paddle_tpu_torch as pt
from paddle_tpu_torch import callbacks as tcb
from paddle_tpu_torch.framework import core as tcore
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)

LOSS_RTOL = 1e-5
N, BATCH, EPOCHS = 10, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _net(lib):
    nn = lib.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.MaxPool2D(2), nn.Flatten(),
                         nn.Linear(4 * 4 * 4, 5))


def _samples(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, 8, 8).astype(np.float32),
             np.int64(rng.randint(0, 5))) for _ in range(n)]


def _models():
    paddle.seed(0)
    jnet = _net(paddle)
    arrays = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tnet = pt.load_jax_state(_net(pt), arrays)
    return jnet, tnet


def _prepare(lib, net):
    model = lib.Model(net)
    opt = lib.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                 parameters=net.parameters(),
                                 weight_decay=lib.optimizer.L2Decay(1e-3))
    model.prepare(opt, lib.nn.CrossEntropyLoss(),
                  lib.metric.Accuracy(topk=(1, 2)))
    return model


def _losses(cb_mod):
    class Losses(cb_mod.Callback):
        def __init__(self):
            super().__init__()
            self.steps = []

        def on_train_batch_end(self, step, logs=None):
            self.steps.append((logs["loss"], logs["acc"]))

    return Losses()


@pytest.fixture(scope="module")
def fitted(_no_reference_mesh):
    jnet, tnet = _models()
    jm, tm = _prepare(paddle, jnet), _prepare(pt, tnet)
    jl, tl = _losses(jcb), _losses(tcb)
    jm.fit(_samples(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
           verbose=0, callbacks=[jl])
    tm.fit(_samples(), batch_size=BATCH, epochs=EPOCHS, shuffle=False,
           verbose=0, callbacks=[tl])
    return jm, tm, jl.steps, tl.steps


def test_fit_losses_match_the_reference(fitted):
    _, _, want, got = fitted
    assert len(got) == len(want) == EPOCHS * 3
    for (gl, ga), (wl, wa) in zip(got, want):
        assert abs(gl - wl) <= LOSS_RTOL * abs(wl)
        assert ga == pytest.approx(wa, abs=1e-12)


def test_evaluate_and_predict_match_the_reference(fitted):
    jm, tm, _, _ = fitted
    data = _samples(1, 6)
    ev_j = jm.evaluate(data, batch_size=4, verbose=0)
    ev_t = tm.evaluate(data, batch_size=4, verbose=0)
    assert set(ev_t) == set(ev_j) == {"acc", "loss"}
    assert ev_t["loss"] == pytest.approx(ev_j["loss"], rel=1e-5)
    assert ev_t["acc"] == ev_j["acc"]
    pj = jm.predict(data, batch_size=4, stack_outputs=True)[0]
    pt_ = tm.predict(data, batch_size=4, stack_outputs=True)[0]
    assert pt_.shape == pj.shape == (6, 5)
    np.testing.assert_allclose(pt_, pj, rtol=1e-5,
                               atol=1e-5 * np.abs(pj).max())
    assert len(tm.predict(data, batch_size=4)[0]) == 2


def test_train_and_eval_batch_match_the_reference():
    jnet, tnet = _models()
    jm, tm = _prepare(paddle, jnet), _prepare(pt, tnet)
    x = np.stack([s[0] for s in _samples(2, 4)])
    y = np.array([[s[1]] for s in _samples(2, 4)])
    for _ in range(2):
        (jl,) = jm.train_batch(paddle.to_tensor(x), paddle.to_tensor(y))
        (tl,) = tm.train_batch(torch.from_numpy(x), torch.from_numpy(y))
        assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    (jl,) = jm.eval_batch(paddle.to_tensor(x), paddle.to_tensor(y))
    (tl,) = tm.eval_batch(torch.from_numpy(x), torch.from_numpy(y))
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    (pp,) = tm.predict_batch(torch.from_numpy(x))
    assert pp.shape == (4, 5)


def _assert_same_weights(got, want, what):
    for (name, a), b in zip(want.state_dict().items(),
                            got.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{what} {name}")


def test_save_and_load(fitted, tmp_path):
    """The port's checkpoint round trip through ``Model.load``; the
    reference's ``.pdparams`` read by ``paddle.load`` and carried by
    ``load_jax_state`` (its Linear weights are ``[in, out]``, ROADMAP
    C3)."""
    jm, tm, _, _ = fitted
    tm.save(str(tmp_path / "port"))
    _, fresh = _models()
    m = _prepare(pt, fresh)
    m.load(str(tmp_path / "port"))
    _assert_same_weights(fresh, tm.network, "port")
    assert m._optimizer.state_dict().keys() == \
        tm._optimizer.state_dict().keys()
    jm.save(str(tmp_path / "ref"))
    _, fresh = _models()
    pt.load_jax_state(fresh, pt.load(str(tmp_path / "ref.pdparams"),
                                     return_numpy=True))
    _assert_same_weights(fresh, tm.network, "reference")


def test_summary_and_flops_match_the_reference(capsys):
    jnet, tnet = _models()
    assert pt.summary(tnet) == paddle.summary(jnet)
    size = (2, 3, 8, 8)
    assert pt.flops(tnet, size) == paddle.flops(jnet, size) > 0
    assert tnet.training
    single = pt.nn.Linear(6, 3)
    assert pt.flops(single, (4, 6)) == paddle.flops(paddle.nn.Linear(6, 3),
                                                    (4, 6)) == 4 * 3 * 7


def test_prepare_ignores_amp_configs():
    _, tnet = _models()
    m = pt.Model(tnet)
    m.prepare(None, None, None, amp_configs={"level": "O2"})
    assert m._metrics == [] and not m._pad_partial_enabled()
