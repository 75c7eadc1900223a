"""The port's ``nn.Layer`` and containers against ``paddle_tpu.nn.layer``:
the same nested model built in both packages gives the same parameter,
buffer, sublayer and ``state_dict`` names in the same order; then
``set_state_dict``, hooks, train/eval, the containers, ``astype`` and
``create_parameter``'s attributes, and torch's own entry points on a
``Layer``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import core as tcore


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _net(nn, zeros):
    """A model with parameters, persistable and non-persistable buffers,
    a shared parameter and every container, in ``nn``'s package."""

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(3, 3)
            self.register_buffer("count", zeros([1]))

        def forward(self, x):
            return self.fc(x)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 3)
            self.bn = nn.BatchNorm1D(3)
            self.register_buffer("steps", zeros([1]))
            self.register_buffer("scratch", zeros([2]), persistable=False)
            self.seq = nn.Sequential(Block(), nn.ReLU(), nn.Linear(3, 2))
            self.blocks = nn.LayerList([nn.Linear(2, 2), nn.LayerNorm(2)])
            self.heads = nn.LayerDict({"a": nn.Linear(2, 1),
                                       "b": nn.Linear(2, 1)})
            self.extra = nn.ParameterList([self.fc1.bias])
            self.drop = nn.Dropout(0.5)

        def forward(self, x):
            x = self.bn(self.fc1(x))
            x = self.seq(x)
            for layer in self.blocks:
                x = layer(x)
            return self.drop(self.heads["a"](x) + self.heads["b"](x))

    return Net()


def _pair():
    return (_net(jnn, lambda s: paddle.zeros(s)),
            _net(tnn, lambda s: torch.zeros(s)))


def test_names_and_order_match_reference():
    j, t = _pair()
    assert [n for n, _ in t.named_parameters()] == [
        n for n, _ in j.named_parameters()]
    assert [n for n, _ in t.named_buffers()] == [
        n for n, _ in j.named_buffers()]
    assert [n for n, _ in t.named_sublayers()] == [
        n for n, _ in j.named_sublayers()]
    assert [n for n, _ in t.named_sublayers(include_self=True)] == [
        n for n, _ in j.named_sublayers(include_self=True)]
    assert len(t.parameters()) == len(j.parameters())
    assert len(t.sublayers()) == len(j.sublayers())
    assert [type(s).__name__ for s in t.sublayers()] == [
        type(s).__name__ for s in j.sublayers()]
    assert isinstance(t.parameters(), list)


def test_state_dict_key_order_is_the_references():
    """Every parameter first (pre-order, each tensor once), then the
    persistable buffers; torch would interleave them layer by layer."""
    j, t = _pair()
    keys = list(t.state_dict())
    assert keys == list(j.state_dict())
    assert keys != list(torch.nn.Module.state_dict(t))
    assert "scratch" not in keys and "steps" in keys
    assert list(t.state_dict(structured_name_prefix="m.")) == [
        "m." + k for k in keys]
    assert list(t.state_dict(include_sublayers=False)) == list(
        j.state_dict(include_sublayers=False))


def test_set_state_dict_reports_missing_and_unexpected():
    j, t = _pair()
    got = []
    for net in (j, t):
        state = {k: np.full(v.shape, 0.5, np.float32)
                 for k, v in net.state_dict().items()}
        state["nope"] = np.zeros(2, np.float32)
        del state["bn._mean"]
        got.append(net.set_state_dict(state))
    (jm, ju), (tm, tu) = got
    assert (tm, tu) == (jm, ju) == (["bn._mean"], ["nope"])
    assert float(t.fc1.weight.sum()) == 0.5 * 12
    assert t.load_dict(dict(t.state_dict())) == ([], [])
    assert t.set_dict({"fc1.bias": torch.ones(3)})[1] == []
    with pytest.raises(ValueError):
        t.set_state_dict({"fc1.bias": np.zeros(4, np.float32)})


def test_hooks_change_inputs_and_outputs_then_go_away():
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    outs = []
    for nn, tensor in ((jnn, paddle.to_tensor), (tnn, torch.from_numpy)):
        layer = nn.Linear(3, 2)
        pre = layer.register_forward_pre_hook(lambda m, inp: (inp[0] * 2,))
        post = layer.register_forward_post_hook(
            lambda m, inp, out: out + 1)
        w = np.arange(6, dtype=np.float32).reshape(3, 2)
        if nn is tnn:
            layer.weight.data.copy_(torch.from_numpy(w.T))
            layer.bias.data.zero_()
        else:
            layer.weight.set_value(w)
            layer.bias.set_value(np.zeros(2, np.float32))
        a = np.asarray(layer(tensor(x)).numpy() if nn is jnn
                       else layer(tensor(x)).detach().numpy())
        pre.remove()
        post.remove()
        b = np.asarray(layer(tensor(x)).numpy() if nn is jnn
                       else layer(tensor(x)).detach().numpy())
        outs.append((a, b))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6)
    np.testing.assert_allclose(outs[1][0], 2 * x @ w + 1, rtol=1e-6)


def test_train_eval_reach_every_sublayer():
    j, t = _pair()
    for net in (j, t):
        net.eval()
        assert not any(s.training for s in net.sublayers(include_self=True))
        net.train()
        assert all(s.training for s in net.sublayers(include_self=True))
    t.train(False)
    assert not t.drop.training
    x = torch.ones(4, 4)
    t.eval()
    torch.testing.assert_close(t(x), t(x))


def test_containers():
    a, b, c = tnn.Linear(2, 2), tnn.ReLU(), tnn.Linear(2, 3)
    seq = tnn.Sequential(a, b, c)
    assert len(seq) == 3 and seq[0] is a and list(seq) == [a, b, c]
    assert list(seq[1:]) == [b, c]
    named = tnn.Sequential([("first", a), ("act", b)])
    assert [n for n, _ in named.named_sublayers()] == ["first", "act"]
    assert seq(torch.ones(1, 2)).shape == (1, 3)
    ll = tnn.LayerList([a])
    ll.append(c).extend([b])
    ll.insert(1, tnn.Identity())
    assert [type(m).__name__ for m in ll] == ["Linear", "Identity", "Linear",
                                              "ReLU"]
    assert len(ll[1:3]) == 2
    ll[0] = b
    assert ll[0] is b
    ld = tnn.LayerDict({"x": a})
    ld.update([("y", c)])
    ld["z"] = b
    del ld["x"]
    assert list(ld.keys()) == ["y", "z"] and ld["y"] is c and len(ld) == 2
    pl = tnn.ParameterList([a.weight])
    pl.append(c.bias)
    assert len(pl) == 2 and pl[1] is c.bias and list(pl) == [a.weight, c.bias]


def test_astype_and_bfloat16_cast_float_params_and_buffers():
    j, t = _pair()
    j.astype("bfloat16")
    t.astype("bfloat16")
    jd = {k: str(v.dtype) for k, v in j.state_dict().items()}
    td = {k: str(v.dtype).replace("torch.", "") for k, v in
          t.state_dict().items()}
    assert td == jd
    t.float()
    assert all(p.dtype == torch.float32 for p in t.parameters())
    t.bfloat16()
    assert t.bn._mean.dtype == torch.bfloat16
    t.to(dtype="float32")
    assert t.fc1.weight.dtype == torch.float32


def test_create_parameter_attrs():
    layer = tnn.Layer()
    attr = pt.ParamAttr(name="w0", initializer=tnn.initializer.Constant(0.5),
                        learning_rate=0.1, trainable=False, need_clip=False)
    p = layer.create_parameter([2, 3], attr=attr)
    assert p.param_attr.name == "w0"
    assert p.optimize_attr == {"learning_rate": 0.1}
    assert not p.requires_grad and p.need_clip is False
    assert torch.equal(p, torch.full((2, 3), 0.5))
    b = layer.create_parameter([3], is_bias=True)
    assert torch.equal(b, torch.zeros(3)) and b.requires_grad
    w = layer.create_parameter([40, 60])
    lim = np.sqrt(6.0 / 100)
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.8 * lim
    assert layer.create_parameter([2], dtype="float16").dtype == torch.float16


def test_misc_names_and_gradients():
    j, t = _pair()
    assert t.full_name().startswith("net_")
    seen = []
    t.apply(lambda m: seen.append(type(m).__name__))
    assert seen[:3] == ["Net", "Linear", "BatchNorm1D"]
    assert seen == [type(m).__name__ for m in t.sublayers(include_self=True)]
    t(torch.ones(4, 4)).sum().backward()
    assert t.fc1.weight.grad is not None
    t.clear_gradients()
    assert all(p.grad is None for p in t.parameters())
    assert "in_features=4" in repr(t.fc1)
    assert t.parameters(include_sublayers=False) == []
    assert [n for n, _ in t.named_parameters(recurse=False)] == []


def test_torch_entry_points_still_work_on_a_layer():
    """A plain ``torch.nn.Module`` holding Layers: its ``state_dict``
    reaches the Layers' (in their order), ``load_state_dict`` and
    ``.to`` work, optimizers take ``parameters()``."""
    j, t = _pair()
    outer = torch.nn.Sequential(t)
    sd = outer.state_dict()
    assert list(sd) == ["0." + k for k in t.state_dict()]
    # the reference's state_dict lists the shared bias once
    res = outer.load_state_dict(sd, strict=False)
    assert res.missing_keys == ["0.extra.0"] and not res.unexpected_keys
    opt = torch.optim.SGD(t.parameters(), lr=0.1)
    t(torch.ones(4, 4)).sum().backward()
    opt.step()
    t.to("cpu", torch.float64)
    assert t.fc1.weight.dtype == torch.float64
