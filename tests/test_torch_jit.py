"""``paddle.jit.to_static`` in the port (``paddle_tpu_torch/jit/api.py``,
``torch.compile``) against the reference's (``paddle_tpu/jit/api.py``,
``jax.jit``) and against the port's eager forward, on the CPU:

* a ``llama_tiny`` training step (head_dim 64, 128 tokens: the flash
  route) compiled: loss and every gradient within 1e-5 (relative to each
  tensor's largest magnitude) of the port's eager step and of the
  reference's compiled one; the compiled graph calls the flash custom ops
  (``paddle_tpu_torch::flash_fwd``, whose registered backward is B2 and
  B3) and no PyTorch attention, and their CPU implementations run;
* a small BatchNorm network: forward, gradients and the running
  statistics after compiled training steps equal to eager ones (C32),
  the training flag a key of its own;
* the spec cache's hits and misses counted as the reference counts them;
* a data-dependent branch (dynamo splits the graph; ``full_graph=True``
  raises), AMP state changes (dynamo recompiles, ROADMAP C35), dropout
  under a seed (C2), and ``torch.library.opcheck`` of the three flash
  ops' CPU implementations.

Each ``torch.compile`` here compiles a tiny module (six with inductor,
one more with dynamo's ``eager`` backend): the first, the Llama step,
takes ~15-25 s on one core."""
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import api as japi
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.jit import api as tapi
from paddle_tpu_torch.ops import flash_attention as tfa
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)

CFG = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
           num_hidden_layers=2, intermediate_size=256,
           max_position_embeddings=256)
BATCH, SEQ = 2, 128
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jcount(event):
    return japi._jit_metrics()["cache"].value(event=event)


class GraphRecorder:
    """A ``torch.compile`` backend that keeps the ops of each graph dynamo
    hands it, then compiles with inductor."""

    def __init__(self):
        self.targets = []

    def __call__(self, gm, example_inputs):
        from torch._inductor.compile_fx import compile_fx
        self.targets += [str(n.target) for n in gm.graph.nodes
                         if n.op == "call_function"]
        return compile_fx(gm, example_inputs)


class PlainCalls:
    """Counts the runs of the flash ops' CPU implementations (their plain
    versions, looked up in the module at run time)."""

    NAMES = ("flash_attention_plain", "flash_bwd_dq_plain",
             "flash_bwd_dkv_plain")

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            orig = getattr(tfa, name)

            def counted(*a, _orig=orig, _name=name, **k):
                self.counts[_name] += 1
                return _orig(*a, **k)

            monkeypatch.setattr(tfa, name, counted)


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (BATCH, SEQ)).astype(np.int64),
            rng.randint(0, 128, (BATCH, SEQ)).astype(np.int64))


def _port_step(model, ids, labels):
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = pt.jax_layout(model, {n: p.grad.clone()
                                  for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), logits.detach().numpy(), grads


@pytest.fixture(scope="module")
def llama(_no_reference_mesh):
    """The reference's compiled step, the port's eager step and the port's
    compiled step (twice: a miss, then a hit) on shared weights."""
    mp = pytest.MonkeyPatch()
    try:
        paddle.seed(0)
        jm = JaxLlama(jtiny(**CFG))
        arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        ids, labels = _batch()
        h0, m0 = _jcount("hit"), _jcount("miss")
        jm = paddle.jit.to_static(jm)
        jsteps = []
        for _ in range(2):
            jloss, jlogits = jm(paddle.to_tensor(ids),
                                labels=paddle.to_tensor(labels))
            jloss.backward()
            jsteps.append((float(jloss.numpy()), np.asarray(jlogits.numpy()),
                           {n: np.asarray(p.grad.numpy())
                            for n, p in jm.named_parameters()}))
            jm.clear_gradients()
        jcounts = (_jcount("hit") - h0, _jcount("miss") - m0)
        tm = pt.load_jax_state(pt.LlamaForCausalLM(pt.llama_tiny(**CFG),
                                                   device="cpu"), arrays)
        tm.train()
        eager = _port_step(tm, ids, labels)
        tapi.reset_metrics()
        rec = GraphRecorder()
        pt.jit.to_static(tm, backend=rec)
        plain = PlainCalls(mp)
        compiled = [_port_step(tm, ids, labels) for _ in range(2)]
        return dict(jax=jsteps, jcounts=jcounts, eager=eager,
                    compiled=compiled, metrics=dict(tapi.METRICS),
                    targets=rec.targets, plain=dict(plain.counts))
    finally:
        mp.undo()


@pytest.mark.parametrize("step", [0, 1])
def test_compiled_llama_step_matches_eager_and_reference(llama, step):
    closs, clogits, cgrads = llama["compiled"][step]
    for name, (loss, logits, grads) in (("eager", llama["eager"]),
                                        ("reference", llama["jax"][step])):
        assert abs(closs - loss) <= GRAD_RTOL * abs(loss), name
        assert _rel(clogits, logits) <= GRAD_RTOL, name
        assert set(cgrads) == set(grads)
        for k, want in grads.items():
            assert _rel(cgrads[k], want) <= GRAD_RTOL, (name, k)


def test_compiled_llama_runs_the_flash_custom_ops(llama):
    targets = llama["targets"]
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == \
        CFG["num_hidden_layers"]
    assert not [t for t in targets if "attention" in t or "sdpa" in t
                or "flash" in t and "paddle_tpu_torch" not in t]
    # two compiled steps: each layer's forward, dq and dkv once a step
    assert llama["plain"] == dict.fromkeys(PlainCalls.NAMES,
                                           2 * CFG["num_hidden_layers"])


def test_spec_cache_counts_match_the_reference(llama):
    m = llama["metrics"]
    assert (m["hit"], m["miss"]) == llama["jcounts"] == (1, 1)
    assert m["breaks"] == 0 and m["recompiles"] == 0
    assert len(m["compile_s"]) == 1 and m["compile_s"][0] > 0


def _bn_net(lib):
    nn = lib.nn
    return nn.Sequential(nn.Linear(6, 8), nn.BatchNorm1D(8), nn.ReLU(),
                         nn.Linear(8, 3))


def _bn_run(net, xs):
    outs, grads = [], []
    for x in xs:
        out = net(torch.from_numpy(x))
        (out * out).sum().backward()
        outs.append(out.detach().numpy())
        grads.append({n: p.grad.clone().numpy()
                      for n, p in net.named_parameters()})
        net.clear_gradients()
    stats = {n: b.clone().numpy() for n, b in net.named_buffers()}
    return outs, grads, stats


def test_batchnorm_net_compiled_equals_eager_with_its_buffers():
    rng = np.random.RandomState(1)
    xs = [rng.randn(5, 6).astype(np.float32) for _ in range(3)]
    pt.seed(3)
    ref = _bn_net(pt)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    net = _bn_net(pt)
    net.set_state_dict(state)
    want = _bn_run(ref, xs)
    tapi.reset_metrics()
    pt.jit.to_static(net)
    got = _bn_run(net, xs)
    for a, b in zip(got[0] + [got[2]], want[0] + [want[2]]):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for ga, gb in zip(got[1], want[1]):
        # 0.bias feeds the BatchNorm: its gradient is ~0, so every grad is
        # held to the step's largest
        top = max(np.abs(g).max() for g in gb.values())
        for k in gb:
            assert np.abs(ga[k] - gb[k]).max() <= GRAD_RTOL * top, k
    assert set(got[2]) == {"1._mean", "1._variance"}
    assert not np.allclose(got[2]["1._mean"], 0)     # the update happened
    # the training flag is part of the key, as in the reference
    net.eval()
    ref.eval()
    x = torch.from_numpy(xs[0])
    np.testing.assert_allclose(net(x).detach().numpy(),
                               ref(x).detach().numpy(), rtol=1e-5, atol=1e-6)
    assert (tapi.METRICS["hit"], tapi.METRICS["miss"]) == (2, 2)


def _branchy(x):
    if x.sum() > 0:                     # data-dependent Python control flow
        return x * 2
    return x - 1


def test_data_dependent_branch_breaks_the_graph_and_stays_right():
    tapi.reset_metrics()
    f = pt.jit.to_static(_branchy)
    pos, neg = torch.ones(3), -torch.ones(3)
    assert torch.equal(f(pos), pos * 2) and torch.equal(f(neg), neg - 1)
    assert tapi.METRICS["breaks"] >= 1
    assert (tapi.METRICS["hit"], tapi.METRICS["miss"]) == (1, 1)
    # a frame of its own: dynamo caches compiled code by code object
    strict = pt.jit.to_static(lambda x: _branchy(x), full_graph=True)
    with pytest.raises(torch._dynamo.exc.Unsupported):
        strict(torch.full((3,), 2.0))


class Mlp(pt.nn.Layer):
    def __init__(self, dropout=0.0):
        super().__init__()
        self.fc1 = pt.nn.Linear(8, 16)
        self.drop = pt.nn.Dropout(dropout)
        self.fc2 = pt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(self.drop(pt.nn.functional.relu(self.fc1(x))))


class Doubler(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = pt.nn.Linear(4, 4)

    @pt.jit.to_static(backend="eager")
    def double(self, x):
        return self.fc(x) * 2


def test_a_decorated_method_binds_per_instance_without_keeping_it():
    """The bound function lives in its instance: one binding an instance,
    a deep copy bound to the copy, and the instance free to go."""
    pt.seed(3)
    a, b = Doubler(), Doubler()
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 4)
                         .astype(np.float32))
    assert a.double is a.double and a.double is not b.double
    want = (a.fc(x) * 2).detach()
    assert torch.equal(a.double(x).detach(), want)
    c = copy.deepcopy(a)
    assert c.double is not a.double
    with torch.no_grad():
        c.fc.weight.zero_()
    assert torch.equal(c.double(x).detach(), (c.fc(x) * 2).detach())
    assert torch.equal(a.double(x).detach(), want)
    gone = weakref.ref(a)
    del a
    gc.collect()
    assert gone() is None


def test_amp_state_change_recompiles_as_eager_follows_it():
    """C35: the reference's spec key omits the AMP state, so a program
    traced without AMP is reused under ``auto_cast``; dynamo guards on
    the port's AMP state and recompiles, so the compiled forward follows
    the state as the eager one does."""
    pt.seed(5)
    net = Mlp()
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 8)
                         .astype(np.float32))
    eager32 = net(x).detach()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        eager16 = net(x).detach()
    assert eager16.dtype == torch.bfloat16
    tapi.reset_metrics()
    pt.jit.to_static(net)
    assert torch.equal(net(x).detach(), eager32)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = net(x).detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), eager16.float().numpy(),
                               rtol=2 ** -7, atol=2 ** -7)
    assert tapi.METRICS["hit"] == 1 and tapi.METRICS["recompiles"] >= 1


def test_reference_reuses_its_program_across_amp_states():
    """The reference's side of C35, as its own witness."""
    paddle.seed(5)
    net = paddle.nn.Linear(8, 4)
    x = paddle.to_tensor(np.random.RandomState(2).randn(4, 8)
                         .astype(np.float32))
    sf = paddle.jit.to_static(net)
    plain = sf(x)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        again = sf(x)
        eager = net._dygraph_forward(x)
    assert str(again.dtype) == str(plain.dtype) == "float32"
    assert str(eager.dtype) == "bfloat16"


def test_dropout_under_a_seed_reproduces_in_compiled_steps():
    """C2: random ops reproduce within the port; dropout draws from the
    port's generator inside the compiled region."""
    pt.seed(7)
    net = Mlp(dropout=0.5)
    net.train()
    x = torch.ones(4, 8)
    tapi.reset_metrics()
    pt.jit.to_static(net)
    pt.seed(11)
    a = net(x).detach()
    pt.seed(11)
    b = net(x).detach()
    c = net(x).detach()
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert tapi.METRICS["miss"] == 1


@pytest.mark.parametrize("kernel_layout", [True, False])
def test_flash_ops_pass_opcheck(kernel_layout):
    rng = np.random.RandomState(4)
    shape = (1, 2, 16, 64) if kernel_layout else (1, 16, 2, 64)
    kv_shape = (1, 1, 16, 64) if kernel_layout else (1, 16, 1, 64)
    q = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(*kv_shape).astype(np.float32))
            for _ in range(2))
    args = (q, k, v, True, 0.125, 0, 0, kernel_layout)
    torch.library.opcheck(tfa.flash_fwd, args)
    out, lse = tfa.flash_fwd(*args)
    dout = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    delta = tfa.bwd_delta(out, dout, None, kernel_layout)
    bargs = (q, k, v, dout, lse, delta, True, 0.125, 0, 0, kernel_layout)
    torch.library.opcheck(tfa.flash_bwd_dq, bargs)
    torch.library.opcheck(tfa.flash_bwd_dkv, bargs)
    grad_args = tuple(t.clone().requires_grad_() for t in (q, k, v))
    torch.library.opcheck(tfa.flash_fwd, grad_args + args[3:])
