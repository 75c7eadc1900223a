"""The port's data parallelism, hybrid topology and autograd callbacks
against the reference's.

* The grad-ready and post-backward callbacks (``autograd/callbacks.py``)
  on the cases of the reference's ``tests/test_comm_overlap.py:31-110``.
* ``CommunicateTopology``'s coordinates and comm lists, and the hybrid
  group of a 4-rank world under ``fleet.init`` with ``{dp 2, mp 2}`` and
  ``{pp 2, sharding 2}``, against the reference's (exact).
* ``DistributedStrategy.to_dict`` against the reference's.
* ``DataParallel``'s gradient sync and ``no_sync``
  (``tests/test_distributed.py:256-287``) in the same world, its pairs
  [0, 1] and [2, 3] standing for the reference's world of 2, against the
  reference's simulator on the same inputs (exact).

``tests/test_torch_dist_llama.py`` trains the Llama at dp 2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import fleet as rfleet
from paddle_tpu.distributed.fleet import topology as rtopology

import paddle_tpu_torch as pt
from paddle_tpu_torch import autograd
from paddle_tpu_torch.distributed import fleet
import torch_dist_workers as workers
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_fleet_untouched():
    """No test here installs the reference's fleet strategy or hybrid
    group; checked at the end, and put back if one did."""
    saved = (rfleet._strategy, rfleet._initialized[0], rtopology._hcg)
    yield
    now = (rfleet._strategy, rfleet._initialized[0], rtopology._hcg)
    rfleet._strategy, rfleet._initialized[0], rtopology._hcg = saved
    assert now == saved


# -- the autograd callbacks


def _net():
    pt.set_device("cpu")
    torch.manual_seed(0)
    return pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Tanh(),
                            pt.nn.Linear(8, 2))


def _loss(net):
    return (net(torch.ones(3, 4)) ** 2).mean()


def test_grad_ready_fires_once_per_leaf_in_finality_order():
    net = _net()
    params = list(net.parameters())
    fired, ready = [], []

    def cb(t):
        fired.append(t)
        ready.append(t.grad is not None)
    autograd.register_grad_ready_callback(cb, params)
    try:
        _loss(net).backward()
    finally:
        autograd.unregister_grad_ready_callback(cb)
    ids = [id(t) for t in fired]
    assert len(ids) == len(set(ids)) == len(params)
    assert set(ids) == {id(p) for p in params}
    assert all(ready)
    assert ids.index(id(params[2])) < ids.index(id(params[0]))
    _loss(net).backward()                 # unregistered: no more calls
    assert len(fired) == len(params)


def test_grad_ready_fires_again_with_retain_graph():
    net = _net()
    fired = []
    autograd.register_grad_ready_callback(fired.append, net.parameters())
    try:
        loss = _loss(net)
        loss.backward(retain_graph=True)
        n1 = len(fired)
        loss.backward()
    finally:
        autograd.unregister_grad_ready_callback(fired.append)
    assert n1 == 4 and len(fired) == 8


def test_autograd_grad_does_not_fire():
    net = _net()
    fired = []
    autograd.register_grad_ready_callback(fired.append, net.parameters())
    try:
        loss = _loss(net)
        (g,) = autograd.grad(loss, [net[0].weight], create_graph=True)
        assert not fired
        (g ** 2).sum().backward()
    finally:
        autograd.unregister_grad_ready_callback(fired.append)
    assert fired and all(t.grad is not None for t in fired)


def test_unused_leaf_does_not_fire():
    used = torch.nn.Parameter(torch.ones(4, 2))
    unused = torch.nn.Parameter(torch.ones(4, 2))
    fired = []
    autograd.register_grad_ready_callback(fired.append, [used, unused])
    try:
        (torch.ones(3, 4) @ used).sum().backward()
    finally:
        autograd.unregister_grad_ready_callback(fired.append)
    assert [id(t) for t in fired] == [id(used)]


def test_post_backward_fires_once_after_the_last_leaf():
    net = _net()
    params = list(net.parameters())
    events = []
    ready = autograd.register_grad_ready_callback(
        lambda t: events.append("ready"), params)

    def post():
        events.append(("post", all(p.grad is not None for p in params)))
    autograd.register_post_backward_callback(post, params)
    try:
        _loss(net).backward()
        assert events == ["ready"] * 4 + [("post", True)]
        autograd.grad(_loss(net), params)
        assert len(events) == 5            # no accumulation, no flush
        _loss(net).backward()
        assert events[5:] == ["ready"] * 4 + [("post", True)]
    finally:
        autograd.unregister_grad_ready_callback(ready)
        autograd.unregister_post_backward_callback(post)
    _loss(net).backward()
    assert len(events) == 10


# -- the topology and the strategy, no processes

DEGREE_SETS = [[1, 1, 1, 1, 1], [2, 1, 1, 1, 2], [1, 2, 2, 1, 1],
               [2, 2, 1, 2, 1], [3, 1, 2, 1, 2]]


@pytest.mark.parametrize("dims", DEGREE_SETS, ids=str)
def test_topology_equals_the_reference(dims):
    got = fleet.CommunicateTopology(dims=dims)
    want = rfleet.CommunicateTopology(dims=dims)
    assert got.world_size() == want.world_size()
    for name in want.get_hybrid_group_names():
        assert got.get_comm_list(name) == want.get_comm_list(name)
        assert got.get_dim(name) == want.get_dim(name)
        for i in range(want.get_dim(name)):
            assert got.get_axis_list(name, i) == want.get_axis_list(name, i)
    for r in range(want.world_size()):
        coord = want.get_coord(r)
        assert got.get_coord(r) == coord
        assert got.get_rank(**dict(zip(want.get_hybrid_group_names(),
                                       coord))) == r


def _strategies(mod):
    default = mod.DistributedStrategy()
    s = mod.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 4,
                        "pp_configs": {"micro_batch_size": 4}}
    s.amp = True
    s.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    s.recompute = True
    s.fuse_grad_size_in_MB = 8
    s.comm_quantization = "int8"
    s.comm_configs = {"error_feedback": True}
    s.comm_overlap = False
    return default, s


def test_strategy_to_dict_equals_the_reference():
    for got, want in zip(_strategies(fleet), _strategies(rfleet)):
        assert got.to_dict() == want.to_dict()
        assert got.degrees() == want.degrees()
        back = fleet.DistributedStrategy.from_dict(got.to_dict())
        assert back.to_dict() == got.to_dict()


# -- the hybrid group on a 4-rank world


@pytest.fixture(scope="module")
def hcg_port():
    return workers.run_world(workers.hcg_world, 4)


@pytest.mark.parametrize("degrees", workers.HCG_DEGREES, ids=str)
def test_hybrid_group_equals_the_reference(hcg_port, degrees):
    key = tuple(sorted(degrees.items()))
    dims = [degrees.get(f"{a}_degree", 1)
            for a in ("dp", "pp", "sharding", "sep", "mp")]

    def worker():
        return workers._hcg_view(rfleet.HybridCommunicateGroup(
            rfleet.CommunicateTopology(dims=dims)))
    ref = rdist.spawn(worker, nprocs=4).results
    for r in range(4):
        view = hcg_port[r][key]
        for k in ("groups", "sizes", "coords", "src"):
            assert view[k] == ref[r][k], (r, k)
            assert view["explicit"][k] == ref[r][k], (r, k)
        # the mesh's axes, and an all-reduce over each axis's group
        assert [view["axes"][a][0] for a in ("dp", "pp", "sharding", "sep",
                                             "mp")] == dims
        for name, ranks in view["groups"].items():
            if name in view["sums"]:
                assert view["sums"][name] == float(sum(ranks))
    assert all("8c" in hcg_port[r]["pp_model"] for r in range(4))
    assert [hcg_port[r]["worker"] for r in range(4)] == [
        (r, 4, r == 0) for r in range(4)]


# -- DataParallel, the reference's world of 2 as two pairs of the world of 4


def _r_grad_sync():
    paddle.seed(5)
    model = rdist.DataParallel(jnn.Linear(3, 1, bias_attr=False))
    x = paddle.to_tensor(np.full((2, 3), float(rdist.get_rank() + 1),
                                 "float32"))
    model(x).sum().backward()
    return model._layers.weight.grad.numpy().copy()


def _r_no_sync():
    model = rdist.DataParallel(jnn.Linear(3, 1, bias_attr=False))
    x = paddle.to_tensor(np.full((2, 3), float(rdist.get_rank() + 1),
                                 "float32"))
    with model.no_sync():
        model(x).sum().backward()
    return model._layers.weight.grad.numpy().copy()


@pytest.mark.parametrize("case,worker,want", [
    ("grad_sync", _r_grad_sync, [np.full((3, 1), 3.0)] * 2),
    ("no_sync", _r_no_sync, [np.full((3, 1), 2.0), np.full((3, 1), 4.0)])])
def test_data_parallel_equals_the_reference(hcg_port, case, worker, want):
    ref = rdist.spawn(worker, nprocs=2).results
    for r in range(4):
        np.testing.assert_array_equal(hcg_port[r][case], ref[r % 2])
        np.testing.assert_array_equal(hcg_port[r][case], want[r % 2])


def test_no_sync_then_a_synced_backward_exchanges_the_sum(hcg_port):
    """Accumulation: the grads kept under no_sync (2 and 4) plus the next
    backward's are averaged by that backward, (4 + 8) / 2 on both."""
    for r in range(4):
        np.testing.assert_array_equal(hcg_port[r]["no_sync_then_sync"],
                                      np.full((3, 1), 6.0))


# -- a world of one: no process group


@pytest.fixture
def world_of_one(monkeypatch):
    """No launcher variables and no process group; the port's mesh, hybrid
    group and fleet strategy put back after."""
    from paddle_tpu_torch.distributed import mesh
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PADDLE_TRAINER_ID",
              "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(k, raising=False)
    assert not pt.distributed.is_initialized()
    yield mesh
    mesh.reset_mesh()
    fleet.set_hybrid_communicate_group(None)
    fleet._strategy, fleet._initialized[0] = None, False


def test_world_of_one_mesh_and_fleet(world_of_one):
    """``init_mesh`` keeps the reference's rules (degrees must use every
    rank); ``fleet.init(backend="gloo")`` at world size 1 makes no group,
    installs a ``LocalMesh`` and a hybrid group of one-rank groups;
    ``distributed_model`` returns the model, ``DataParallel`` and the
    optimizer exchange nothing, and the parts of later slices raise
    naming their items."""
    mesh = world_of_one
    with pytest.raises(ValueError, match="not divisible by degree product"):
        mesh.init_mesh({"dp": 1, "mp": 2})
    strategy = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    assert fleet.is_initialized() and fleet.get_strategy() is strategy
    assert isinstance(mesh.get_mesh(), mesh.LocalMesh)
    assert [mesh.axis_size(a) for a in mesh.HYBRID_AXES] == [1] * 5
    assert mesh.axis_index("dp") == 0
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_data_parallel_group().ranks == [0]
    assert hcg.get_model_parallel_world_size() == 1
    net = _net()
    assert fleet.distributed_model(net) is net
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()))
    wrapped = pt.distributed.DataParallel(net)
    _loss(wrapped).backward()
    before = [p.detach().clone() for p in net.parameters()]
    opt.step()
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     net.parameters()))
    assert pt.distributed.get_comm_stats().as_dict()["calls"] == 0
    with pytest.raises(NotImplementedError, match="8b"):
        mesh.sharding("dp")
    with pytest.raises(NotImplementedError, match="8d"):
        fleet.init(is_collective=False)
    s = fleet.DistributedStrategy()
    s.dgc = True
    with pytest.raises(NotImplementedError, match="8b"):
        fleet.distributed_optimizer(opt, s)
