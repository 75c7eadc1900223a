"""The port's collectives against the reference's.

One 4-rank gloo world (``torch_dist_workers.collectives_world``, a module
fixture) runs every case of the reference's ``TestCollectives`` and
``TestGatherScatterObjects`` (``tests/test_distributed.py:17-117``,
``:458-481``; their worlds of 2 and 3 ranks are the groups ``[0, 1]`` and
``[0, 1, 2]`` here) and the rest of the surface. Each case is held to
the reference test's own expected values and to the reference's
``dist.spawn`` (its thread simulator) on the same inputs. The values are
small integers in fp32, so every case is exact: tolerance 0.
"""
import socket
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist

import paddle_tpu_torch.distributed as dist
import torch_dist_workers as workers
from paddle_tpu_torch.distributed.comm import get_comm_stats
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    """The world's results, rank by rank."""
    return workers.run_world(workers.collectives_world, 4)


# -- the reference's workers (tests/test_distributed.py), on its simulator


def _r_all_reduce_sum():
    t = paddle.to_tensor(np.full((2, 3), float(rdist.get_rank() + 1),
                                 "float32"))
    rdist.all_reduce(t)
    return t.numpy().tolist()


def _r_all_reduce_max_and_group():
    r = rdist.get_rank()
    g = rdist.new_group([0, 2])
    t = paddle.to_tensor(np.array([float(r)], "float32"))
    if r in (0, 2):
        rdist.all_reduce(t, op=rdist.ReduceOp.MAX, group=g)
    return float(t.numpy()[0])


def _r_all_gather():
    out = []
    rdist.all_gather(out, paddle.to_tensor(
        np.array([rdist.get_rank()], "float32")))
    return [float(t.numpy()[0]) for t in out]


def _r_reduce_scatter():
    r = rdist.get_rank()
    parts = [paddle.to_tensor(np.full((2,), float(r + 10 * i), "float32"))
             for i in range(2)]
    out = paddle.zeros([2])
    rdist.reduce_scatter(out, parts)
    return float(out.numpy()[0])


def _r_alltoall():
    r = rdist.get_rank()
    ins = [paddle.to_tensor(np.array([r * 10 + i], "float32"))
           for i in range(2)]
    outs = []
    rdist.alltoall(outs, ins)
    return [float(t.numpy()[0]) for t in outs]


def _r_broadcast_scatter():
    r = rdist.get_rank()
    t = paddle.to_tensor(np.array([float(r)], "float32"))
    rdist.broadcast(t, src=1)
    parts = [paddle.to_tensor(np.array([7.0 + i], "float32"))
             for i in range(2)] if r == 0 else None
    s = paddle.zeros([1])
    rdist.scatter(s, parts, src=0)
    return float(t.numpy()[0]), float(s.numpy()[0])


def _r_send_recv():
    if rdist.get_rank() == 0:
        rdist.send(paddle.to_tensor(np.array([42.0], "float32")), dst=1)
        return 0.0
    t = paddle.zeros([1])
    rdist.recv(t, src=0)
    return float(t.numpy()[0])


def _r_barrier_and_object_gather():
    rdist.barrier()
    objs = []
    rdist.all_gather_object(objs, {"rank": rdist.get_rank()})
    return [o["rank"] for o in objs]


def _r_gather_to_dst():
    out = []
    rdist.gather(paddle.to_tensor(np.array([float(rdist.get_rank())],
                                           "float32")), out, dst=1)
    return [float(t.numpy()[0]) for t in out]


def _r_scatter_object_list():
    out = []
    payload = [{"rank": i, "x": i * 2} for i in range(3)] \
        if rdist.get_rank() == 0 else None
    rdist.scatter_object_list(out, payload, src=0)
    return out[0]


#: case -> (the reference's world, its worker, the reference test's values)
REFERENCE_CASES = {
    "all_reduce_sum": (4, _r_all_reduce_sum, [[[10.0] * 3] * 2] * 4),
    "all_reduce_max_and_group": (4, _r_all_reduce_max_and_group,
                                 [2.0, 1.0, 2.0, 3.0]),
    "all_gather": (3, _r_all_gather, [[0.0, 1.0, 2.0]] * 3),
    "reduce_scatter": (2, _r_reduce_scatter, [1.0, 21.0]),
    "alltoall": (2, _r_alltoall, [[0.0, 10.0], [1.0, 11.0]]),
    "broadcast_scatter": (2, _r_broadcast_scatter, [(1.0, 7.0), (1.0, 8.0)]),
    "send_recv": (2, _r_send_recv, [0.0, 42.0]),
    "barrier_and_object_gather": (3, _r_barrier_and_object_gather,
                                  [[0, 1, 2]] * 3),
    "gather_to_dst": (3, _r_gather_to_dst, [[], [0.0, 1.0, 2.0], []]),
    "scatter_object_list": (3, _r_scatter_object_list,
                            [{"rank": i, "x": 2 * i} for i in range(3)]),
}


def _as_lists(v):
    return tuple(v) if isinstance(v, tuple) else v


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_equals_the_reference(port, case):
    nprocs, worker, want = REFERENCE_CASES[case]
    ref = rdist.spawn(worker, nprocs=nprocs).results
    got = [port[r][case] for r in range(nprocs)]
    assert [_as_lists(v) for v in got] == [_as_lists(v) for v in ref]
    if case == "scatter_object_list":
        assert [v["x"] for v in got] == [w["x"] for w in want]
    else:
        assert [_as_lists(v) for v in got] == [_as_lists(v) for v in want]
    # ranks outside the case's group take no part
    assert all(case not in port[r] for r in range(nprocs, 4))


def _ranks(fn):
    return [fn(r) for r in range(4)]


#: the port's other cases, on the world of 4 -> each rank's value
SURFACE_CASES = {
    "all_reduce_avg": _ranks(lambda r: [2.5, 0.0]),
    "all_reduce_prod": _ranks(lambda r: [24.0, 9.0]),
    "all_reduce_min": _ranks(lambda r: [1.0, -3.0]),
    "all_reduce_legacy_max": _ranks(lambda r: [4.0, 3.0]),
    # the mean of 1..4 truncated, as the reference writes np.mean back
    "all_reduce_avg_int": _ranks(lambda r: [2, 7]),
    "all_reduce_async": _ranks(lambda r: ([6.0] * 3, True)),
    # dst gets the reduction; the others keep their own
    "reduce": [1.0, 2.0, 10.0, 4.0],
    "reduce_avg": [1.0, 2.0, 3.0, 2.5],
    "alltoall_single": _ranks(lambda r: [r + 10.0 * i for i in range(4)]),
    "alltoall_single_uneven": [[0.0, 10.0, 20.0, 30.0],
                               [1.0, 2.0, 11.0, 12.0, 21.0, 22.0, 31.0,
                                32.0], [], [3.0, 13.0, 23.0, 33.0]],
    "reduce_scatter_avg": _ranks(lambda r: [1.5 + 10 * r] * 2),
    "broadcast_object_list": _ranks(lambda r: [{"from": 2}, 6]),
    "batch_isend_irecv": _ranks(lambda r: [(r - 1) % 4, 1.0 + (r - 1) % 4]),
    "isend_irecv_ring": _ranks(lambda r: 100.0 + (r - 1) % 4),
    "world": _ranks(lambda r: (r, 4, "gloo", r if r < 3 else -1, 3,
                               r in (0, 2))),
}


@pytest.mark.parametrize("case", sorted(SURFACE_CASES))
def test_surface_case(port, case):
    assert [_as_lists(port[r][case]) for r in range(4)] == \
        [_as_lists(v) for v in SURFACE_CASES[case]]


def test_dense_collectives_are_recorded_per_rank(port):
    """all_reduce, all_gather and reduce_scatter record one entry a call
    on the issuing rank, wire == logical; nothing was staged (CPU
    tensors)."""
    st = port[0]["stats"]
    assert set(st["by_kind"]) == {"all_reduce", "all_gather",
                                  "reduce_scatter"}
    assert st["logical_bytes"] == st["wire_bytes"] > 0
    assert st["host_staged"] == 0
    # rank 3 is outside the groups [0, 2], [0, 1, 2] and [0, 1]
    assert port[3]["stats"]["calls"] == st["calls"] - 3


# -- world size 1, no process group


@pytest.fixture
def no_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()


def test_init_parallel_env_refuses_the_cpu_without_gloo(no_launcher):
    if torch.cuda.is_available():
        pytest.skip("a machine with CUDA takes NCCL")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        dist.init_parallel_env()
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        dist.init_parallel_env(backend="nccl")
    env = dist.init_parallel_env(backend="gloo")
    assert not dist.is_initialized()
    assert (env.rank, env.world_size, dist.get_backend()) == (0, 1, None)


def test_world_size_one_collectives_are_identities(no_launcher):
    """The reference's ``test_world_size_rank_outside_spawn`` and tier 4:
    every collective leaves its tensor as it was."""
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    t = torch.tensor([3.0])
    dist.all_reduce(t)
    dist.all_reduce(t, op=dist.ReduceOp.AVG)
    dist.broadcast(t, src=0)
    dist.reduce(t, dst=0)
    dist.barrier()
    assert t.tolist() == [3.0]
    got = []
    dist.all_gather(got, t)
    assert [g.tolist() for g in got] == [[3.0]]
    o = torch.zeros(2)
    dist.reduce_scatter(o, [torch.tensor([1.0, 2.0])])
    dist.alltoall_single(o, torch.tensor([5.0, 6.0]))
    assert o.tolist() == [5.0, 6.0]
    objs = []
    dist.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]
    with pytest.raises(RuntimeError, match="more than one rank"):
        dist.send(t, dst=0)
    assert get_comm_stats().as_dict()["host_staged"] == 0


def test_launcher_variables_make_a_one_rank_group(no_launcher, monkeypatch):
    """torchrun's variables at world size 1: a real gloo group of one,
    through which the collectives go."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        dist.init_parallel_env(backend="gloo", timeout_s=30)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        t = torch.tensor([2.0, 4.0])
        task = dist.all_reduce(t, op=dist.ReduceOp.AVG, sync_op=False)
        task.wait()
        assert t.tolist() == [2.0, 4.0] and task.is_completed()
        assert dist.get_group().nranks == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# -- a world fails in bounded time


@pytest.mark.parametrize("worker,deadline,match", [
    ("raising_rank", 60, "(?s)rank 1 raised:.*rank 1 fails on purpose"),
    ("hanging_rank", 6, "rank|deadline")])
def test_a_failing_rank_fails_the_world_in_bounded_time(worker, deadline,
                                                        match):
    """A rank that raises, or hangs while its peer waits in a barrier,
    makes ``spawn`` kill every rank and raise ``RankError`` (with the
    failing rank's traceback) by the world's deadline."""
    from paddle_tpu_torch.distributed.spawn import RankError
    t0 = time.monotonic()
    with pytest.raises(RankError, match=match) as err:
        dist.spawn(getattr(workers, worker), nprocs=2, backend="gloo",
                   timeout_s=deadline)
    assert time.monotonic() - t0 < deadline + 20
    assert "Traceback" in str(err.value) or "deadline" in str(err.value)
