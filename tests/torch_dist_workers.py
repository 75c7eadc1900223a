"""Rank functions of the port's distributed tests: each runs in a
process that ``paddle_tpu_torch.distributed.spawn`` starts, so it
imports torch, numpy and the port only (a spawned child imports the
module that defines its function; ``tests/test_torch_isolation.py``
holds this file to that). Each world function runs many cases in one
world and returns their results by case name, the inputs made as the
reference's tests make them (``tests/test_distributed.py``,
``tests/test_comm.py``), so the test files can hold them to the
reference's values and to the reference's simulator on the same
inputs."""
from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist

#: every world's deadline, and its rendezvous' and collectives' timeout
WORLD_TIMEOUT_S = 90


def start_world(func, nprocs, *args):
    """``func(*args)`` started on ``nprocs`` gloo ranks: the caller works
    meanwhile, then ``join()``s the context and reads its ``results``."""
    return dist.spawn(func, args=args, nprocs=nprocs, backend="gloo",
                      join=False, timeout_s=WORLD_TIMEOUT_S)


def run_world(func, nprocs, *args):
    """``func(*args)`` on ``nprocs`` gloo ranks; the results in rank
    order."""
    world = start_world(func, nprocs, *args)
    world.join()
    return world.results


def _setup():
    torch.set_num_threads(1)
    return dist.get_rank()


def _vals(ts):
    return [float(t.reshape(-1)[0]) for t in ts]


# ---------------------------------------------------------------------------
# the collectives: one world of 4
# ---------------------------------------------------------------------------


def collectives_world():
    """Every case of the reference's ``TestCollectives`` and
    ``TestGatherScatterObjects`` (their worlds of 2 and 3 are the groups
    ``[0, 1]`` and ``[0, 1, 2]`` of this one) and the rest of the
    surface. Returns {case: this rank's result (None off the case's
    group)}."""
    r = _setup()
    g2, g3 = dist.new_group([0, 1]), dist.new_group([0, 1, 2])
    g02 = dist.new_group([0, 2])
    out = {}

    t = torch.full((2, 3), float(r + 1))
    dist.all_reduce(t)
    out["all_reduce_sum"] = t.numpy().tolist()

    t = torch.tensor([float(r)])
    if r in (0, 2):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g02)
    out["all_reduce_max_and_group"] = float(t[0])

    if r < 3:
        got = []
        dist.all_gather(got, torch.tensor([float(r)]), group=g3)
        out["all_gather"] = _vals(got)

    if r < 2:
        parts = [torch.full((2,), float(r + 10 * i)) for i in range(2)]
        o = torch.zeros(2)
        dist.reduce_scatter(o, parts, group=g2)
        out["reduce_scatter"] = float(o[0])

        ins = [torch.tensor([float(r * 10 + i)]) for i in range(2)]
        outs = []
        dist.alltoall(outs, ins, group=g2)
        out["alltoall"] = _vals(outs)

        t = torch.tensor([float(r)])
        dist.broadcast(t, src=1, group=g2)
        parts = [torch.tensor([7.0 + i]) for i in range(2)] if r == 0 \
            else None
        s = torch.zeros(1)
        dist.scatter(s, parts, src=0, group=g2)
        out["broadcast_scatter"] = (float(t[0]), float(s[0]))

        if r == 0:
            dist.send(torch.tensor([42.0]), dst=1, group=g2)
            out["send_recv"] = 0.0
        else:
            t = torch.zeros(1)
            dist.recv(t, src=0, group=g2)
            out["send_recv"] = float(t[0])

    if r < 3:
        dist.barrier(g3)
        objs = []
        dist.all_gather_object(objs, {"rank": r}, group=g3)
        out["barrier_and_object_gather"] = [o["rank"] for o in objs]

        got = []
        dist.gather(torch.tensor([float(r)]), got, dst=1, group=g3)
        out["gather_to_dst"] = _vals(got)

        got = []
        payload = [{"rank": i, "x": i * 2} for i in range(3)] if r == 0 \
            else None
        dist.scatter_object_list(got, payload, src=0, group=g3)
        out["scatter_object_list"] = got[0]

    # -- the rest of the surface, on the world of 4
    for name, op in (("avg", dist.ReduceOp.AVG), ("prod", dist.ReduceOp.PROD),
                     ("min", dist.ReduceOp.MIN), ("legacy_max", 1)):
        t = torch.tensor([float(r + 1), 2.0 * r - 3.0])
        dist.all_reduce(t, op=op)
        out[f"all_reduce_{name}"] = t.tolist()
    t = torch.tensor([r + 1, 7], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.AVG)
    out["all_reduce_avg_int"] = t.tolist()
    t = torch.full((3,), float(r))
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    out["all_reduce_async"] = (t.tolist(), task.is_completed())

    t = torch.tensor([float(r + 1)])
    dist.reduce(t, dst=2)
    out["reduce"] = float(t[0])
    t = torch.tensor([float(r + 1)])
    dist.reduce(t, dst=3, op=dist.ReduceOp.AVG)
    out["reduce_avg"] = float(t[0])

    o = torch.zeros(4)
    dist.alltoall_single(o, torch.arange(4, dtype=torch.float32) + 10 * r)
    out["alltoall_single"] = o.tolist()
    splits = [1, 2, 0, 1]
    src = torch.arange(4, dtype=torch.float32) + 10 * r
    o = torch.zeros(1)
    dist.alltoall_single(o, src, in_split_sizes=splits)
    out["alltoall_single_uneven"] = o.tolist()

    parts = [torch.full((2,), float(r + 10 * i)) for i in range(4)]
    o = torch.zeros(2)
    dist.reduce_scatter(o, parts, op=dist.ReduceOp.AVG)
    out["reduce_scatter_avg"] = o.tolist()

    objs = [{"from": r}, r * 3]
    dist.broadcast_object_list(objs, src=2)
    out["broadcast_object_list"] = objs

    nxt, prv = (r + 1) % 4, (r - 1) % 4
    got = torch.zeros(2)
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, torch.tensor([float(r), 1.0 + r]), nxt),
        dist.P2POp(dist.irecv, got, prv)])
    for task in tasks:
        task.wait()
    out["batch_isend_irecv"] = got.tolist()

    got = torch.zeros(1)
    task = dist.irecv(got, src=prv) if r % 2 else None
    if r % 2 == 0:
        dist.isend(torch.tensor([100.0 + r]), dst=nxt).wait()
    else:
        task.wait()
        dist.isend(torch.tensor([100.0 + r]), dst=nxt).wait()
    if r % 2 == 0:
        dist.irecv(got, src=prv).wait()
    out["isend_irecv_ring"] = float(got[0])

    out["world"] = (dist.get_rank(), dist.get_world_size(),
                    dist.get_backend(), g3.rank, g3.nranks, g02.is_member())
    out["stats"] = dist.get_comm_stats().as_dict()
    return out


# ---------------------------------------------------------------------------
# the quantized exchange and the bucketer: one world of 4
# ---------------------------------------------------------------------------

#: the bucketer case's parameter shapes (``TestBucketerLayout``'s) and its
#: rounds of error-feedback exchange
BUCKET_SHAPES = [(64, 32), (64,), (32, 16), (16,), (7, 3)]
EF_ROUNDS = 3


def ef_grads(rank, k):
    """Rank ``rank``'s vector of error-feedback round ``k``."""
    return np.random.default_rng(100 * rank + k).normal(
        size=512).astype(np.float32) * 1e-3


def bucket_grads(rank, k):
    rng = np.random.default_rng(1000 + 10 * rank + k)
    return [rng.normal(size=s).astype(np.float32) for s in BUCKET_SHAPES]


def comm_world():
    """The reference's quantized-collective cases at their worlds (the
    groups of this world), error feedback at dp 4, and the bucketed
    exchange at dp 4; each case's ``CommStats`` beside its result."""
    from paddle_tpu_torch.distributed.comm import (
        GradientBucketer, allreduce_array, reduce_scatter_quantized)
    r = _setup()
    g2 = dist.new_group([0, 1])
    out = {}

    def case(name, fn):
        dist.reset_comm_stats()
        out[name] = (fn(), dist.get_comm_stats().as_dict())

    def all_reduce_q():
        x = np.random.default_rng(r).normal(size=600).astype(np.float32)
        t = torch.tensor(x)
        dist.all_reduce_quantized(t, op=dist.ReduceOp.AVG, block_size=64)
        return x, t.numpy()

    def reduce_scatter_q():
        if r >= 2:
            return None
        parts = [torch.full((8,), float(r + 10 * i)) for i in range(2)]
        o = torch.zeros(8)
        reduce_scatter_quantized(o, parts, op=dist.ReduceOp.SUM,
                                 block_size=64, group=g2)
        return o.numpy()

    def bf16():
        if r >= 2:
            return None
        t = torch.full((64,), 1.0 + r)
        dist.all_reduce_quantized(t, op=dist.ReduceOp.AVG, scheme="bf16",
                                  group=g2)
        return t.numpy()

    def byte_accounting():
        if r >= 2:
            return None
        dist.all_reduce_quantized(torch.ones(1024), block_size=256, group=g2)

    def dense_recorded():
        if r >= 2:
            return None
        dist.all_reduce(torch.ones(256), group=g2)

    def error_feedback():
        residual = torch.zeros(512)
        got = [allreduce_array(torch.tensor(ef_grads(r, k)), op="avg",
                               scheme="int8", block_size=128,
                               residual=residual).numpy()
               for k in range(EF_ROUNDS)]
        return got, residual.numpy()

    def bucketed(quant, fuse, ef):
        params = [torch.nn.Parameter(torch.zeros(s)) for s in BUCKET_SHAPES]
        b = GradientBucketer(params, fuse_grad_size_in_MB=fuse,
                             quantization=quant, block_size=64,
                             error_feedback=ef)
        got = []
        for k in range(2):
            for p, g in zip(params, bucket_grads(r, k)):
                p.grad = torch.tensor(g)
            b.sync_grads()
            got.append([p.grad.numpy().copy() for p in params])
        sigs = []
        dist.all_gather_object(sigs, b.signature())
        return got, b.signature(), all(s == sigs[0] for s in sigs)

    case("all_reduce_quantized", all_reduce_q)
    case("reduce_scatter_quantized", reduce_scatter_q)
    case("bf16_scheme", bf16)
    case("byte_accounting", byte_accounting)
    case("dense_recorded", dense_recorded)
    case("error_feedback_dp4", error_feedback)
    case("bucketed_int8_ef", lambda: bucketed("int8", 0.01, True))
    case("bucketed_fp32", lambda: bucketed(None, 32, False))
    return out


# ---------------------------------------------------------------------------
# the hybrid topology and DataParallel: one world of 4
# ---------------------------------------------------------------------------

#: fleet.init's degree sets of the topology case
HCG_DEGREES = ({"dp_degree": 2, "mp_degree": 2},
               {"pp_degree": 2, "sharding_degree": 2})
HCG_NAMES = ("data", "pipe", "sharding", "sep", "model")


def _hcg_view(hcg):
    groups = {n: getattr(hcg, f"get_{g}_group")().ranks for n, g in (
        ("data", "data_parallel"), ("pipe", "pipe_parallel"),
        ("sharding", "sharding_parallel"), ("sep", "sep_parallel"),
        ("model", "model_parallel"))}
    return dict(
        groups=groups,
        sizes=[hcg.get_data_parallel_world_size(),
               hcg.get_pipe_parallel_world_size(),
               hcg.get_sharding_parallel_world_size(),
               hcg.get_sep_parallel_world_size(),
               hcg.get_model_parallel_world_size()],
        coords=[hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                hcg.get_sharding_parallel_rank(),
                hcg.get_sep_parallel_rank(), hcg.get_model_parallel_rank()],
        src=(hcg.get_data_parallel_group_src_rank(),
             hcg.get_model_parallel_group_src_rank()))


def hcg_world():
    """``fleet.init`` with each of HCG_DEGREES: the hybrid group's view,
    the mesh's axes, an all-reduce over each axis group; then the same
    topology given explicitly."""
    from paddle_tpu_torch.distributed import fleet, mesh
    r = _setup()
    out = {}
    for degrees in HCG_DEGREES:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = degrees
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        view = _hcg_view(hcg)
        view["axes"] = {ax: (mesh.axis_size(ax), mesh.axis_index(ax))
                        for ax in mesh.HYBRID_AXES}
        sums = {}
        for name, getter in (("data", hcg.get_data_parallel_group),
                             ("model", hcg.get_model_parallel_group),
                             ("pipe", hcg.get_pipe_parallel_group),
                             ("sharding", hcg.get_sharding_parallel_group)):
            t = torch.tensor([float(r)])
            dist.all_reduce(t, group=getter())
            sums[name] = float(t[0])
        view["sums"] = sums
        dims = [view["sizes"][i] for i in range(5)]
        explicit = fleet.HybridCommunicateGroup(
            fleet.CommunicateTopology(list(HCG_NAMES), dims))
        view["explicit"] = _hcg_view(explicit)
        out[tuple(sorted(degrees.items()))] = view
    try:
        fleet.distributed_model(torch.nn.Linear(2, 2))
    except NotImplementedError as e:
        out["pp_model"] = str(e)
    out.update(data_parallel_pairs())
    out["worker"] = (fleet.worker_index(), fleet.worker_num(),
                     fleet.is_first_worker())
    return out


def data_parallel_pairs():
    """The reference's DataParallel cases (grad sync, no_sync) at their
    world of 2: the pairs [0, 1] and [2, 3] of this world, each rank's
    input made from its rank in the pair."""
    r = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = pairs[r // 2]
    x = torch.full((2, 3), float(group.rank + 1))
    out = {}

    def linear():
        torch.manual_seed(5)
        return torch.nn.Linear(3, 1, bias=False)

    model = dist.DataParallel(linear(), group=group)
    model(x).sum().backward()
    out["grad_sync"] = model._layers.weight.grad.numpy().T.copy()
    model.shutdown()

    model = dist.DataParallel(linear(), group=group)
    with model.no_sync():
        model(x).sum().backward()
    out["no_sync"] = model._layers.weight.grad.numpy().T.copy()
    # the next synced backward exchanges the accumulated gradients
    model(x).sum().backward()
    out["no_sync_then_sync"] = model._layers.weight.grad.numpy().T.copy()
    model.shutdown()
    return out


# ---------------------------------------------------------------------------
# data parallelism of the Llama step: one world of 2
# ---------------------------------------------------------------------------

#: the Llama case: its config (head_dim 64, so SDPA takes the flash
#: route), the rows a rank and the sequence, the AdamW steps
LLAMA_CFG = dict(hidden_size=256, num_attention_heads=4,
                 num_key_value_heads=2, num_hidden_layers=2,
                 intermediate_size=688, max_position_embeddings=256)
LLAMA_SEQ, LLAMA_STEPS = 128, 2


def llama_batch():
    """The whole batch (2 rows): rank r trains on row r."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, LLAMA_SEQ)).astype(np.int64)
    labels = rng.randint(0, 128, (2, LLAMA_SEQ)).astype(np.int64)
    return ids, labels


def llama_schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


def _llama_dp(arrays, overlap, quant):
    """LLAMA_STEPS AdamW steps at dp 2 through fleet: each step's loss on
    this rank's row, and the parameters after (reference layout)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr
    r = dist.get_rank()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2}
    strategy.comm_overlap = overlap
    strategy.comm_quantization = quant
    strategy.fuse_grad_size_in_MB = 1
    fleet.init(is_collective=True, strategy=strategy)
    model = pt.load_jax_state(pt.LlamaForCausalLM(
        pt.llama_tiny(**LLAMA_CFG), device="cpu"), arrays)
    sched = llama_schedule(tlr)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=sched, parameters=model.named_parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: "norm" not in n))
    dp = fleet.distributed_model(model)
    ids, labels = llama_batch()
    losses = []
    dist.reset_comm_stats()
    for _ in range(LLAMA_STEPS):
        loss, _ = dp(ids[r:r + 1], labels=labels[r:r + 1])
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    params = pt.jax_layout(model, dict(model.named_parameters()))
    stats = dist.get_comm_stats().as_dict()
    dp.shutdown()
    return losses, params, stats


def llama_world(arrays):
    """The sampler over two ranks, and the Llama at dp 2 with overlap on,
    off and an int8 wire."""
    import paddle_tpu_torch as pt
    _setup()
    pt.set_device("cpu")
    sampler = pt.io.DistributedBatchSampler(list(range(11)), 2,
                                            shuffle=True)
    out = {"sampler": (sampler.nranks, sampler.local_rank, list(sampler))}
    for key, overlap, quant in (("on", True, None), ("off", False, None),
                                ("int8", True, "int8")):
        out[f"llama_{key}"] = _llama_dp(arrays, overlap, quant)
    return out


def llama_world_npz(path):
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    return llama_world(arrays)


# ---------------------------------------------------------------------------
# failing worlds: a rank that raises, a rank that hangs
# ---------------------------------------------------------------------------


def raising_rank():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hanging_rank():
    import time
    if dist.get_rank() == 1:
        time.sleep(3600)
    dist.barrier()
