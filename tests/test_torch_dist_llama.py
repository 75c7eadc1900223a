"""The port's Llama training step data-parallel at dp 2 against the
reference's single-process step.

A 2-layer Llama (hidden 256 over 4 heads: head_dim 64, so SDPA takes the
flash route) with the reference's weights (``convert.load_jax_state``)
takes two AdamW steps (``ClipGradByGlobalNorm(1.0)``, warmup into cosine
decay, decay off for the norms) through ``fleet.init(dp_degree=2)``,
``fleet.distributed_model`` and ``fleet.distributed_optimizer`` on a
2-rank gloo world, rank r on row r of a 2 x 128 batch; the reference
takes the same steps in one process on both rows. The tolerances are
``tests/test_torch_train.py``'s, for the same reasons. The same world
runs the steps with overlap off (bit-identical, the reference's rule)
and over an int8 wire (the reference's limits), and checks
``io.DistributedBatchSampler`` over its two ranks. The reference's
simulator does not run its Llama under ``DataParallel`` in a test, so
the dp-2 run is held to its single-process steps only (ROADMAP C54).

The port's world starts first and runs while this process computes the
reference's steps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io import DistributedBatchSampler as JSampler
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jtiny
from paddle_tpu.nn import clip_grad as jclip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr

import torch_dist_workers as workers
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)
from test_torch_train import (LOSS_RTOL, PARAM_LR_FRAC, PARAM_RTOL,
                              UPDATE_RTOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(_no_reference_mesh, tmp_path_factory):
    """The port's world (started first) and the reference's steps:
    {"port": per-rank results, "losses", "lrs", "params", "arrays"}."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(**workers.LLAMA_CFG))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    path = tmp_path_factory.mktemp("dp") / "llama.npz"
    np.savez(path, **arrays)
    world = workers.start_world(workers.llama_world_npz, 2, str(path))
    try:
        for name, p in jm.named_parameters():
            p.name = name
        sched = workers.llama_schedule(jlr)
        opt = JAdamW(learning_rate=sched, parameters=jm.parameters(),
                     grad_clip=jclip.ClipGradByGlobalNorm(1.0),
                     apply_decay_param_fun=lambda n: "norm" not in n)
        opt.fuse_step = False             # the eager functional core
        ids, labels = workers.llama_batch()
        losses, lrs = [], []
        for _ in range(workers.LLAMA_STEPS):
            lrs.append(sched())
            loss, _ = jm(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(np.asarray(loss._data)))
        params = {n: np.asarray(p._data).copy()
                  for n, p in jm.named_parameters()}
    finally:
        world.join()
    return dict(port=world.results, losses=losses, lrs=lrs, params=params,
                arrays=arrays)


def test_sampler_over_two_ranks_equals_the_reference(runs):
    for r in range(2):
        nranks, rank, batches = runs["port"][r]["sampler"]
        assert (nranks, rank) == (2, r)
        want = JSampler(list(range(11)), 2, num_replicas=2, rank=r,
                        shuffle=True)
        assert batches == list(want)


@pytest.mark.parametrize("run", ["on", "off"])
def test_losses_match_the_reference(runs, run):
    """The mean of the ranks' losses (each a mean over its row's 128
    tokens) is the whole batch's loss: within LOSS_RTOL, every step."""
    got = np.mean([runs["port"][r][f"llama_{run}"][0] for r in range(2)],
                  axis=0)
    for g, w in zip(got, runs["losses"]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (g, w)


def test_parameters_match_the_reference(runs):
    """After the AdamW steps, every parameter within PARAM_RTOL of its
    max plus PARAM_LR_FRAC of the summed rates, and the whole update
    within UPDATE_RTOL of its norm."""
    got, want, arrays = runs["port"][0]["llama_on"][1], runs["params"], \
        runs["arrays"]
    moved, diff = [], []
    for name, w in want.items():
        tol = PARAM_RTOL * np.abs(w).max() + PARAM_LR_FRAC * sum(runs["lrs"])
        assert float(np.abs(got[name] - w).max()) <= tol, name
        moved.append((w - arrays[name]).ravel())
        diff.append((got[name] - w).ravel())
    moved, diff = np.concatenate(moved), np.concatenate(diff)
    assert float(np.abs(moved).max()) > 0.0
    assert np.linalg.norm(diff) <= UPDATE_RTOL * np.linalg.norm(moved)


@pytest.mark.parametrize("run", ["on", "off", "int8"])
def test_ranks_stay_bit_identical(runs, run):
    a, b = (runs["port"][r][f"llama_{run}"][1] for r in range(2))
    assert set(a) == set(b) == set(runs["arrays"])
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])


def test_overlap_off_is_bit_identical(runs):
    """The reference's rule (``tests/test_comm_overlap.py:204``): the
    buckets launched during backward give the barrier path's bits."""
    on, off = (runs["port"][0][f"llama_{k}"] for k in ("on", "off"))
    assert on[0] == off[0]
    for name in on[1]:
        np.testing.assert_array_equal(on[1][name], off[1][name])
    steps = workers.LLAMA_STEPS
    assert on[2]["overlap_buckets"]["in_backward"] > 0
    assert on[2]["overlap_buckets"]["in_backward"] % steps == 0
    assert off[2]["overlap_buckets"] == {"in_backward": 0, "at_barrier": 0}
    assert on[2]["calls"] == off[2]["calls"]
    assert on[2]["host_staged"] == 0


def test_int8_wire(runs):
    """The reference's limits (``tests/test_comm.py:303-320``): wire bytes
    at most 30 % of the fp32 path's, the last loss within 2 %."""
    fp, q = (runs["port"][0][f"llama_{k}"] for k in ("on", "int8"))
    assert q[2]["wire_bytes"] <= 0.30 * fp[2]["wire_bytes"]
    assert q[2]["quant_max_error"] > 0.0
    assert abs(q[0][-1] - fp[0][-1]) <= 0.02 * abs(fp[0][-1])
