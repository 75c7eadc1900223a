"""The port's ``incubate`` top-level functions
(``paddle_tpu_torch/incubate/__init__.py``) against the reference's
(``paddle_tpu/incubate/__init__.py``) on the CPU, on inputs drawn from a
numpy seed: ``graph_send_recv`` under every pool, the fused masked
softmaxes in fp32 and bf16, ``identity_loss`` and the segment aliases.

The rule: fp32 values within ``rtol = 1e-5`` (``atol = 1e-6``) of the
reference's; bf16 results compared in fp32 at the same bound (both
compute in fp32 and round once)."""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as JI

from paddle_tpu_torch import geometric as TG
from paddle_tpu_torch import incubate as TI
from test_torch_geometric import (REDUCES, close, graph, jt, npy,
                                  segment_data, tt)
from torch_vision_common import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def test_top_level_functions_are_the_references():
    """The public functions bound at ``incubate``'s top level are the
    reference's: no helper the port imports (``send_u_recv``) leaks
    into the surface."""
    def public(m):
        return sorted(n for n, v in vars(m).items()
                      if not n.startswith("_") and inspect.isfunction(v))
    assert public(TI) == public(JI)
    assert "send_u_recv" not in vars(TI)


@pytest.mark.parametrize("pool", REDUCES)
def test_graph_send_recv(pool):
    x, _, src, dst, _ = graph(15)
    close(TI.graph_send_recv(tt(x), tt(src), tt(dst), pool_type=pool),
          JI.graph_send_recv(jt(x), jt(src), jt(dst), pool_type=pool),
          f"graph_send_recv {pool}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_mask_fuse(dtype):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 5, 5)) < 0.3, -1e4, 0.).astype(
        np.float32)
    jx = paddle.to_tensor(x).astype(dtype)
    tx = tt(x).to(getattr(torch, dtype))
    got = TI.softmax_mask_fuse(tx, tt(mask).to(tx.dtype))
    want = JI.softmax_mask_fuse(jx, paddle.to_tensor(mask).astype(dtype))
    assert got.dtype == tx.dtype
    close(got.float(), paddle.to_tensor(want).astype("float32"),
          f"softmax_mask_fuse {dtype}")
    got = TI.softmax_mask_fuse_upper_triangle(tx)
    want = JI.softmax_mask_fuse_upper_triangle(jx)
    close(got.float(), want.astype("float32"),
          f"softmax_mask_fuse_upper_triangle {dtype}")
    assert np.all(np.triu(npy(got.float())[0, 0], 1) == 0)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_identity_loss(reduction):
    x = np.random.default_rng(17).standard_normal((3, 4)).astype(np.float32)
    close(TI.identity_loss(tt(x), reduction),
          JI.identity_loss(jt(x), reduction), f"identity_loss {reduction}")


@pytest.mark.parametrize("reduce", REDUCES)
def test_incubate_segment_aliases(reduce):
    data, ids = segment_data(18)
    name = f"segment_{reduce}"
    assert getattr(TI, name) is getattr(TG, name)
    close(getattr(TI, name)(tt(data), tt(ids)),
          getattr(JI, name)(jt(data), jt(ids)), f"incubate.{name}")
