"""The port's ``ops/logic.py`` against the reference's OpCases of that
module (``tests/test_torch_ops_harness.py`` says how)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_torch_ops_harness import _port_on_cpu, cases_of, run_case  # noqa: F401

import paddle_tpu_torch as pt


@pytest.mark.parametrize("case", cases_of("logic"), ids=lambda c: c.name)
def test_logic_case_matches_reference(case):
    run_case(case)


def test_weak_scalars_and_zero_dim_promotion():
    """A Python scalar is weak, as in jnp; a 0-dim tensor promotes as
    fully as an n-dim one (torch would let the n-dim dtype win)."""
    h = torch.ones(3, dtype=torch.float16)
    assert pt.less_than(h, 0.5).dtype == torch.bool
    assert pt.add(h, 1.0).dtype == torch.float16
    assert pt.add(h, torch.tensor(1.0)).dtype == torch.float32
    assert pt.add(torch.ones(2, dtype=torch.int32), 2).dtype == torch.int32
    j = paddle.add(paddle.to_tensor(np.ones(3, np.float16)),
                   paddle.to_tensor(np.float32(1.0)))
    assert str(j.dtype) == "float32"
    assert pt.equal(torch.tensor([1, 2]), 2).tolist() == [False, True]


def test_sort_family_keeps_ties_in_order():
    x = np.array([[3.0, 1.0, 3.0, 2.0, 1.0]], np.float32)
    want_v, want_i = paddle.kthvalue(paddle.to_tensor(x), 2)
    got_v, got_i = pt.kthvalue(torch.from_numpy(x), 2)
    assert got_v.item() == float(want_v.numpy()[0])
    assert got_i.item() == int(want_i.numpy()[0])
    want = paddle.argsort(paddle.to_tensor(x), descending=True).numpy()
    np.testing.assert_array_equal(
        pt.argsort(torch.from_numpy(x), descending=True).numpy(), want)
    vals, idx = pt.mode(torch.tensor([[2.0, 1.0, 1.0, 2.0, 3.0]]))
    jv, ji = paddle.mode(paddle.to_tensor(
        np.array([[2.0, 1.0, 1.0, 2.0, 3.0]], np.float32)))
    assert (vals.item(), idx.item()) == (float(jv.numpy()[0]),
                                         int(ji.numpy()[0]))
    assert pt.argmax(torch.tensor([[1.0, 5.0]]), axis=1,
                     dtype="int32").dtype == torch.int32
