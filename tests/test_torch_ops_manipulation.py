"""The port's ``ops/manipulation.py`` against the reference's OpCases of
that module (``tests/test_torch_ops_harness.py`` says how), and its
exempt and in-place ops against the reference."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_torch_ops_harness import (_port_on_cpu, assert_same, cases_of,  # noqa: F401
                                    run_case, to_numpy)

import paddle_tpu_torch as pt

RNG = np.random.RandomState(11)


@pytest.mark.parametrize("case", cases_of("manipulation"),
                         ids=lambda c: c.name)
def test_manipulation_case_matches_reference(case):
    run_case(case)


def _both(op, *arrays, **kw):
    want = getattr(paddle, op)(*[paddle.to_tensor(a) for a in arrays], **kw)
    got = getattr(pt, op)(*[torch.from_numpy(a) for a in arrays], **kw)
    want = (type(want)(np.asarray(w.numpy()) for w in want)
            if isinstance(want, (list, tuple)) else np.asarray(want.numpy()))
    return to_numpy(got), want


def test_rank_shape_crop():
    x = RNG.randn(3, 4, 5).astype(np.float32)
    for op in ("rank", "shape"):
        got, want = _both(op, x)
        assert_same(got, want, 0, 0, op)
    got, want = _both("crop", x, shape=[2, -1, 3], offsets=[1, 1, 2])
    assert_same(got, want, 0, 0, "crop")


def test_views():
    x = RNG.randn(2, 6).astype(np.float32)
    for dt in ("float16", "int32", "float64"):
        got, want = _both("view", x, shape_or_dtype=dt)
        if dt == "float64":                  # the reference narrows, C26
            assert got.shape == (2, 3)
            continue
        assert_same(got.view(np.uint8), want.view(np.uint8), 0, 0, dt)
    got = pt.view_as(torch.from_numpy(x), torch.zeros(3, 4))
    want = paddle.view_as(paddle.to_tensor(x), paddle.zeros([3, 4]))
    assert_same(to_numpy(got), np.asarray(want.numpy()), 0, 0, "view_as")


def test_index_copy():
    x = RNG.randn(5, 3).astype(np.float32)
    v = RNG.randn(2, 3).astype(np.float32)
    idx = np.array([4, 1])
    want = paddle.index_copy(paddle.to_tensor(x), paddle.to_tensor(idx), 0,
                             paddle.to_tensor(v)).numpy()
    got = pt.index_copy(torch.from_numpy(x), torch.from_numpy(idx), 0,
                        torch.from_numpy(v))
    assert_same(to_numpy(got), np.asarray(want), 0, 0, "index_copy")


def test_in_place_variants():
    x = RNG.randn(2, 1, 6).astype(np.float32)
    t = torch.from_numpy(x.copy())
    assert pt.reshape_(t, [3, 4]) is t and t.shape == (3, 4)
    np.testing.assert_array_equal(t.numpy(), x.reshape(3, 4))
    t = torch.from_numpy(x.copy())
    assert pt.squeeze_(t, 1) is t and t.shape == (2, 6)
    assert pt.unsqueeze_(t, [0, -1]) is t and t.shape == (1, 2, 6, 1)
    z = np.zeros((5, 2), np.float32)
    u = RNG.randn(2, 2).astype(np.float32)
    idx = np.array([1, 3])
    t = torch.from_numpy(z.copy())
    assert pt.scatter_(t, torch.from_numpy(idx), torch.from_numpy(u)) is t
    want = paddle.scatter(paddle.to_tensor(z), paddle.to_tensor(idx),
                          paddle.to_tensor(u)).numpy()
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(offset=1), dict(offset=-1),
                                dict(wrap=True)])
def test_fill_diagonal(kw):
    shape = (7, 3) if kw.get("wrap") else (4, 5)
    x = RNG.randn(*shape).astype(np.float32)
    jt = paddle.to_tensor(x)
    paddle.fill_diagonal_(jt, 9.0, **kw)
    t = torch.from_numpy(x.copy())
    assert pt.fill_diagonal_(t, 9.0, **kw) is t
    np.testing.assert_array_equal(t.numpy(), jt.numpy())
    y = RNG.randn(3).astype(np.float32)
    x = RNG.randn(3, 4).astype(np.float32)
    jt = paddle.to_tensor(x)
    paddle.fill_diagonal_tensor_(jt, paddle.to_tensor(y), offset=1)
    t = torch.from_numpy(x.copy())
    pt.fill_diagonal_tensor_(t, torch.from_numpy(y), offset=1)
    np.testing.assert_array_equal(t.numpy(), jt.numpy())


@pytest.mark.parametrize("args,kw", [
    (((6, 4), [2, -1, 1]), dict(axis=0)),
    (((3, 6), 3), dict(axis=-1)),
])
def test_split_sections(args, kw):
    x = RNG.randn(*args[0]).astype(np.float32)
    got, want = _both("split", x, num_or_sections=args[1], **kw)
    assert_same(list(got), list(want), 0, 0, "split")
    with pytest.raises(ValueError):
        pt.split(torch.zeros(5, 2), 2)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
def test_pad_modes(mode):
    x = RNG.randn(2, 3, 4).astype(np.float32)
    for pad in ([1, 2], [1, 0, 2, 1], [0, 1, 1, 0, 2, 2]):
        got, want = _both("pad", x, pad=pad, mode=mode, value=0.5)
        assert_same(got, want, 0, 0, f"pad {mode} {pad}")


def test_scatter_accumulate_and_put_along_axis_reduce():
    x = RNG.randn(4, 3).astype(np.float32)
    idx = np.array([1, 1, 2])
    u = RNG.randn(3, 3).astype(np.float32)
    got, want = _both("scatter", x, idx, u, overwrite=False)
    assert_same(got, want, 1e-6, 1e-6, "scatter overwrite=False")
    ind = np.array([[0], [2], [1], [0]])
    v = RNG.randn(4, 1).astype(np.float32)
    for reduce in ("add", "mul", "amax", "amin"):
        got, want = _both("put_along_axis", x, ind, v, axis=1, reduce=reduce)
        assert_same(got, want, 1e-6, 1e-6, reduce)


def test_unique_options():
    x = np.array([3, 1, 2, 3, 1, 5], np.int64)
    got = pt.unique(torch.from_numpy(x), return_index=True,
                    return_inverse=True, return_counts=True)
    want = paddle.unique(paddle.to_tensor(x), return_index=True,
                         return_inverse=True, return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1),
                                      np.asarray(w.numpy()).reshape(-1))
    got = pt.unique_consecutive(torch.from_numpy(x), return_inverse=True,
                                return_counts=True)
    want = paddle.unique_consecutive(paddle.to_tensor(x),
                                     return_inverse=True, return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
