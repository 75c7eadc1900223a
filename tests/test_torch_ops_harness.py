"""The port's ops layer (``paddle_tpu_torch.ops``) against the reference's
own op suite: shared helpers, the coverage gate and the device rule.

``test_torch_ops_{logic,creation,math,manipulation,linalg}.py`` run every
``OpCase`` of ``tests/test_op_suite.py`` whose op the reference's
registry (``paddle_tpu.ops.schema.build_registry``) places in that
module: ``make()`` once, the same numpy inputs through the reference op
and the port op on the CPU, outputs within the case's ``rtol``/``atol``
and, for a case with ``grad``, the gradients of ``sum(out * w)`` within
its ``gtol`` (``OpCase.check_grad``'s relative rule). Dtypes must be the
reference's, except that the port keeps int64, float64 and complex128
where the reference narrows them (ROADMAP C26)."""
import functools
import inspect
import importlib
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.schema import _op_modules, build_registry
import op_test
from test_op_suite import CASES, EXEMPT, RANDOM_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import core as tcore

MODULES = ("logic", "creation", "math", "manipulation", "linalg")

#: port dtype -> the reference's narrowed one (ROADMAP C26)
C26 = {np.dtype(np.int64): np.dtype(np.int32),
       np.dtype(np.float64): np.dtype(np.float32),
       np.dtype(np.complex128): np.dtype(np.complex64)}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port's creation ops on the CPU, one torch thread; both
    restored after the module."""
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def registry():
    return build_registry()


def cases_of(module):
    """The reference's OpCases whose op its registry places in
    ``module``."""
    reg = registry()
    return [c for c in CASES if reg[c.name].module == module]


#: port counterparts of the cases given as callables, by case name
PORT_CALLABLES = {
    "einsum": lambda x, y: pt.einsum("ij,jk->ik", x, y),
    "permute": lambda x: pt.permute(x, 2, 0, 1),
    "as_complex": lambda x: pt.as_complex(pt.as_real(x)),
    "zeros": lambda: pt.zeros([2, 3]),
    "ones": lambda: pt.ones([2, 3]),
    "full": lambda: pt.full([2, 2], 7.0),
    "arange": lambda: pt.arange(0, 10, 2),
    "linspace": lambda: pt.linspace(0, 1, 5),
    "logspace": lambda: pt.logspace(0, 2, 3),
    "eye": lambda: pt.eye(3, 4),
    "meshgrid": lambda args: pt.meshgrid(*args),
    "atleast_1d": lambda x: pt.atleast_1d(x),
    "atleast_2d": lambda x: pt.atleast_2d(x),
    "atleast_3d": lambda x: pt.atleast_3d(x),
}


def port_fn(case):
    if callable(case.op):
        return PORT_CALLABLES[case.name]
    obj = pt
    for part in case.op.split("."):
        obj = getattr(obj, part)
    return obj


def to_port(v, grad=False):
    """A numpy input as a CPU tensor (float ones requiring grad when
    ``grad``); lists and tuples of arrays element by element; anything
    else as it is."""
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.array(v))
        if grad and t.dtype.is_floating_point:
            t.requires_grad_(True)
        return t
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(e, np.ndarray) for e in v):
        return type(v)(to_port(e, grad) for e in v)
    return v


def to_numpy(out):
    if isinstance(out, (list, tuple)):
        return type(out)(to_numpy(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.detach().resolve_conj().numpy()
    return np.asarray(out)


def assert_dtype(got, want, msg):
    got, want = np.dtype(got), np.dtype(want)
    assert got == want or C26.get(got) == want, (
        f"{msg}: dtype {got}, the reference's {want}")


def assert_same(got, want, rtol, atol, msg):
    """Structure, dtypes (C26 aside) and values: exact for integers and
    bools, within ``rtol``/``atol`` for floats."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (
            f"{msg}: structure {type(got).__name__}[{len(got)}], the "
            f"reference's {type(want).__name__}[{len(want)}]")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, atol, f"{msg}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (
        f"{msg}: shape {got.shape}, the reference's {want.shape}")
    assert_dtype(got.dtype, want.dtype, msg)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=rtol,
                                   atol=atol, err_msg=msg)


def _float_outputs(outs, numpy_of):
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [o for o in outs if hasattr(o, "shape") and np.issubdtype(
        np.asarray(numpy_of(o)).dtype, np.floating)]


def run_reference(case, inputs, grad):
    """The reference op on ``inputs``: (outputs as numpy, grads by input
    name for the grad keys, the output weights)."""
    out, tensors = case._call(inputs, differentiable=grad)
    got = case._unwrap(out)
    if not grad:
        return got, None, None
    keys = grad_keys(case, inputs)
    outs = _float_outputs(out, lambda o: o.numpy())
    rng = np.random.RandomState(0)
    ws = [np.asarray(rng.randn(*o.shape), np.float32) for o in outs]
    loss = None
    for o, w in zip(outs, ws):
        term = (o * paddle.to_tensor(w)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return got, {k: np.asarray(tensors[k].grad.numpy()) for k in keys}, ws


def grad_keys(case, inputs):
    return case.grad_vars or [
        k for k, v in inputs.items() if isinstance(v, np.ndarray)
        and np.issubdtype(v.dtype, np.floating)]


def run_port(case, inputs, ws):
    """The port op on the same inputs: (outputs as numpy, grads by input
    name or None)."""
    grad = ws is not None
    tensors = {k: to_port(v, grad) for k, v in inputs.items()}
    out = port_fn(case)(**tensors, **case.kwargs)
    got = to_numpy(out)
    if not grad:
        return got, None
    outs = _float_outputs(out, lambda o: o.detach().numpy())
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
    loss.backward()
    return got, {k: tensors[k].grad.numpy()
                 for k in grad_keys(case, inputs)}


def assert_grads(got, want, gtol, msg):
    """``OpCase.check_grad``'s criterion, port against reference:
    ``|a - b| / max(|a|, |b|, 1) <= gtol`` at every element."""
    for k, w in want.items():
        g = got[k]
        assert g is not None and g.shape == w.shape, f"{msg}: grad '{k}'"
        a, b = g.astype(np.float64), w.astype(np.float64)
        rel = np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                         1.0)
        assert rel.max() <= gtol, (
            f"{msg}: grad '{k}' relative error {rel.max():.3g} > {gtol}")


#: outputs that are unique only up to signs or pivots: held by what
#: they reconstruct and their invariants (as the reference's own suite
#: holds them), not element by element
def _svd_check(inputs, got, want):
    x = inputs["x"]
    u, s, vh = got
    np.testing.assert_allclose(s, want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((u * s) @ vh, x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-5)
    np.testing.assert_allclose(np.abs(u), np.abs(want[0]), atol=1e-4)


def _qr_check(inputs, got, want):
    x = inputs["x"]
    q, r = got
    np.testing.assert_allclose(q @ r, x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-5)
    np.testing.assert_array_equal(np.tril(r, -1), 0)
    np.testing.assert_allclose(np.abs(r), np.abs(want[1]), atol=1e-4)


def _eigh_check(inputs, got, want):
    x = inputs["x"]
    w, v = got
    np.testing.assert_allclose(w, want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((v * w) @ v.T, x, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.abs(v), np.abs(want[1]), atol=1e-4)


def _lstsq_check(inputs, got, want):
    """ROADMAP C27: two fp32 least-squares solvers (jnp's SVD, LAPACK's
    gelsy) differ by more than the case's 1e-5 on ~0.1 % of inputs, so
    the solution is held by the normal equations it satisfies, in fp64:
    ``max|A^T (A x - b)| <= LSTSQ_TOL eps32 ||A||_2 (||A||_2 max|x| +
    max|b|)``, the backward-stable solver's residual; the reference's own
    solution must meet the same bound."""
    a, b = inputs["x"].astype(np.float64), inputs["y"].astype(np.float64)
    na = np.linalg.norm(a, 2)
    for name, sol in (("port", got[0]), ("reference", want[0])):
        s = sol.astype(np.float64)
        res = np.abs(a.T @ (a @ s - b)).max()
        bound = LSTSQ_TOL * np.finfo(np.float32).eps * na * (
            na * np.abs(s).max() + np.abs(b).max())
        assert res <= bound, (f"lstsq {name}: normal-equations residual "
                              f"{res:.3g} > {bound:.3g}")


#: the lstsq rule's factor (C27): over 20,000 draws of the case's shapes
#: the worst ratio was 3.99 for the reference's solution, 2.00 for the
#: port's
LSTSQ_TOL = 8.0

INVARIANTS = {"svd": _svd_check, "qr": _qr_check, "eigh": _eigh_check,
              "lstsq": _lstsq_check}


def draw_inputs(case):
    """``case.make()`` with the reference suite's shared ``_RNG`` seeded
    from the case's name (a CRC, the same in every process), its state put
    back after: a case's inputs do not depend on which tests ran before
    it in the worker (ROADMAP C27)."""
    state = op_test._RNG.get_state()
    op_test._RNG.seed(zlib.crc32(case.name.encode()))
    try:
        return case.make()
    finally:
        op_test._RNG.set_state(state)


def run_case(case):
    """One reference OpCase through both packages."""
    inputs = draw_inputs(case)
    want, want_g, ws = run_reference(case, inputs, case.grad)
    got, got_g = run_port(case, inputs, ws)
    msg = f"{case.name}: port vs reference"
    if case.name in INVARIANTS:
        assert_same([g.dtype.type(0) for g in got],
                    [w.dtype.type(0) for w in want], 0, 0, msg)
        INVARIANTS[case.name](inputs, got, want)
    else:
        assert_same(got, want, case.rtol, case.atol, msg)
    if case.grad:
        assert_grads(got_g, want_g, case.gtol, msg)


# -- random ops --------------------------------------------------------------

PORT_RANDOM = {
    "rand": lambda: pt.rand([3, 4]),
    "uniform": lambda: pt.uniform([3, 4], min=-1.0, max=1.0),
    "randn": lambda: pt.randn([3, 4]),
    "standard_normal": lambda: pt.standard_normal([3, 4]),
    "normal": lambda: pt.normal(0.0, 1.0, [3, 4]),
    "randint": lambda: pt.randint(0, 10, [3, 4]),
    "randint_like": lambda: pt.randint_like(pt.zeros([3, 4]), low=0,
                                            high=10),
    "randperm": lambda: pt.randperm(8),
    "bernoulli": lambda: pt.bernoulli(pt.full([3, 4], 0.5)),
    "multinomial": lambda: pt.multinomial(
        pt.to_tensor(np.ones(5, np.float32) / 5), 3),
    "poisson": lambda: pt.poisson(pt.full([3, 4], 2.0)),
    "exponential_": lambda: pt.exponential_(pt.ones([3, 4])),
    "empty": lambda: pt.empty([2, 2]),
    "empty_like": lambda: pt.empty_like(pt.ones([2, 2])),
    "binomial": lambda: pt.binomial(pt.full([3, 4], 10.0),
                                    pt.full([3, 4], 0.5)),
    "standard_gamma": lambda: pt.standard_gamma(pt.full([3, 4], 2.0)),
    "log_normal": lambda: pt.log_normal(0.0, 1.0, [3, 4]),
    "top_p_sampling": lambda: pt.tensor.top_p_sampling(
        pt.to_tensor(np.full((2, 8), 0.125, np.float32)),
        pt.to_tensor(np.full((2,), 0.9, np.float32)))[1],
}

#: name -> a check of the values' range and kind
RANDOM_RANGES = {
    "rand": lambda a: (a >= 0).all() and (a < 1).all(),
    "uniform": lambda a: (a >= -1).all() and (a < 1).all(),
    "randint": lambda a: (a >= 0).all() and (a < 10).all(),
    "randint_like": lambda a: ((a >= 0) & (a < 10) & (a == np.round(a))
                               ).all(),
    "randperm": lambda a: sorted(a.tolist()) == list(range(8)),
    "bernoulli": lambda a: np.isin(a, [0.0, 1.0]).all(),
    "multinomial": lambda a: (len(set(a.tolist())) == 3
                              and ((a >= 0) & (a < 5)).all()),
    "poisson": lambda a: ((a >= 0) & (a == np.round(a))).all(),
    "exponential_": lambda a: (a > 0).all(),
    "empty": lambda a: True,
    "empty_like": lambda a: True,
    "binomial": lambda a: ((a >= 0) & (a <= 10)).all(),
    "standard_gamma": lambda a: (a > 0).all(),
    "log_normal": lambda a: (a > 0).all(),
    "top_p_sampling": lambda a: ((a >= 0) & (a < 8)).all(),
    "randn": lambda a: True,
    "standard_normal": lambda a: True,
    "normal": lambda a: True,
}

#: random ops whose output depends on no draw
DRAWLESS = {"empty", "empty_like"}


def run_random(name):
    """Shape and dtype against the reference's draw, range and
    finiteness, the same bits after the same ``seed``, other bits after
    another."""
    paddle.seed(7)
    want = np.asarray(RANDOM_OPS[name]().numpy())
    pt.seed(7)
    got = to_numpy(PORT_RANDOM[name]())
    assert got.shape == want.shape, name
    assert_dtype(got.dtype, want.dtype, name)
    if np.issubdtype(got.dtype, np.floating):
        assert np.isfinite(got).all(), name
    assert RANDOM_RANGES[name](got), (name, got)
    pt.seed(7)
    np.testing.assert_array_equal(to_numpy(PORT_RANDOM[name]()), got,
                                  err_msg=f"{name}: not seeded")
    if name not in DRAWLESS:
        pt.seed(8)
        assert not np.array_equal(to_numpy(PORT_RANDOM[name]()), got), (
            f"{name}: the same bits under another seed")


# -- coverage ----------------------------------------------------------------

#: ops of the five modules the reference's suite exempts from OpCases:
#: name -> the port test (file::function) that holds it to the reference
PORT_EXEMPT = {
    "complex": "test_torch_ops_creation.py::test_complex_and_polar",
    "polar": "test_torch_ops_creation.py::test_complex_and_polar",
    "tril_indices": "test_torch_ops_creation.py::test_tri_indices",
    "triu_indices": "test_torch_ops_creation.py::test_tri_indices",
    "lu_unpack": "test_torch_ops_linalg.py::test_lu_family",
    "lu_solve": "test_torch_ops_linalg.py::test_lu_family",
    "matrix_transpose": "test_torch_ops_linalg.py::test_linalg_extras",
    "cholesky_inverse": "test_torch_ops_linalg.py::test_linalg_extras",
    "eig": "test_torch_ops_linalg.py::test_eig_and_eigvals",
    "eigvals": "test_torch_ops_linalg.py::test_eig_and_eigvals",
    "pca_lowrank": "test_torch_ops_linalg.py::test_low_rank",
    "svd_lowrank": "test_torch_ops_linalg.py::test_low_rank",
    "norm": "test_torch_ops_linalg.py::test_norm_aliases",
    "dist": "test_torch_ops_linalg.py::test_norm_aliases",
    "rank": "test_torch_ops_manipulation.py::test_rank_shape_crop",
    "shape": "test_torch_ops_manipulation.py::test_rank_shape_crop",
    "crop": "test_torch_ops_manipulation.py::test_rank_shape_crop",
    "view": "test_torch_ops_manipulation.py::test_views",
    "view_as": "test_torch_ops_manipulation.py::test_views",
    "index_copy": "test_torch_ops_manipulation.py::test_index_copy",
    "reshape_": "test_torch_ops_manipulation.py::test_in_place_variants",
    "squeeze_": "test_torch_ops_manipulation.py::test_in_place_variants",
    "unsqueeze_": "test_torch_ops_manipulation.py::test_in_place_variants",
    "fill_diagonal_": "test_torch_ops_manipulation.py::test_fill_diagonal",
    "fill_diagonal_tensor_":
        "test_torch_ops_manipulation.py::test_fill_diagonal",
    "histogramdd": "test_torch_ops_math.py::test_histogramdd",
    "broadcast_shape": "test_torch_ops_math.py::test_host_helpers",
    "tolist": "test_torch_ops_math.py::test_host_helpers",
    "igamma": "test_torch_ops_math.py::test_gamma_aliases",
    "igammac": "test_torch_ops_math.py::test_gamma_aliases",
}

#: the reference's top-level in-place aliases the port has too, and the
#: test that holds each
INPLACE_TESTS = {
    "scatter_": "test_torch_ops_manipulation.py::test_in_place_variants",
    "tril_": "test_torch_ops_creation.py::test_in_place_variants",
    "triu_": "test_torch_ops_creation.py::test_in_place_variants",
    "normal_": "test_torch_ops_creation.py::test_in_place_random",
    "bernoulli_": "test_torch_ops_creation.py::test_in_place_random",
    "reshape_": PORT_EXEMPT["reshape_"],
    "squeeze_": PORT_EXEMPT["squeeze_"],
    "unsqueeze_": PORT_EXEMPT["unsqueeze_"],
    "fill_diagonal_tensor_": PORT_EXEMPT["fill_diagonal_tensor_"],
}


def _test_exists(where):
    fname, func = where.split("::")
    text = (Path(__file__).parent / fname).read_text()
    return re.search(rf"^def {re.escape(func)}\(", text, re.M) is not None


def test_coverage_gate():
    """Every registry op of the five modules has a port function with the
    reference's signature (in its module and, but for linalg, at the top
    level), and a parity OpCase, a random-op check or a port exemption
    naming an existing test; so has each top-level in-place variant."""
    reg, mods = registry(), _op_modules()
    covered = {c.name for c in CASES} | set(RANDOM_OPS) | set(PORT_EXEMPT)
    problems = []
    for name, spec in sorted(reg.items()):
        if spec.module not in MODULES:
            continue
        ref = vars(mods[spec.module])[name]
        port = getattr(importlib.import_module(
            f"paddle_tpu_torch.ops.{spec.module}"), name, None)
        if port is None:
            problems.append(f"{spec.module}.{name}: no port function")
            continue
        if str(inspect.signature(port)) != str(inspect.signature(ref)):
            problems.append(f"{name}: signature {inspect.signature(port)}, "
                            f"the reference's {inspect.signature(ref)}")
        if spec.module != "linalg" and getattr(pt, name, None) is not port:
            problems.append(f"{name}: not at the top level")
        if name not in covered:
            problems.append(f"{name}: no parity case and no exemption")
        inplace = name + "_"
        if hasattr(paddle, inplace):
            mine = getattr(pt, inplace, None)
            if mine is None or str(inspect.signature(mine)) != str(
                    inspect.signature(getattr(paddle, inplace))):
                problems.append(f"{inplace}: missing or another signature")
            elif inplace not in INPLACE_TESTS:
                problems.append(f"{inplace}: no test named")
    for where in set(PORT_EXEMPT.values()) | set(INPLACE_TESTS.values()):
        if not _test_exists(where):
            problems.append(f"exemption names a missing test: {where}")
    assert set(PORT_EXEMPT) <= set(EXEMPT) | set(INPLACE_TESTS), sorted(
        set(PORT_EXEMPT) - set(EXEMPT))
    assert not problems, "\n".join(problems)


def test_case_inputs_do_not_depend_on_history():
    """C27: every OpCase draws the same inputs whatever the worker drew
    before, and leaves the shared ``_RNG`` as it found it."""
    first = {c.name: draw_inputs(c) for c in CASES}
    op_test._RNG.randn(7)
    state = op_test._RNG.get_state()
    def same(a, b):
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc")

    for case in reversed(CASES):
        again = draw_inputs(case)
        assert again.keys() == first[case.name].keys(), case.name
        for key, v in again.items():
            assert same(v, first[case.name][key]), f"{case.name}.{key}"
    after = op_test._RNG.get_state()
    assert after[0] == state[0] and after[2:] == state[2:]
    np.testing.assert_array_equal(after[1], state[1])


def test_every_case_lands_in_one_module_file():
    """The five files together run every OpCase of the reference's
    suite, each once."""
    counts = [len(cases_of(m)) for m in MODULES]
    assert sum(counts) == len(CASES) and all(counts)


def test_creation_needs_cuda_or_the_cpu_device():
    """The entry-point rule: a creation op or ``to_tensor`` on the default
    device raises without CUDA; after ``set_device("cpu")`` it works."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    pt.set_device("gpu:0")
    assert pt.get_device() == "gpu:0"
    try:
        for make in (lambda: pt.zeros([2]), lambda: pt.to_tensor([1.0]),
                     lambda: pt.randn([2]), lambda: pt.arange(3)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    finally:
        pt.set_device("cpu")
    assert pt.zeros([2]).device.type == "cpu"
    assert pt.to_tensor([1.0]).dtype == torch.float32


def test_device_and_dtype_surface():
    assert pt.get_device() == "cpu"
    with pytest.raises(ValueError):
        pt.set_device("tpu")
    assert pt.to_tensor(np.zeros(2)).dtype == torch.float64   # C26
    assert pt.to_tensor([1, 2]).dtype == torch.int64
    t = pt.to_tensor([1.0], stop_gradient=False)
    assert t.requires_grad
    try:
        pt.set_default_dtype("float64")
        assert pt.get_default_dtype() == "float64"
        assert pt.ones([2]).dtype == torch.float64
        assert pt.to_tensor([0.5]).dtype == torch.float64
    finally:
        pt.set_default_dtype("float32")
    with pytest.raises(TypeError):
        pt.set_default_dtype("int32")
    from paddle_tpu_torch.framework import dtype as tdtype
    for s in ("bf16", "float16", "fp32", "double", "int64", "bool"):
        want = np.dtype(paddle.framework.dtype.convert_dtype(s)).name
        got = tdtype.dtype_name(tdtype.convert_dtype(s))
        assert got == want or (got, want) in (("float64", "float32"),
                                              ("int64", "int32"))
    assert tdtype.convert_dtype(np.float32) == torch.float32


def test_rng_state_round_trip():
    """``get_rng_state``/``set_rng_state`` replay the current device's
    stream; the CUDA states are empty without CUDA."""
    pt.seed(3)
    state = pt.get_rng_state()
    a = pt.randn([4])
    pt.set_rng_state(state)
    assert torch.equal(pt.randn([4]), a)
    assert isinstance(pt.get_cuda_rng_state(), list)
    from paddle_tpu_torch.framework import random as trandom
    assert pt.seed(3) is trandom.generator("cpu")
    assert trandom.default_generator() is trandom.generator("cpu")
