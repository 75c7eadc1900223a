"""The port's op registry (``paddle_tpu_torch/ops/schema.py``) against the
reference's (``paddle_tpu.ops.schema.build_registry``): every module of
the reference's registry, ``sparse`` and ``geometric`` included, with
the same op names under the same module keys, the same aliases, and
each op's parameter names and defaults, apart from the listed
differences; the committed ``ops.yaml`` and ``backward.yaml``
are what the code generates; and ``backward.yaml``'s differentiability
claim holds for every op the test suites run: an op is differentiable
exactly when a float output of it on inputs that require grad
requires grad (has a ``grad_fn``, or is such an input itself)."""
import functools
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.schema import build_registry as reference_registry
from torch_nn_cases import CASES as FUNCTIONAL_CASES
from torch_nn_cases import case_arrays, case_id, flat_outputs
from test_torch_ops_harness import (_port_on_cpu, cases_of,  # noqa: F401
                                    draw_inputs, port_fn, to_port)

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.ops import schema

YAML_DIR = Path(schema.__file__).parent

#: ops whose signature differs from the reference's registry record
SIGNATURES = {
    # an explicit torch.Generator for the dropout draw (ROADMAP C2)
    "scaled_dot_product_attention": "generator",
    # the port's fused rope takes q and k with their tables
    "fused_rotary_position_embedding": "q and k only",
    "fused_swiglu": "gate required",
    # a torch device where the reference takes a jnp dtype
    "rope_freqs": "device",
}


@functools.lru_cache(maxsize=None)
def _registries():
    return reference_registry(), schema.build_registry()


@pytest.mark.parametrize("module", sorted(schema._op_modules()))
def test_module_names_equal_the_references(module):
    ref, port = _registries()
    want = {n: s.aliases for n, s in ref.items() if s.module == module}
    got = {n: s.aliases for n, s in port.items() if s.module == module}
    assert got == want


def test_missing_modules_are_the_unported_ones():
    ref, port = _registries()
    ported = set(schema._op_modules())
    assert {s.module for s in ref.values()} - ported == set(
        schema.MISSING_MODULES) == set()
    assert list(schema._op_modules()) == [
        "math", "creation", "manipulation", "logic", "linalg", "fused",
        "fft", "signal", "sparse", "geometric", "functional"]
    assert schema.summary(port)["missing_modules"] == []


def test_functional_has_every_reference_op_and_alias():
    ref, port = _registries()
    for name, s in ref.items():
        if s.module == "functional" or "functional" in s.aliases:
            where = port[name].module, port[name].aliases
            assert "functional" in (where[0],) + where[1], name
    assert sum(s.module == "functional" for s in ref.values()) == 111
    assert sum("functional" in s.aliases for s in ref.values()) == 7


def _params(sig_owner):
    return [(p.name, repr(p.default) if p.default is not p.empty else None)
            for p in inspect.signature(sig_owner).parameters.values()]


def test_signatures_equal_the_references():
    """Parameter names, order and defaults, by ``inspect.signature``:
    each op under its module key, and each op the reference's
    ``nn.functional`` owns or aliases (``relu`` and ``softmax`` among
    them, registered under ``sparse``) against the reference's
    functional one."""
    ref, port = _registries()
    mods = schema._op_modules()
    differ = []
    for name, spec in sorted(port.items()):
        if name not in ref:
            continue
        got = _params(getattr(mods[spec.module], name))
        want = _params(_ref_function(ref[name]))
        if got != want:
            differ.append(name)
    assert sorted(differ) == sorted(SIGNATURES)
    functional = sorted(n for n, s in ref.items()
                        if s.module == "functional"
                        or "functional" in s.aliases)
    assert {"relu", "softmax"} <= set(functional)
    differ = [n for n in functional
              if _params(getattr(TF, n)) != _params(getattr(JF, n))]
    assert differ == sorted(set(SIGNATURES) & set(functional))


def _ref_function(spec):
    from paddle_tpu.ops.schema import _op_modules
    return getattr(_op_modules()[spec.module], spec.name)


@pytest.mark.parametrize("fname", sorted(schema.YAML_FILES))
def test_committed_yaml_is_fresh(fname):
    """``python -m paddle_tpu_torch.ops.schema`` writes what is
    committed."""
    want = schema.YAML_FILES[fname](schema.build_registry())
    assert (YAML_DIR / fname).read_text() == want


def test_backward_yaml_names_the_kernel_and_custom_rules():
    text = (YAML_DIR / "backward.yaml").read_text()
    assert "kernel_backward: B2, B3" in text
    assert "backward_op: flash_fwd\n" in text and "_ChunkedAttention" in text
    assert "jax" not in text


def _has_grad(out):
    floats = [o for o in flat_outputs(out) if isinstance(o, torch.Tensor)
              and o.is_floating_point()]
    return any(o.requires_grad for o in floats)


def _check_claim(name, spec, out):
    assert _has_grad(out) == schema.differentiable(spec), (
        f"{name}: grad_fn {_has_grad(out)}, claimed "
        f"{schema.differentiable(spec)}")


@pytest.mark.parametrize("case", FUNCTIONAL_CASES, ids=case_id)
def test_functional_differentiability_claim(case):
    spec = schema.build_registry()[case.op] if case.op in _registries()[1] \
        else None
    if spec is None:
        pytest.fail(f"{case.op} is not in the registry")
    arrays = case_arrays(case)
    if not any(np.issubdtype(a.dtype, np.floating) for k, a in arrays.items()
               if k not in case.nograd):
        if not schema.differentiable(spec):
            return
    tensors = {k: torch.from_numpy(a.copy()).requires_grad_(
        np.issubdtype(a.dtype, np.floating) and k not in case.nograd)
        for k, a in arrays.items()}
    _check_claim(case.op, spec, case.fn(TF, tensors))


MODULES = ("math", "manipulation", "linalg", "logic", "creation")


@pytest.mark.parametrize("module", MODULES)
def test_ops_differentiability_claim(module):
    """Every reference OpCase of the module with a float tensor input."""
    port = _registries()[1]
    checked = 0
    for case in cases_of(module):
        inputs = draw_inputs(case)
        if not any(isinstance(v, np.ndarray) and np.issubdtype(
                v.dtype, np.floating) for v in inputs.values()):
            continue
        if case.name == "cast":
            continue         # differentiable to a float dtype only
        tensors = {k: to_port(v, True) for k, v in inputs.items()}
        _check_claim(case.name, port[case.name],
                     port_fn(case)(**tensors, **case.kwargs))
        checked += 1
    assert checked >= 5


def _fft_signal_call(name, spec):
    """A call of an ``fft`` / ``signal`` op on inputs that require grad
    (a complex leaf for ``istft``; none for the frequency tables)."""
    from paddle_tpu_torch import fft, signal
    x = torch.randn(4, 8, dtype=torch.float64, requires_grad=True)
    if name in ("fftfreq", "rfftfreq"):
        return fft.__dict__[name](8)
    if spec.module == "fft":
        return fft.__dict__[name](x)
    if name == "istft":
        c = torch.randn(2, 3, 5, dtype=torch.complex128, requires_grad=True)
        return signal.istft(c, 4)
    args = {"frame": (4, 2), "overlap_add": (2,), "stft": (4,)}[name]
    return signal.__dict__[name](x, *args)


@pytest.mark.parametrize("module,count", [("fft", 22), ("signal", 4)])
def test_fft_and_signal_ops_and_differentiability_claim(module, count):
    """Both registries hold the module's ops, and each op's claim holds on
    a call whose inputs require grad (complex outputs count as float
    ones)."""
    ref, port = _registries()
    assert sum(s.module == module for s in ref.values()) == count
    names = sorted(n for n, s in port.items() if s.module == module)
    assert len(names) == count
    for name in names:
        outs = [o for o in flat_outputs(_fft_signal_call(name, port[name]))
                if o.is_floating_point() or o.is_complex()]
        assert outs and any(o.requires_grad for o in outs) == \
            schema.differentiable(port[name]), name


def _sparse_geometric_call(name):
    """A call of a ``sparse`` / ``geometric`` op on float inputs that
    require grad (the sparse ones through their values)."""
    from paddle_tpu_torch import geometric, sparse
    v = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    idx = [[0, 1, 1], [0, 0, 2]]
    coo = sparse.sparse_coo_tensor(idx, v, [2, 3])
    d = torch.randn(2, 3).requires_grad_()
    x = torch.randn(4, 3).requires_grad_()
    ids = torch.tensor([0, 0, 2, 1])
    calls = {
        "coalesce": lambda: sparse.coalesce(coo),
        "is_same_shape": lambda: sparse.is_same_shape(coo, d),
        "is_sparse": lambda: sparse.is_sparse(coo),
        "mask_as": lambda: sparse.mask_as(d, coo),
        "masked_matmul": lambda: sparse.masked_matmul(
            d, torch.randn(3, 3).requires_grad_(), coo),
        "relu": lambda: sparse.relu(coo),
        "softmax": lambda: sparse.softmax(coo),
        "sparse_coo_tensor": lambda: sparse.sparse_coo_tensor(idx, v, [2, 3]),
        "sparse_csr_tensor": lambda: sparse.sparse_csr_tensor(
            [0, 1, 3], [0, 0, 2], v, [2, 3]),
        "send_u_recv": lambda: geometric.send_u_recv(x, ids, ids),
        "send_ue_recv": lambda: geometric.send_ue_recv(x, x, ids, ids),
        "send_uv": lambda: geometric.send_uv(x, x, ids, ids),
    }
    for r in ("sum", "mean", "max", "min"):
        calls[f"segment_{r}"] = (lambda r=r: getattr(
            geometric, f"segment_{r}")(x, ids))
    out = calls[name]()
    return out.values() if sparse.is_sparse(out) else out


@pytest.mark.parametrize("module,count", [("sparse", 9), ("geometric", 7)])
def test_sparse_and_geometric_differentiability_claim(module, count):
    """The ops ``sparse`` and ``geometric`` own in both registries, and each
    op's claim on a call whose float inputs require grad (a sparse
    result by its values; ``is_sparse`` and ``is_same_shape`` give
    bools)."""
    ref, port = _registries()
    names = sorted(n for n, s in port.items() if s.module == module)
    assert len(names) == count == sum(s.module == module
                                      for s in ref.values())
    for name in names:
        out = _sparse_geometric_call(name)
        _check_claim(name, port[name], out if isinstance(
            out, torch.Tensor) else [])
