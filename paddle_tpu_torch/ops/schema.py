"""The op registry (port of ``paddle_tpu/ops/schema.py``): one record per
public op of the port's op modules, derived from the functions
themselves, and its exports ``ops.yaml`` and ``backward.yaml`` beside
this file.

``python -m paddle_tpu_torch.ops.schema`` rewrites both files; the tests
hold the committed ones to what the code gives. The records carry the
reference's fields: module, signature, first doc line, Tensor-method
availability and in-place variant (both read off ``torch.Tensor``, so
they may differ from the reference's own ``Tensor``), and the other
modules a name also appears in. Every op module of the reference is
ported (:data:`MISSING_MODULES` is empty).
"""
from __future__ import annotations

import inspect
import os
import re
from dataclasses import dataclass, field

import torch

#: the reference's op modules the port does not have yet: none
MISSING_MODULES = ()

#: public callables of the op modules that are not ops: the attention
#: route chooser and the blocked attention the SDPA uses
_EXCLUDE = {"sdpa_route", "chunked_attention"}


@dataclass
class OpSpec:
    name: str
    module: str
    signature: str
    doc: str = ""
    tensor_method: bool = False
    inplace_variant: bool = False
    aliases: tuple = field(default_factory=tuple)


def _op_modules():
    """The registry's modules, in the reference's order (the first module
    that defines a name owns it)."""
    from . import creation, fused, linalg, logic, manipulation, math
    from .. import fft, geometric, signal, sparse
    from ..nn import functional
    return {"math": math, "creation": creation, "manipulation": manipulation,
            "logic": logic, "linalg": linalg, "fused": fused, "fft": fft,
            "signal": signal, "sparse": sparse, "geometric": geometric,
            "functional": functional}


def build_registry():
    """One :class:`OpSpec` per public function defined in an op module (a
    name a later module defines again is recorded as its alias)."""
    registry = {}
    for key, mod in _op_modules().items():
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_") or name in _EXCLUDE:
                continue
            if not callable(obj) or inspect.isclass(obj) \
                    or inspect.ismodule(obj):
                continue
            owner = getattr(obj, "__module__", "") or ""
            if not (owner == mod.__name__
                    or owner.startswith(mod.__name__ + ".")):
                continue
            try:
                sig = str(inspect.signature(obj))
            except (TypeError, ValueError):
                sig = "(...)"
            if name in registry:
                registry[name].aliases += (key,)
                continue
            registry[name] = OpSpec(
                name=name, module=key, signature=sig,
                doc=(inspect.getdoc(obj) or "").split("\n")[0],
                tensor_method=hasattr(torch.Tensor, name),
                inplace_variant=hasattr(torch.Tensor, name + "_"))
    return registry


_HEADER = "# GENERATED by python -m paddle_tpu_torch.ops.schema — do not edit."


def to_yaml(registry=None):
    """``ops.yaml``: the records sorted by name, one field a line."""
    registry = registry or build_registry()
    lines = [_HEADER,
             "# One record per public op; see paddle_tpu_torch/ops/schema.py.",
             ""]
    for name in sorted(registry):
        s = registry[name]
        lines.append(f"- op: {name}")
        lines.append(f"  module: {s.module}")
        lines.append(f"  args: \"{s.signature}\"")
        if s.tensor_method:
            lines.append("  tensor_method: true")
        if s.inplace_variant:
            lines.append(f"  inplace: {name}_")
        if s.aliases:
            lines.append(f"  also_in: [{', '.join(s.aliases)}]")
        lines.append("")
    return "\n".join(lines)


def summary(registry=None):
    registry = registry or build_registry()
    per_mod = {}
    for s in registry.values():
        per_mod[s.module] = per_mod.get(s.module, 0) + 1
    return {"total_ops": len(registry),
            "tensor_methods": sum(s.tensor_method for s in registry.values()),
            "inplace_variants": sum(s.inplace_variant
                                    for s in registry.values()),
            "per_module": per_mod, "missing_modules": list(MISSING_MODULES)}


#: modules whose ops have no gradient, but for :data:`DIFFERENTIABLE`
NONDIFF_MODULES = {"creation", "logic"}
#: ops of those modules that pass a gradient (values taken or rearranged
#: from a float input)
DIFFERENTIABLE = {"sort", "topk", "kthvalue", "mode", "tril", "triu", "diag",
                  "diagflat", "diagonal", "diag_embed", "assign", "clone",
                  "vander"}
#: ops of the other modules whose outputs carry no gradient (integer,
#: bool or index results, sampling, masks, host values)
NONDIFF = {"argmax", "argmin", "nanargmax", "nanargmin", "argsort",
           "searchsorted", "bucketize", "bincount", "count_nonzero",
           "nonzero", "unique", "unique_consecutive", "histogram",
           "histogramdd", "histogram_bin_edges", "matrix_rank", "shard_index",
           "isin", "isfinite", "isinf", "isnan", "isneginf", "isposinf",
           "isreal", "signbit", "isclose", "allclose", "equal_all",
           "one_hot", "numel", "tolist", "sequence_mask", "randperm",
           "multinomial", "class_center_sample", "gather_tree", "fftfreq",
           "rfftfreq", "is_sparse", "is_same_shape"}
#: ops whose gradient a hand-written CUDA backward kernel computes on
#: the card (their plain versions on the CPU)
KERNEL_BACKWARD = {
    "scaled_dot_product_attention":
        "B2, B3 (csrc/flash_attention_bwd.cu) on the flash route, through "
        "ops/flash_attention.py",
}


def _custom_backwards():
    """``(file, name, kind)`` of every hand-written backward rule in the
    package: each ``torch.autograd.Function`` class and each custom op
    given a backward by ``register_autograd``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                text = f.read()
            rel = os.path.relpath(path, os.path.dirname(root))
            for name in re.findall(
                    r"^class (\w+)\(torch\.autograd\.Function\)", text,
                    re.MULTILINE):
                out.append((rel.replace(os.sep, "/"), name,
                            "autograd.Function"))
            for name in re.findall(r"^(\w+)\.register_autograd\(", text,
                                   re.MULTILINE):
                out.append((rel.replace(os.sep, "/"), name,
                            "torch.library.register_autograd"))
    return sorted(out)


def differentiable(spec):
    """Whether the op's output carries a gradient (the claim the tests
    hold to autograd: a ``grad_fn`` on its output from inputs that
    require grad). ``cast`` is claimed differentiable, which it is to a
    float dtype."""
    if spec.module in NONDIFF_MODULES:
        return spec.name in DIFFERENTIABLE
    return spec.name not in NONDIFF


def backward_yaml(registry=None):
    """``backward.yaml``: one grad record per differentiable op. Every
    gradient comes from autograd through the op's PyTorch forward
    (``grad_source: autograd``); ``kernel_backward`` names the CUDA
    kernels that compute it on the card. Then the hand-written backward
    rules of the package (``torch.autograd.Function`` classes and custom
    ops with a registered backward)."""
    registry = registry or build_registry()
    lines = [_HEADER,
             "# Grad provenance per differentiable op: autograd through the",
             "# op's forward, and the CUDA backward kernels where the card",
             "# runs them.",
             ""]
    for name in sorted(registry):
        s = registry[name]
        if not differentiable(s):
            continue
        lines.append(f"- backward_op: {name}_grad")
        lines.append(f"  forward: {name}{s.signature}")
        lines.append("  grad_source: autograd")
        if name in KERNEL_BACKWARD:
            lines.append(f"  kernel_backward: {KERNEL_BACKWARD[name]}")
        lines.append("")
    lines.append("# --- hand-written backward rules (torch.autograd.Function,")
    lines.append("# torch.library.register_autograd)")
    lines.append("")
    for rel, name, kind in _custom_backwards():
        lines.append(f"- backward_op: {name}")
        lines.append(f"  source: {rel}")
        lines.append(f"  grad_source: {kind}")
        lines.append("")
    return "\n".join(lines)


YAML_FILES = {"ops.yaml": to_yaml, "backward.yaml": backward_yaml}


def write_yaml(directory=None):
    """Write ``ops.yaml`` and ``backward.yaml`` (into this package's
    directory by default); returns their paths."""
    directory = directory or os.path.dirname(os.path.abspath(__file__))
    registry = build_registry()
    paths = []
    for fname, fn in YAML_FILES.items():
        path = os.path.join(directory, fname)
        with open(path, "w") as f:
            f.write(fn(registry))
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in write_yaml():
        print(p)
