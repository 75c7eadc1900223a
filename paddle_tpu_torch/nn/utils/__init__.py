"""``nn.utils`` (port of ``paddle_tpu/nn/utils/__init__.py``): weight and
spectral normalization as forward pre-hooks, parameters to and from one
vector, and the gradient clipping functions."""
from __future__ import annotations

import torch
from torch import nn

from ...framework import random as prandom
from ..clip_grad import clip_grad_norm_, clip_grad_value_  # noqa: F401


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated, in order."""
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters``."""
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


def _set_plain(layer, name, tensor):
    """Store a computed weight as a plain attribute (not a parameter)."""
    object.__setattr__(layer, name, tensor)


def weight_norm(layer, name="weight", dim=0):
    """Reparametrize ``layer.<name> = g * v / ||v||``: the parameter is
    replaced by ``<name>_g`` (the norms over every axis but ``dim``; 0
    when None, as in the reference) and ``<name>_v`` (its value), and a
    forward pre-hook recomputes the weight before each call. Returns
    ``layer``."""
    w = getattr(layer, name)
    keep = dim if dim is not None else 0
    axes = [i for i in range(w.ndim) if i != keep]
    with torch.no_grad():
        g = w.square().sum(dim=axes, keepdim=True).sqrt()
    layer.add_parameter(name + "_g", nn.Parameter(g))
    layer.add_parameter(name + "_v", nn.Parameter(w.detach().clone()))
    del layer._parameters[name]

    def hook(lyr, inputs):
        v = lyr._parameters[name + "_v"]
        norm = v.square().sum(dim=axes, keepdim=True).sqrt()
        _set_plain(lyr, name, lyr._parameters[name + "_g"] * v / norm)

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_hooks = getattr(layer, "_weight_norm_hooks", {})
    layer._weight_norm_hooks[name] = handle
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one parameter ``<name>`` holding the
    current normalized weight, and drop the hook. Returns ``layer``."""
    w = getattr(layer, name).detach().clone()
    layer._parameters.pop(name + "_v")
    layer._parameters.pop(name + "_g")
    handle = getattr(layer, "_weight_norm_hooks", {}).pop(name, None)
    if handle is not None:
        handle.remove()
    del layer.__dict__[name]
    layer.add_parameter(name, nn.Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value, estimated by
    ``n_power_iterations`` of power iteration per forward on the weight
    with axis ``dim`` (0 when None) first and the rest flattened. The
    parameter becomes ``<name>_orig``; ``u`` starts from a normal draw of
    the port's generator and persists between calls. ``u`` and ``v`` are
    constants of the gradient, which flows through ``sigma = u W v``
    (the reference's weight carries none; ROADMAP C30). Returns
    ``layer``."""
    w = getattr(layer, name)
    dim = 0 if dim is None else dim
    rows = w.shape[dim]
    u = torch.empty(rows, device=w.device).normal_(
        generator=prandom.generator(w.device))
    state = {"u": u / torch.linalg.vector_norm(u)}
    layer.add_parameter(name + "_orig", nn.Parameter(w.detach().clone()))
    del layer._parameters[name]

    def hook(lyr, inputs):
        wv = lyr._parameters[name + "_orig"]
        mat = wv.movedim(dim, 0).reshape(rows, -1)
        with torch.no_grad():
            u_ = state["u"]
            for _ in range(n_power_iterations):
                v_ = mat.T @ u_
                v_ = v_ / torch.clamp(torch.linalg.vector_norm(v_), min=eps)
                u_ = mat @ v_
                u_ = u_ / torch.clamp(torch.linalg.vector_norm(u_), min=eps)
            state["u"] = u_
        _set_plain(lyr, name, wv / (u_ @ mat @ v_))

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_",
           "clip_grad_value_"]
