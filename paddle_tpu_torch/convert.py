"""Weight carry-over between the port and the JAX reference: any model of
``Layer``s (or ``torch.nn`` modules) whose ``state_dict`` names are the
reference's. A ``Linear`` weight changes layout (``[in, out]`` there,
``[out, in]`` here, ROADMAP C3), and so do the int8 codes ``_w_int8`` of a
converted ``quantization.QuantedLinear`` and the weight of a sparse 3-D
convolution (``sparse.nn.Conv3D`` / ``SubmConv3D``: ``[kd, kh, kw, in,
out]`` there, ``[out, in, kd, kh, kw]`` here); dense convolution, norm and
embedding weights and the buffers (BatchNorm's ``_mean`` and
``_variance``, a converted layer's ``_w_scale`` and a converted
``QuantedConv2D``'s codes) carry as they are. A ``QAT``- or
``PTQ``-wrapped model's parameters are ``<layer>.inner.weight`` in both
packages. The reference keeps a converted layer's codes and scales as
attributes outside its ``state_dict``: give them under
``<layer>._w_int8`` and ``<layer>._w_scale``."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model):
    """The names stored ``[out, in]`` here and ``[in, out]`` there: every
    Linear weight, and the int8 codes of a converted ``QuantedLinear``
    (its ``inner`` is the Linear)."""
    out = set()
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.Linear):
            out.add(prefix + "weight")
        elif (isinstance(getattr(m, "inner", None), nn.Linear)
              and "_w_int8" in m._buffers):
            out.add(prefix + "_w_int8")
    return out


#: the sparse convolutions' weight, DHWIO there -> torch's OIDHW here,
#: and back
_TO_OIDHW, _TO_DHWIO = (4, 3, 0, 1, 2), (2, 3, 4, 1, 0)


def _sparse_conv_weights(model):
    from .sparse import _SparseConvBase
    return {(f"{name}." if name else "") + "weight"
            for name, m in model.named_modules()
            if isinstance(m, _SparseConvBase)}


def load_jax_state(model, arrays):
    """Fill ``model`` from the JAX model's ``state_dict()`` (parameters and
    persistable buffers) given as ``{name: numpy array}``, each cast to
    its target's dtype. Names are the same in both packages; a Linear
    weight is ``[in, out]`` there and ``[out, in]`` here, so it is
    transposed, and a sparse convolution's weight is permuted from
    ``[kd, kh, kw, in, out]`` to ``[out, in, kd, kh, kw]``. Missing,
    extra or mis-shaped keys raise ``KeyError`` / ``ValueError`` (a
    model with ``tie_word_embeddings`` has no ``lm_head.weight``, nor has
    the reference's then). Returns ``model``."""
    linear = _linear_weights(model)
    conv3d = _sparse_conv_weights(model)
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, dst in own.items():
            src = np.asarray(arrays[name])
            if name in linear:
                src = src.T
            elif name in conv3d and src.ndim == 5:
                src = src.transpose(_TO_OIDHW)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src)))
    return model


def jax_layout(model, tensors=None):
    """The inverse of :func:`load_jax_state`: ``{name: tensor}`` of
    ``model`` (its ``state_dict()`` when ``tensors`` is None; or, say,
    its parameters' ``.grad``) as ``{name: numpy array}`` in the JAX
    model's layout, every Linear weight transposed to ``[in, out]`` and
    every sparse convolution's weight to ``[kd, kh, kw, in, out]``.
    Every array is a copy, so later in-place updates of the model do not
    reach it; a bf16 tensor becomes float32 (numpy has no bf16)."""
    linear = _linear_weights(model)
    conv3d = _sparse_conv_weights(model)
    if tensors is None:
        tensors = model.state_dict()
    out = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        if name in linear:
            a = a.T
        elif name in conv3d:
            a = a.transpose(_TO_DHWIO)
        out[name] = np.array(a, order="C")
    return out
