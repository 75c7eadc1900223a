"""Weight carry-over between the port and the JAX reference: any model of
``Layer``s (or ``torch.nn`` modules) whose ``state_dict`` names are the
reference's. Only a ``Linear`` weight changes layout (``[in, out]`` there,
``[out, in]`` here, ROADMAP C3); convolution, norm and embedding weights
and the buffers (BatchNorm's ``_mean`` and ``_variance``) carry as they
are."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model):
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, nn.Linear)}


def load_jax_state(model, arrays):
    """Fill ``model`` from the JAX model's ``state_dict()`` (parameters and
    persistable buffers) given as ``{name: numpy array}``, each cast to
    its target's dtype. Names are the same in both packages; a Linear
    weight is ``[in, out]`` there and ``[out, in]`` here, so it is
    transposed. Missing, extra or mis-shaped keys raise ``KeyError`` /
    ``ValueError`` (a model with ``tie_word_embeddings`` has no
    ``lm_head.weight``, nor has the reference's then). Returns
    ``model``."""
    linear = _linear_weights(model)
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
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src)))
    return model


def jax_layout(model, tensors=None):
    """The inverse of :func:`load_jax_state`: ``{name: tensor}`` of
    ``model`` (its ``state_dict()`` when ``tensors`` is None; or, say,
    its parameters' ``.grad``) as ``{name: numpy array}`` in the JAX
    model's layout, every Linear weight transposed to ``[in, out]``.
    Every array is a copy, so later in-place updates of the model do not
    reach it; a bf16 tensor becomes float32 (numpy has no bf16)."""
    linear = _linear_weights(model)
    if tensors is None:
        tensors = model.state_dict()
    out = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[name] = np.array(a.T if name in linear else a, order="C")
    return out
