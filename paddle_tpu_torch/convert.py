"""Weight carry-over from the JAX reference model."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_jax_state(model, arrays):
    """Fill ``model`` from the JAX model's ``state_dict()`` given as
    ``{name: numpy array}``. Names are the same in both packages; a
    Linear weight is ``[in, out]`` there and ``[out, in]`` here, so it is
    transposed. Missing, extra or mis-shaped keys raise ``KeyError`` /
    ``ValueError``. Returns ``model``."""
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
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
