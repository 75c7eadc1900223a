"""Building a model of ``Layer``s on a device from a seed.

A model of the zoo builds its layers inside ``torch.device("meta")``
(nothing is allocated or drawn there), then :func:`materialize`
allocates them on the device and fills every parameter by its own
initializer (the one the reference's layer names: ``Normal``,
``XavierUniform``, ``Uniform``, ``Constant``), drawn in
``named_parameters`` order from one
``torch.Generator`` seeded with ``seed``. The draws are not the
reference's JAX key streams (ROADMAP C2); the distributions are its."""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..nn.initializer import Constant, Normal, Uniform, XavierUniform


def _fill(p, init, gen):
    if isinstance(init, Constant):
        p.fill_(init.value)
    elif isinstance(init, Normal):
        p.normal_(init.mean, init.std, generator=gen)
    elif isinstance(init, XavierUniform):
        # a Linear's weight is stored [out, in]; the fans of [in, out] sum
        # the same, and the limit depends on their sum alone
        lim = init.limit(tuple(p.shape))
        p.uniform_(-lim, lim, generator=gen)
    elif isinstance(init, Uniform):
        p.uniform_(init.low, init.high, generator=gen)
    else:
        raise TypeError(f"no seeded draw for {type(init).__name__}")


def materialize(model, device, seed):
    """Allocate ``model``'s meta parameters on ``device`` (``None`` means
    ``"cuda"``, which raises where CUDA is absent) and fill them from
    ``seed``; a ``"meta"`` device leaves the model as it is (a submodel
    built on its parent's meta device). Returns the device."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev
    inits = {name: getattr(p, "initializer", None)
             for name, p in model.named_parameters()}
    model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if inits[name] is None:
                raise TypeError(f"{name} has no initializer")
            _fill(p, inits[name], gen)
    return dev
