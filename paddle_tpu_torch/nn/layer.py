"""``Layer`` and its containers (port of ``paddle_tpu/nn/layer.py``):
Paddle's module base class as a ``torch.nn.Module`` with Paddle's names.

``Layer`` keeps torch's machinery (registration, ``train(mode)``,
``.to(...)``, ``load_state_dict``, forward hooks) and adds Paddle's
spellings on top:

* ``parameters()`` returns a list; ``named_parameters(prefix,
  include_sublayers)`` takes torch's ``recurse`` and
  ``remove_duplicate`` too; ``sublayers``, ``named_sublayers``,
  ``buffers``, ``named_buffers``, ``add_parameter``, ``add_sublayer``;
* ``create_parameter`` builds a parameter through an initializer
  (``weight_attr`` / ``bias_attr`` first, then the layer's default) and
  carries the ``ParamAttr``'s learning rate, regularizer, trainability
  and clipping onto it (``optimize_attr``, ``regularizer``,
  ``need_clip``), where the port's optimizers read them, and the
  ``ParamAttr`` itself as ``param_attr``;
* ``register_buffer(name, t, persistable)``; a buffer that is not
  persistable stays out of ``state_dict`` (torch's ``persistent``);
* ``state_dict`` orders the keys as the reference does: every parameter
  (pre-order over the layers, each tensor once), then every persistable
  buffer (pre-order). torch interleaves them layer by layer, and lists
  a shared parameter under each of its names (so torch's strict
  ``load_state_dict`` of such a ``state_dict`` reports the other names
  missing);
* ``set_state_dict`` (``set_dict``, ``load_dict``) copies values in,
  cast to each target's dtype, and returns ``(missing, unexpected)``;
* ``register_forward_pre_hook`` / ``register_forward_post_hook``
  return a :class:`HookRemoveHelper`;
* ``clear_gradients``, ``astype``, ``full_name``, ``to`` with Paddle's
  dtype and device names.

Names join with ``"."`` as torch's do, and as Paddle's own ``Layer``
does; the reference concatenates a ``prefix`` without the dot.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ..framework import dtype as dtypes
from ..framework.param_attr import ParamAttr

_names = collections.Counter()


def _auto_name(prefix):
    _names[prefix] += 1
    return f"{prefix}_{_names[prefix] - 1}"


class HookRemoveHelper:
    """Removes one forward hook from the dict it was registered in."""

    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


def _torch_device(device):
    """Paddle's ``"gpu"`` / ``"gpu:N"`` as torch's ``"cuda"``."""
    if isinstance(device, str) and device.lower().startswith("gpu"):
        return "cuda" + device[3:]
    return device


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        # nn.Module's own __init__, not the next class of the MRO: a layer
        # that also derives from a torch layer (``Linear``) builds its
        # parameters itself
        nn.Module.__init__(self)
        self._dtype = dtypes.dtype_name(dtype)
        self._full_name = name_scope or _auto_name(type(self).__name__.lower())

    # -- registration -------------------------------------------------------
    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects an nn.Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """Paddle's ``persistable`` or torch's ``persistent``; returns the
        tensor."""
        super().register_buffer(
            name, tensor, persistent=persistable if persistent is None
            else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A parameter of ``shape`` from ``attr``'s initializer, else
        ``default_initializer``, else ``Constant(0)`` for a bias and
        ``XavierUniform`` for a weight; on ``device`` (see
        :func:`~paddle_tpu_torch.nn.initializer.param_device`)."""
        from .initializer import Constant, XavierUniform
        dtype = dtype or self._dtype or "float32"
        attr = ParamAttr._to_attr(attr)
        if attr is not False and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        else:
            init = Constant(0.0) if is_bias else XavierUniform()
        return self._parameter(init(shape, dtype, device), attr, init)

    @staticmethod
    def _parameter(data, attr, init):
        p = nn.Parameter(data)
        p.initializer = init
        if attr:
            # the ParamAttr itself too: its ``name`` cannot be the
            # tensor's (``Tensor.name`` is torch's named-tensor field)
            p.param_attr = attr
            p.optimize_attr = {"learning_rate": attr.learning_rate}
            p.regularizer = attr.regularizer
            p.trainable = attr.trainable
            p.need_clip = attr.need_clip
            p.requires_grad_(attr.trainable)
        return p

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers if recurse is None
            else recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers if recurse is None
            else recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, recurse=None):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """``(name, layer)`` in pre-order, each layer once."""
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def apply(self, fn):
        """``fn`` on this layer, then on every sublayer (pre-order, as the
        reference; torch's ``apply`` goes children first)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._full_name

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """Parameters first, then persistable buffers, each in pre-order
        (the reference's order). ``prefix`` (torch's spelling, as torch
        passes it to a child) is prepended as it is, like
        ``structured_name_prefix``. Values are detached unless
        ``keep_vars``."""
        pfx = structured_name_prefix if prefix is None else prefix
        dest = (destination if destination is not None
                else collections.OrderedDict())
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[pfx + name] = p if keep_vars else p.detach()
        mods = (self.named_modules() if include_sublayers
                else [("", self)])
        for mname, m in mods:
            for bname, b in m._buffers.items():
                if b is not None and bname not in m._non_persistent_buffers_set:
                    key = f"{mname}.{bname}" if mname else bname
                    dest[pfx + key] = b if keep_vars else b.detach()
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or arrays) into the
        tensor of the same name, cast to its dtype; a shape that differs
        raises ``ValueError``. Returns ``(missing, unexpected)`` keys."""
        own = self.state_dict(keep_vars=True)
        unexpected = []
        for key, value in state_dict.items():
            if key not in own:
                unexpected.append(key)
                continue
            dst = own[key]
            src = (value.detach() if isinstance(value, torch.Tensor)
                   else torch.from_numpy(np.array(value)))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype / device -----------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """torch's ``to``, also with Paddle's keywords and names
        (``"float32"``, ``"gpu:0"``, ``blocking``)."""
        args = [dtypes.convert_dtype(a) if isinstance(a, str)
                and a.lower() in dtypes._STR2DTYPE else _torch_device(a)
                for a in args]
        if device is not None:
            kwargs["device"] = _torch_device(device)
        if dtype is not None:
            kwargs["dtype"] = dtypes.convert_dtype(dtype)
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        """Every floating parameter and buffer to ``dtype``, which new
        parameters then take too."""
        self._dtype = dtypes.dtype_name(dtype)
        return self.to(dtype=dtype)

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs):
        """``hook(layer, inputs)``, before ``forward``; what it returns
        (not None) replaces the inputs."""
        handle = super().register_forward_pre_hook(hook, **kwargs)
        return HookRemoveHelper(self._forward_pre_hooks, handle.id)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``, after ``forward``; what it
        returns (not None) replaces the outputs."""
        handle = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)

    # -- misc ---------------------------------------------------------------
    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


class Sequential(Layer):
    """Layers called in order; ``Sequential(a, b)`` names them ``"0"``,
    ``"1"``, ``Sequential([("x", a), ("y", b)])`` by the given names."""

    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


__all__ = ["Layer", "Sequential", "LayerList", "LayerDict", "ParameterList",
           "HookRemoveHelper"]
