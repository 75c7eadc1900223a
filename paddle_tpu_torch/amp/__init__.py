"""Automatic mixed precision (port of ``paddle_tpu/amp/__init__.py``):
``auto_cast`` with the O1 white/black lists and O2 pure fp16/bf16,
``decorate`` (O2 parameters cast, fp32 master weights in the optimizer)
and ``GradScaler`` (dynamic loss scaling).

The reference casts at one point, ``tape.apply``, which hands every op's
tensor arguments to :func:`amp_cast_inputs` under the op's name. The
port has no tape: each op site (``nn/functional/``, ``nn/layers/``,
``ops/fused.py``, ``models/llama.py``, ``vision/models/resnet.py``)
calls :func:`amp_cast_inputs` with the reference's
op name at the same boundary, then :func:`promote`, which mixes float
dtypes as jnp does, where the reference's op mixes them.

The state is one per process, as the reference's is: ``auto_cast`` sets
it on entry and restores it on exit, whatever thread then runs an op.
"""
from __future__ import annotations

import contextlib

import torch

# fp16/bf16-safe ops (matmul-class): the reference's lists, copied
WHITE_LIST = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "sdpa", "addmm",
}
# numerically sensitive: forced to fp32
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "bce", "bce_with_logits", "kl_div",
    "mse_loss", "l1_loss", "smooth_l1_loss", "sum", "mean", "norm", "cumsum",
    "pow", "square", "rsqrt", "sigmoid_focal_loss", "cosine_similarity",
    "softmax_with_cross_entropy", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm",
}

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


class _AmpState:
    enabled = False
    level = "O1"
    dtype = torch.float16
    white = WHITE_LIST
    black = BLACK_LIST


_state = _AmpState()
#: open :func:`debugging.collect_operator_stats` regions; each gets every
#: op's (name, input dtypes, cast dtypes)
_recorders = []


def amp_state():
    return _state


def _snapshot():
    return (_state.enabled, _state.level, _state.dtype, _state.white,
            _state.black)


def state_key():
    """The AMP state as a hashable key: ``(False,)`` when it is off (every
    disabled state casts nothing), else ``(True, level, dtype, white,
    black)`` with the lists as frozensets. A program captured under one
    key computes what the ops cast under that state only."""
    if not _state.enabled:
        return (False,)
    return (True, _state.level, _state.dtype, frozenset(_state.white),
            frozenset(_state.black))


def _restore(snap):
    (_state.enabled, _state.level, _state.dtype, _state.white,
     _state.black) = snap


@contextlib.contextmanager
def _restored(snap):
    """Run a block under the AMP state ``snap`` (a recompute replays its
    forward's casts), then put the current one back."""
    prev = _snapshot()
    _restore(snap)
    try:
        yield
    finally:
        _restore(prev)


def _cast_tensors(args, dt):
    return [a.to(dt) if isinstance(a, torch.Tensor) and a.dtype in _FLOATS
            and a.dtype != dt else a for a in args]


def _policy(op_name, args):
    if not _state.enabled or op_name == "cast":
        # the cast is the policy's own tool: recasting its input would
        # recurse (cast -> amp cast -> cast ...)
        return args
    if _state.level == "O2":
        if op_name in _state.black:
            return _cast_tensors(args, torch.float32)
        return _cast_tensors(args, _state.dtype)
    if op_name in _state.white:
        return _cast_tensors(args, _state.dtype)
    if op_name in _state.black:
        return _cast_tensors(args, torch.float32)
    return list(args)


def amp_cast_inputs(op_name, args):
    """The tensors ``args`` of op ``op_name``, cast by the AMP policy: O2
    casts every float tensor to the AMP dtype unless the op is black
    (then fp32); O1 casts a white op's to the AMP dtype and a black op's
    to fp32 and leaves the rest. Integer tensors and other values pass
    through. Returns a list."""
    out = _policy(op_name, args)
    for rec in _recorders:
        rec.record(op_name, args, out)
    return out


def result_dtype(*dtypes):
    """jnp's promotion of float dtypes, which ``torch.promote_types``
    gives on dtypes alone: equal dtypes stay, bf16 with fp16 and either
    with fp32 give fp32. torch's operators promote a 0-dim tensor beside
    an n-dim one otherwise (the n-dim's dtype wins); the op sites take
    this instead."""
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def promote(*tensors):
    """``tensors`` with the float ones cast to their :func:`result_dtype`,
    where the reference's op mixes dtypes and jnp would promote (torch's
    ``F.linear`` raises on fp32 x with a bf16 weight)."""
    floats = [t.dtype for t in tensors
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not floats:
        return tensors
    dt = result_dtype(*floats)
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != dt else t
                 for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="float16", use_promote=True):
    """Cast the inputs of the ops inside the block by the AMP policy
    (:func:`amp_cast_inputs`). ``custom_white_list`` adds to the white
    list and leaves the black one; ``custom_black_list`` adds to the
    black list. Blocks nest; each restores the state it found."""
    prev = _snapshot()
    white = set(custom_white_list or ())
    _state.enabled = enable
    _state.level = level
    _state.dtype = _dtype(dtype)
    _state.white = WHITE_LIST | white
    _state.black = (BLACK_LIST | set(custom_black_list or ())) - white
    try:
        yield
    finally:
        _restore(prev)


amp_guard = auto_cast  # legacy alias


def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast every float32 parameter of ``models`` to ``dtype`` in
    place (the tensors the optimizers hold stay theirs), except those of
    the norm layers (``_BatchNormBase``, ``LayerNorm``, ``GroupNorm``,
    always, as the reference) and of layers that are instances of a
    class in ``excluded_layers``, and set each optimizer's
    ``_multi_precision``, so it makes fp32 master weights from the cast
    parameters at its first step (the fp32 bits are gone, as in the
    reference). Buffers keep their dtype. O1 changes nothing. Returns
    ``models``, or ``(models, optimizers)`` when optimizers are given."""
    from ..nn.layers.norm import GroupNorm, LayerNorm, _BatchNormBase
    model_list = (list(models) if isinstance(models, (list, tuple))
                  else [models])
    if level == "O2":
        dt = _dtype(dtype)
        excluded = (_BatchNormBase, LayerNorm, GroupNorm) + tuple(
            excluded_layers or ())
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, excluded):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.dtype == torch.float32:
                        p.data = p.data.to(dt)
        if optimizers is not None:
            opt_list = (optimizers if isinstance(optimizers, (list, tuple))
                        else [optimizers])
            for opt in opt_list:
                opt._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers


def check_finite_and_unscale(grads, inv):
    """Unscale ``grads`` in place, ``(g.float() * inv).to(g.dtype)`` each,
    and return whether any input element was inf or nan, as a one-element
    fp32 tensor on the grads' device (1 if so). One multi-tensor pass
    (PyTorch's ``_amp_foreach_non_finite_check_and_unscale_``), the
    counterpart of the reference's jitted ``_check_finite_and_unscale``
    (``:19``): it checks each element before it scales it, and rounds the
    fp32 product to the grad's dtype. Grads on one device."""
    dev = grads[0].device
    found = torch.zeros(1, dtype=torch.float32, device=dev)
    inv_t = torch.full((1,), inv, dtype=torch.float32, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv_t)
    return found


class GradScaler:
    """Dynamic loss scaling (reference ``:151``): ``scale`` multiplies the
    loss; ``step`` unscales every grad of the optimizer's parameters in
    one pass with an inf/nan check (one host sync), steps the optimizer
    only if all were finite, and updates the scale: times ``decr_ratio``
    (floor 1.0) after ``decr_every_n_nan_or_inf`` bad steps in a row,
    times ``incr_ratio`` after ``incr_every_n_steps`` good ones. A
    skipped step leaves parameters, master weights, moments and step
    counts as they were."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def _unscale(self, optimizer):
        if not self._enable or self._unscaled:
            return
        # each tensor once: a parameter listed twice has one grad
        grads = list({id(p.grad): p.grad for p in optimizer._parameter_list
                      if p.grad is not None}.values())
        self._found_inf = bool(grads) and bool(
            check_finite_and_unscale(grads, 1.0 / self._scale))
        self._unscaled = True

    def unscale_(self, optimizer):
        self._unscale(optimizer)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()
        self._unscaled = False

    def update(self):
        pass  # step() already updates; kept for torch-style loops

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale_ratio(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def _device_type(device):
    """The device's type; the reference's ``"gpu"`` names CUDA."""
    if device is None:
        return "cuda"
    s = str(device).lower()
    return "cuda" if s.startswith(("gpu", "cuda")) else torch.device(s).type


def is_bfloat16_supported(device=None):
    """bf16 on a CUDA device (``None`` means CUDA) of compute capability
    8.0 or more, and on the CPU, as in the reference."""
    kind = _device_type(device)
    if kind == "cpu":
        return True
    return (kind == "cuda" and torch.cuda.is_available()
            and torch.cuda.get_device_capability()[0] >= 8)


def is_float16_supported(device=None):
    """fp16 on a CUDA device (``None`` means CUDA); not on the CPU, as in
    the reference."""
    return _device_type(device) == "cuda" and torch.cuda.is_available()


from . import debugging  # noqa: E402,F401  (paddle.amp.debugging)

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "state_key",
           "amp_cast_inputs",
           "result_dtype", "promote", "auto_cast", "amp_guard", "decorate",
           "GradScaler", "check_finite_and_unscale",
           "is_bfloat16_supported", "is_float16_supported", "debugging"]
