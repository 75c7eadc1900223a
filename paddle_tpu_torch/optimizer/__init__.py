"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``: Paddle's
``Optimizer`` base with parameter groups, gradient clipping, regularizers
and ``multi_precision`` master weights, and SGD, Momentum, Adam, AdamW,
Adamax, Adagrad, RMSProp, Adadelta and Lamb), as ``torch.optim.Optimizer``
subclasses with Paddle's method names and update formulas.

Each optimizer keeps the reference's functional core: ``_init_slots(p)``
makes a parameter's state and ``_apply(p, g, slots, lr, t, wd)`` returns
the updated parameter and state, in the reference's order of operations
(so ``AdamW`` decays ``p * (1 - lr * wd)`` before its Adam step, which
``torch.optim.AdamW`` orders otherwise). Under ``multi_precision`` a bf16
or fp16 parameter gets an fp32 master copy; the update runs on the master
and the parameter receives it rounded. A bf16 or fp16 parameter's slots
are fp32 for Adam and Momentum, as in the reference; the other
optimizers' slots start in the parameter's dtype, as the reference's do,
and PyTorch's type promotion, which is JAX's for these ops, makes them
fp32 at the first step that mixes them with the fp32 master.
Parameters, master copies and Adam's moments are updated in place, so a
module keeps its own tensors and a step holds only a few temporaries of
a parameter's size (the reference's arrays are immutable; its results
are the same).

``parameters`` takes tensors, ``(name, tensor)`` pairs such as
``model.named_parameters()`` gives (the names reach
``apply_decay_param_fun`` and ``state_dict``; the port's names are the
reference's ``state_dict`` names), or parameter groups: dicts whose
``"params"`` hold either (the reference reads only ``"params"``).
``weight_decay`` is a number, ``L2Decay`` or ``L1Decay``. Per parameter,
``p.optimize_attr = {"learning_rate": m}`` multiplies the rate and
``p.regularizer`` overrides ``weight_decay``; ``p.need_clip = False``
exempts a grad from clipping.

The step: when ``fuse_step`` is True, or None (auto) and the step covers
at least ``fused.MIN_PARAMS`` parameters, the fused engine
(``optimizer/fused.py``) updates the parameters it can in one kernel
launch a group and returns the rest to the eager loop below.

``optimizer/extras.py`` adds Rprop, ASGD, NAdam, RAdam and LBFGS.

Not ported: the optimizer's telemetry and determinism-ledger hooks, and kernels for
the fused groups of any optimizer but Adam and AdamW (their parameters
take the eager loop).
"""
from __future__ import annotations

import torch

from . import fused
from .lr import LRScheduler

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _named(parameters):
    """``(params, names)`` from tensors, (name, tensor) pairs, or groups
    (dicts with ``"params"``) of either; an unnamed tensor is
    ``param_<i>``, numbered over all groups."""
    params, names = [], []
    items = list(parameters)
    if items and isinstance(items[0], dict):
        items = [x for group in items for x in group["params"]]
    for i, item in enumerate(items):
        name, p = item if isinstance(item, tuple) else (f"param_{i}", item)
        params.append(p)
        names.append(name)
    return params, names


class L2Decay:
    """L2 regularization: ``coeff * p`` added to the grad."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L1Decay:
    """L1 regularization: ``coeff * sign(p)`` added to the grad (the eager
    loop applies it; such parameters never take the fused step)."""
    _l1 = True

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class _ZeroDecay:
    """What ``AdamW``'s ``apply_decay_param_fun`` gives an exempt
    parameter: no decay, and no L1 either."""
    _coeff = 0.0


class Optimizer(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters() or model.named_parameters()")
        params, names = _named(parameters)
        # torch's bookkeeping sees each tensor once; the step sees
        # every occurrence, as the reference's does
        super().__init__(list({id(p): p for p in params}.values()), {})
        self._parameter_list = params
        self._names = {}               # each tensor's first name
        for p, n in zip(params, names):
            self._names.setdefault(p, n)
        self._learning_rate = learning_rate
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._name = name
        #: None: fuse when the step covers fused.MIN_PARAMS parameters
        self.fuse_step = None
        self._fused_engine = fused.FusedStepEngine(self)

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- per-parameter attributes -------------------------------------------
    def _wd_coeff(self):
        wd = self.regularization
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    def _param_regularizer(self, p):
        """The parameter's own regularizer, or None."""
        return getattr(p, "regularizer", None)

    def _decay(self, p):
        """The L2 coefficient of ``p``: its own regularizer's, else the
        optimizer's."""
        reg = self._param_regularizer(p)
        return self._wd_coeff() if reg is None else float(
            getattr(reg, "_coeff", 0.0))

    @staticmethod
    def _lr_mult(p):
        return float(getattr(p, "optimize_attr", {}).get("learning_rate",
                                                         1.0))

    def _fused_kind(self):
        """The fused kernel this optimizer's groups take, or None."""
        return None

    # -- state --------------------------------------------------------------
    def _get_slots(self, p):
        if not self.state.get(p):
            slots = self._init_slots(p.detach())
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                slots["master"] = p.detach().float()
            slots["step"] = 0
            self.state[p] = slots
        return self.state[p]

    @staticmethod
    def _zeros32(p):
        """Adam's and Momentum's slot: zeros like ``p``, fp32 for a bf16 or
        fp16 parameter."""
        return torch.zeros_like(p, dtype=torch.float32
                                if p.dtype in _LOW_PRECISION else p.dtype)

    # -- functional core (override per optimizer) ---------------------------
    def _init_slots(self, p):
        return {}

    def _apply(self, p, g, slots, lr, t, wd):
        raise NotImplementedError

    def _masterized_apply(self, p, g, slots, lr, t, wd):
        """Run ``_apply`` on the fp32 master (and an fp32 grad) when the
        parameter has one, else on the parameter; write the result back
        into ``p``."""
        if "master" in slots:
            p_arr, g = slots["master"], g.float()
        else:
            p_arr = p.detach()
        new_p, new_slots = self._apply(p_arr, g, slots, lr, t, wd)
        if new_p is not p_arr:
            p_arr.copy_(new_p)
        if "master" in slots:
            p.copy_(p_arr)
        self.state[p] = new_slots

    # -- the step ------------------------------------------------------------
    def _use_fused(self, n_params):
        if self.fuse_step is not None:
            return bool(self.fuse_step)
        return n_params >= fused.MIN_PARAMS

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a grad at the current learning
        rate, after clipping the grads (when ``grad_clip`` is set): the
        fused engine first, when it engages, then the eager loop on what
        it leaves."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        lr = self.get_lr()
        if params_grads and self._use_fused(len(params_grads)):
            params_grads = self._fused_engine.step(params_grads, lr,
                                                   self._grad_clip)
        elif self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._fused_engine.dispatches["eager"] += len(params_grads)
        for p, g in params_grads:
            slots = self._get_slots(p)
            slots["step"] += 1
            reg = self._param_regularizer(p) or self.regularization
            if getattr(reg, "_l1", False):
                # L1: coeff * sign(w) joins the grad; no L2 term
                g = g + float(getattr(reg, "_coeff", 0.0)) * torch.sign(p)
                wd = 0.0
            else:
                wd = self._decay(p)
            self._masterized_apply(p, g, slots, lr * self._lr_mult(p),
                                   slots["step"], wd)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """Paddle's layout: ``<name>_<slot>`` tensors, ``<name>_step``
        counts and, with a scheduler, ``"LR_Scheduler"``."""
        out = {}
        for p in self._names:
            slots = self.state.get(p)
            if not slots:
                continue
            name = self._names[p]
            for sname, value in slots.items():
                out[f"{name}_{sname}"] = value
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for p in self._names:
            slots = self._get_slots(p)
            name = self._names[p]
            for sname in list(slots):
                key = f"{name}_{sname}"
                if key not in state:
                    continue
                if sname == "step":
                    slots[sname] = int(state[key])
                else:
                    # a copy: the step updates its states in place
                    slots[sname] = torch.as_tensor(state[key]).to(
                        device=p.device, dtype=slots[sname].dtype,
                        copy=True)

    set_dict = set_state_dict


class SGD(Optimizer):
    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        return p.sub_(lr * g), slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": self._zeros32(p)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        v = self._momentum * slots["velocity"] + g
        if self._nesterov:
            p = p - lr * (g + self._momentum * v)
        else:
            p = p - lr * v
        return p, {**slots, "velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots(self, p):
        return {"moment1": self._zeros32(p), "moment2": self._zeros32(p)}

    def _decoupled(self):
        return False

    def _fused_kind(self):
        return "adamw" if self._decoupled() else "adam"

    def _apply(self, p, g, slots, lr, t, wd):
        # the reference's formula and order; the moments, the parameter
        # (or its master) and the temporaries are updated in place, which
        # rounds exactly as the out-of-place ops do and keeps a 0.5 G
        # element update to ~3 temporaries of its size
        if wd and not self._decoupled():
            g = g + wd * p
        m = slots["moment1"].mul_(self._beta1).add_((1 - self._beta1) * g)
        v = slots["moment2"].mul_(self._beta2).add_(
            (1 - self._beta2) * g * g)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        if wd and self._decoupled():
            p.mul_(1 - lr * wd)
        p.sub_(mhat.mul_(lr).div_(vhat.sqrt_().add_(self._epsilon)))
        return p, {**slots, "moment1": m, "moment2": v}


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01).
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from decay (and from an L1 ``weight_decay``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self):
        return True

    def _param_regularizer(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names[p]):
            return _ZeroDecay()
        return super()._param_regularizer(p)


class Adamax(Adam):
    def _init_slots(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _fused_kind(self):
        return None

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], g.abs())
        p = p - lr / (1 - self._beta1 ** t) * m / (u + self._epsilon)
        return p, {**slots, "moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        acc = slots["moment"] + g * g
        p = p - lr * g / (acc.sqrt() + self._epsilon)
        return p, {**slots, "moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_slots(self, p):
        return {"mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p),
                "momentum": torch.zeros_like(p)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        rho = self._rho
        ms = rho * slots["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * g
            denom = (ms - mg * mg + self._epsilon).sqrt()
        else:
            mg = slots["mean_grad"]
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * slots["momentum"] + lr * g / denom
        return p - mom, {**slots, "mean_square": ms, "mean_grad": mg,
                         "momentum": mom}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _init_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        rho, asu = self._rho, slots["avg_squared_update"]
        asg = rho * slots["avg_squared_grad"] + (1 - rho) * g * g
        update = g * (asu + self._epsilon).sqrt() / (asg + self._epsilon
                                                     ).sqrt()
        asu = rho * asu + (1 - rho) * update * update
        return p - lr * update, {**slots, "avg_squared_grad": asg,
                                 "avg_squared_update": asu}


class Lamb(Optimizer):
    """LAMB: Adam's moments, an update ``r`` with ``lamb_weight_decay * p``
    added (unless ``exclude_from_weight_decay_fn(p)``), scaled by the
    trust ratio ``|p| / |r|``. No per-parameter rates or regularizers, as
    in the reference."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._fused_engine.dispatches["eager"] += len(params_grads)
        for p, g in params_grads:
            slots = self._get_slots(p)
            slots["step"] += 1
            excluded = (self._exclude_fn is not None
                        and self._exclude_fn(p))
            self._masterized_apply(p, g, slots, lr, slots["step"],
                                   0.0 if excluded else self._lamb_wd)

    def _apply(self, p, g, slots, lr, t, wd):
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (vhat.sqrt() + self._epsilon) + wd * p
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * r, {**slots, "moment1": m, "moment2": v}


from .extras import ASGD, LBFGS, NAdam, RAdam, Rprop  # noqa: E402

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Adadelta", "Lamb", "L1Decay", "L2Decay",
           "Rprop", "ASGD", "NAdam", "RAdam", "LBFGS", "lr"]
