"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``: Paddle's
``Optimizer`` base, ``Adam`` and ``AdamW``), as ``torch.optim.Optimizer``
subclasses with Paddle's method names and update formulas.

Each optimizer keeps the reference's functional core: ``_init_slots(p)``
makes a parameter's state and ``_apply(p, g, slots, lr, t, wd)`` returns
the updated parameter and state, in the reference's order of operations
(so ``AdamW`` decays ``p * (1 - lr * wd)`` before its Adam step, which
``torch.optim.AdamW`` orders otherwise). Under ``multi_precision`` a bf16
or fp16 parameter gets an fp32 master copy and fp32 moments; the update
runs on the master and the parameter receives it rounded. Parameters,
master copies and moments are updated in place, so a module keeps its
own tensors and a step holds only a few temporaries of a parameter's
size (the reference's arrays are immutable; its results are the same).

``parameters`` takes tensors or ``(name, tensor)`` pairs such as
``model.named_parameters()`` gives (the names reach
``apply_decay_param_fun`` and ``state_dict``; the port's names are the
reference's ``state_dict`` names); ``weight_decay`` is a number.

Not ported: the fused step engine (``optimizer/fused.py``), the
optimizer's telemetry and determinism-ledger hooks, parameter groups,
regularizer objects, per-parameter regularizers and learning-rate
attributes, L1 decay, and the optimizers other than Adam and AdamW.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _named(parameters):
    """``(params, names)`` from tensors or (name, tensor) pairs; an
    unnamed tensor is ``param_<i>``."""
    params, names = [], []
    for i, item in enumerate(parameters):
        name, p = item if isinstance(item, tuple) else (f"param_{i}", item)
        params.append(p)
        names.append(name)
    return params, names


class Optimizer(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters() or model.named_parameters()")
        params, names = _named(parameters)
        super().__init__(params, {})
        self._parameter_list = params
        self._names = dict(zip(params, names))
        self._learning_rate = learning_rate
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._name = name

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state --------------------------------------------------------------
    def _wd_coeff(self, param):
        return 0.0 if self.regularization is None else float(
            self.regularization)

    def _get_slots(self, p):
        if not self.state.get(p):
            slots = self._init_slots(p.detach())
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                slots["master"] = p.detach().float()
            slots["step"] = 0
            self.state[p] = slots
        return self.state[p]

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
        if "master" in slots:
            new_slots["master"] = new_p
            p.copy_(new_p)
        self.state[p] = new_slots

    # -- the eager step ------------------------------------------------------
    def _decay(self, p):
        return self._wd_coeff(p)

    @torch.no_grad()
    def step(self):
        """Clip the grads (when ``grad_clip`` is set), then update every
        parameter that has a grad at the current learning rate."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            slots = self._get_slots(p)
            slots["step"] += 1
            self._masterized_apply(p, g, slots, lr, slots["step"],
                                   self._decay(p))

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

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """Paddle's layout: ``<name>_<slot>`` tensors, ``<name>_step``
        counts and, with a scheduler, ``"LR_Scheduler"``."""
        out = {}
        for p in self._parameter_list:
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
        for p in self._parameter_list:
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
        dt = torch.float32 if p.dtype in _LOW_PRECISION else p.dtype
        return {"moment1": torch.zeros_like(p, dtype=dt),
                "moment2": torch.zeros_like(p, dtype=dt)}

    def _decoupled(self):
        return False

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
    from decay."""

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

    def _decay(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names[p]):
            return 0.0
        return self._wd_coeff(p)


__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
