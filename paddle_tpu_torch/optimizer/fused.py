"""The fused optimizer step (port of ``paddle_tpu/optimizer/fused.py:65``
``FusedStepEngine``).

The eager ``Optimizer.step`` loop updates one parameter at a time, a
dozen elementwise passes each. The engine groups the parameters by
update signature and runs each group in one launch of kernel K-A
(``ops/optimizer_step.py``, :func:`adam_step_multi_tensor`), with the
global-norm clip's scale folded in, so the clip makes no copy of the
grads and the step no host sync. Groups are keyed as the reference's are,
by the parameter's learning-rate multiplier and weight-decay coefficient
(``:86-92``), and also by the parameter's dtype and device, whether it
has a master weight, and the step count its bias corrections use (all
alike in normal training). A group's device table is kept and rebuilt only
when a tensor of it is replaced (``set_state_dict`` replaces the slots).

What goes back to the eager loop, decided from the parameters'
attributes before any launch, as the reference's rule (``:79-85``) has
it: L1-regularised parameters, the second and later occurrences of a
tensor, and every parameter of an optimizer with no kernel yet (all but
``Adam`` and ``AdamW``). Also bf16/fp16 parameters without a master and
grads of another dtype than their parameter, which K-A does not take.
Master-weight parameters are not sent back: the reference does so only
because XLA's buffer donation cannot alias a master of another dtype
(``:14-17``). In the port they are the main path, and the eager
masterized loop stays their oracle.

Numerics: K-A gives the eager loop's bits on the same grads and scale
(``chip_smoke.py`` holds that on the card); on the CPU the group runs the
plain version, which is the eager loop's ops. The reference's engine
differs from its own eager loop by ~1e-5 relative (``:19-25``).

``dispatches`` counts what the reference's ``opt_telemetry()
["dispatches"]`` counts (``:47-62``): ``"eager"`` one a parameter that
the eager loop updates, ``"fused"`` one a group launch. The reference's
``PADDLE_FUSED_STEP*`` environment knobs have no counterpart: the
optimizer's ``fuse_step`` attribute and :data:`MIN_PARAMS` decide.
"""
from __future__ import annotations

from ..ops import optimizer_step as kern

#: auto (``fuse_step = None``) fuses a step that covers at least this many
#: parameters, as the reference's default does
MIN_PARAMS = 16
_LOW_PRECISION = kern._LOW_PRECISION


class FusedStepEngine:
    """One optimizer's fused step: its groups' tables and its counts."""

    def __init__(self, optimizer):
        self._opt = optimizer
        self._tables = {}
        self.dispatches = {"eager": 0, "fused": 0}
        #: group tables built so far (a rebuild follows a replaced tensor)
        self.table_builds = 0

    def plan(self, params_grads):
        """``(groups, leftover)``: ``{key: [(p, g), ...]}`` for K-A and the
        pairs for the eager loop, in order. Makes missing slots."""
        opt = self._opt
        groups, leftover, seen = {}, [], set()
        fusable = opt._fused_kind() is not None
        for p, g in params_grads:
            slots = opt._get_slots(p)
            reg = opt._param_regularizer(p) or opt.regularization
            master = "master" in slots
            if (not fusable or getattr(reg, "_l1", False) or id(p) in seen
                    or g.dtype != p.dtype
                    or (p.dtype in _LOW_PRECISION) != master):
                leftover.append((p, g))
                continue
            seen.add(id(p))
            key = (opt._lr_mult(p), opt._decay(p), p.dtype, p.device, master,
                   slots["step"] + 1)
            groups.setdefault(key, []).append((p, g))
        return groups, leftover

    def step(self, params_grads, lr, clip=None):
        """Update the fusable part of ``params_grads`` at rate ``lr``, one
        K-A launch a group, after ``clip``; return the eager loop's pairs,
        clipped. A global-norm clip (one with ``global_scale``) is folded
        into K-A; any other clip runs first, as in the eager loop."""
        if clip is not None and not hasattr(clip, "global_scale"):
            params_grads = clip(params_grads)
            clip = None
        groups, leftover = self.plan(params_grads)
        scale = None
        if clip is not None:
            scale = clip.global_scale(params_grads)
            if scale is not None:
                leftover = clip.scaled(leftover, scale)
        for key, pg in groups.items():
            self._run(key, pg, lr, scale)
        return leftover

    def _run(self, key, pg, lr, scale):
        opt = self._opt
        lr_mult, wd, _, _, _, t = key
        params = [p for p, _ in pg]
        slots = [opt.state[p] for p in params]
        tensors = ([s.get("master") for s in slots],
                   [s["moment1"] for s in slots],
                   [s["moment2"] for s in slots],
                   [getattr(p, "need_clip", True) for p in params])
        group = self._tables.get(key[:5])
        if group is None or group.signature != kern.AdamGroup.signature_of(
                params, *tensors):
            group = self._tables[key[:5]] = kern.AdamGroup(params, *tensors)
            self.table_builds += 1
        for s in slots:
            s["step"] += 1
        hp = kern.AdamHyper(lr * lr_mult, opt._beta1, opt._beta2,
                            opt._epsilon, wd, t, opt._fused_kind() == "adamw")
        kern.adam_step_multi_tensor(group, [g for _, g in pg], hp, scale)
        self.dispatches["fused"] += 1
