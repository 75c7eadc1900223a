"""Rprop, ASGD, NAdam, RAdam and LBFGS (port of
``paddle_tpu/optimizer/extras.py:13-281``) on the port's ``Optimizer``:
each keeps the reference's functional core (``_init_slots``, ``_apply``)
and order of operations, and runs in the eager loop (none of them has a
fused kernel). ``LBFGS.step(closure)`` runs the reference's two-loop
recursion over flat parameter and gradient vectors, with its optional
strong-Wolfe line search.
"""
from __future__ import annotations

import math

import torch

from . import Optimizer


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown or shrunk by the
    agreement of the gradient's sign with the last step's."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_slots(self, p):
        return {"prev_grad": torch.zeros_like(p),
                "step_size": torch.full_like(p, float(self.get_lr()))}

    def _apply(self, p, g, slots, lr, t, wd):
        eta_neg, eta_pos = self._etas
        lo, hi = self._lr_range
        sign = torch.sign(g * slots["prev_grad"])
        factor = torch.where(sign > 0, eta_pos,
                             torch.where(sign < 0, eta_neg, 1.0))
        step = torch.clip(slots["step_size"] * factor, lo, hi)
        # on a sign change the gradient counts as zero this step (Rprop-)
        g_eff = torch.where(sign < 0, 0.0, g)
        p = p - torch.sign(g_eff) * step
        return p, {**slots, "prev_grad": g_eff, "step_size": step}


class ASGD(Optimizer):
    """SGD over the mean of the last ``batch_num`` gradients (a circular
    buffer of ``batch_num`` entries)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = max(int(batch_num), 1)

    def _init_slots(self, p):
        return {"grad_sum": torch.zeros_like(p),
                "buffer": p.new_zeros((self._n,) + tuple(p.shape))}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        idx = (t - 1) % self._n
        buf = slots["buffer"].clone()
        gsum = slots["grad_sum"] - buf[idx] + g
        buf[idx] = g
        p = p - lr * gsum / min(t, self._n)
        return p, {**slots, "grad_sum": gsum, "buffer": buf}


class NAdam(Optimizer):
    """Adam with Nesterov momentum (Dozat 2016's momentum-decay
    schedule)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._psi = momentum_decay

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "mu_prod": torch.ones((), dtype=torch.float32,
                                      device=p.device)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        b1, b2 = self._beta1, self._beta2
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_next = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = slots["mu_prod"] * mu_t
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g * g
        mhat = (mu_next * m / (1 - mu_prod * mu_next)
                + (1 - mu_t) * g / (1 - mu_prod))
        vhat = v / (1 - b2 ** t)
        p = p - lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        return p, {**slots, "moment1": m, "moment2": v, "mu_prod": mu_prod}


class RAdam(Optimizer):
    """Rectified Adam (Liu 2020): the variance-rectification term, and
    SGD with momentum while the rectifier is undefined."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _apply(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * (b2 ** t) / (1 - b2 ** t)
        if rho_t > 5.0:
            vhat = torch.sqrt(v / (1 - b2 ** t))
            r = math.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
            p = p - lr * r * mhat / (vhat + self._epsilon)
        else:
            p = p - lr * mhat
        return p, {**slots, "moment1": m, "moment2": v}


class LBFGS(Optimizer):
    """Limited-memory BFGS with a closure-based ``step``: the two-loop
    recursion over a bounded (s, y) history, and an optional strong-Wolfe
    line search (``line_search_fn="strong_wolfe"``). The closure clears
    the grads, runs the forward and the backward, and returns the loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise ValueError(
                "LBFGS: grad_clip is incompatible with the closure-based "
                "line search (clipping would break the Wolfe conditions)")
        super().__init__(learning_rate, parameters, weight_decay, None,
                         name, False)
        self._wd = self._wd_coeff()
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []

    # -- flat vectors ---------------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list
                if getattr(p, "trainable", p.requires_grad)]

    def _gather_flat_grad(self):
        # a parameter outside the closure's loss has no grad: zeros
        flat = torch.cat([
            p.grad.reshape(-1) if p.grad is not None
            else torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            for p in self._params()])
        if self._wd:
            flat = flat + self._wd * self._flat_params()
        return flat

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1) for p in self._params()])

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _direction(self, flat_grad):
        """The two-loop recursion: -H g over the stored (s, y) pairs."""
        q = flat_grad
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y)
                     / torch.clamp(torch.dot(y, y), min=1e-10))
        for (a, rho), (s, y) in zip(reversed(alphas),
                                    zip(self._s, self._y)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def _eval(self, closure, flat):
        """The parameters set to ``flat``, then the closure: (loss, flat
        grad)."""
        self._set_flat_params(flat)
        with torch.enable_grad():
            loss = closure()
        return float(loss), self._gather_flat_grad()

    @torch.no_grad()
    def step(self, closure):
        """Up to ``max_iter`` L-BFGS iterations; returns the last loss as
        an fp32 scalar tensor."""
        loss, flat_grad = self._eval(closure, self._flat_params())
        evals = 1
        for _ in range(self.max_iter):
            if float(flat_grad.abs().max()) <= self.tol_grad:
                break
            d = self._direction(flat_grad)
            x0 = self._flat_params()
            g0_dot_d = float(torch.dot(flat_grad, d))
            if g0_dot_d > -1e-15:        # not a descent direction: reset
                self._s, self._y = [], []
                d = -flat_grad
                g0_dot_d = float(torch.dot(flat_grad, d))
            lr = float(self.get_lr())
            if self.line_search_fn == "strong_wolfe":
                c1, c2 = 1e-4, 0.9
                t = lr
                t_eval = None            # the step the parameters sit at
                for _ls in range(20):
                    new_loss, new_grad = self._eval(closure, x0 + t * d)
                    t_eval = t
                    evals += 1
                    slope = float(torch.dot(new_grad, d))
                    if new_loss > loss + c1 * t * g0_dot_d:
                        t *= 0.5         # Armijo failed: shrink
                    elif abs(slope) > c2 * abs(g0_dot_d):
                        t *= 2.0 if slope < 0 else 0.5
                    else:
                        break            # both Wolfe conditions hold
                    if evals >= self.max_eval:
                        break
                if t != t_eval:
                    # the loop proposed a step it did not evaluate
                    new_loss, new_grad = self._eval(closure, x0 + t * d)
                    t_eval = t
                    evals += 1
                t = t_eval
            else:
                t = lr
                new_loss, new_grad = self._eval(closure, x0 + t * d)
                evals += 1
            s = t * d
            y = new_grad - flat_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            if abs(new_loss - loss) < self.tol_change:
                loss, flat_grad = new_loss, new_grad
                break
            loss, flat_grad = new_loss, new_grad
            if evals >= self.max_eval:
                break
        return torch.tensor(loss, dtype=torch.float32)


__all__ = ["Rprop", "ASGD", "NAdam", "RAdam", "LBFGS"]
