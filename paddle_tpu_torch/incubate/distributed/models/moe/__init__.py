"""Mixture of experts (port of
``paddle_tpu/incubate/distributed/models/moe/__init__.py``; Paddle's
``incubate.distributed.models.moe``): ``MoELayer`` with the ``NaiveGate``,
``GShardGate`` and ``SwitchGate`` routers, and the GShard dispatch that
``models/mixtral.py`` shares.

Dispatch is the GShard einsum form, static in shape: the router's top-k
choices become one-hot dispatch and combine tensors ``[tokens, experts,
capacity]``, tokens are gathered into ``[experts, capacity, d]`` batches
by one einsum, the experts run as stacked-weight products (``ExpertFFN``:
one batched einsum a projection), and a second einsum combines their
outputs. The capacity ``C = ceil(tokens * capacity_factor * top_k /
experts)`` comes from the shape alone. A token's place in its expert's
queue is its rank by choice, then by token; a choice at place ``C`` or
later is dropped (combine weight 0), and the kept weights are the
router's probabilities normalised over the token's top-k. Nothing reads a
value back to the host (no ``.item()``, no ``nonzero``), so a CUDA graph
captures the layer.

Ties in the router go to the lower expert index, as ``jax.lax.top_k``
breaks them (a stable descending sort). The port has no device mesh yet:
:func:`ep_axis_for` returns None, as the reference does with no mesh
installed, and the expert batches stay on the one device."""
from __future__ import annotations

import math

import torch

from ..... import amp
from .....amp import sites
from .....nn.initializer import XavierUniform
from .....nn.layer import Layer, LayerList

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate", "ExpertFFN",
           "plan_dispatch", "dispatch_combine", "ep_axis_for",
           "moe_capacity"]


def ep_axis_for(num_experts, ep_axis="dp"):
    """The mesh axis to shard the expert dim over, or None. The reference
    needs an installed mesh whose ``ep_axis`` is larger than 1 and
    divides ``num_experts``; the port has no mesh, so this is None."""
    return None


def moe_capacity(n_tokens, num_experts, top_k, capacity_factor):
    """The static capacity an expert ``C = ceil(S cf k / E)``, at least 1."""
    return max(1, math.ceil(n_tokens * capacity_factor * top_k
                            / num_experts))


def _one_hot(idx, n):
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros, as ``jax.nn.one_hot``'s does. A
    comparison, not ``F.one_hot``, whose range check reads the device."""
    return (idx.unsqueeze(-1)
            == torch.arange(n, device=idx.device)).to(torch.float32)


def _softmax(x):
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def top_k_indices(probs, k):
    """The ``k`` largest of each row, largest first, ties to the lower
    index (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def plan_dispatch(logits, capacity, top_k):
    """The GShard dispatch plan of router ``logits [S, E]``: ``(probs [S,
    E], dispatch [S, E, C], combine [S, E, C])``, all fp32. The softmax is
    taken in fp32; each (choice, token) takes its place in its expert's
    queue in the order choice rank, then token; places from ``capacity``
    on are dropped."""
    probs = _softmax(logits.float())
    return (probs,) + _plan_from_probs(probs, capacity, top_k)


def _plan_from_probs(probs, capacity, top_k):
    """``(dispatch, combine)`` of the router's ``probs [S, E]``."""
    s, e = probs.shape
    choice = _one_hot(top_k_indices(probs, top_k).T, e)      # [k, S, E]
    flat = choice.reshape(-1, e)                             # [k S, E]
    pos = torch.cumsum(flat, dim=0) - flat                   # queue rank
    pos = (pos * flat).sum(-1)                               # [k S]
    keep = (pos < capacity) & (flat.sum(-1) > 0)
    pos_oh = _one_hot(torch.where(keep, pos.to(torch.int64), capacity),
                      capacity)                              # [k S, C]
    disp = (flat[:, :, None] * pos_oh[:, None, :]).reshape(
        top_k, s, e, capacity).sum(0)
    gate_w = (choice * probs[None]).sum(-1)                  # [k, S]
    # each token's weight on each chosen expert (the top-k are distinct,
    # so the sum over k is exact), normalised over its top-k
    w = torch.einsum("ks,kse->se", gate_w, choice)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return disp, disp * w[:, :, None]


def einsum(eq, *ts):
    """``torch.einsum`` with jnp's promotion of mixed float dtypes."""
    return torch.einsum(eq, *amp.promote(*ts))


def dispatch_combine(tok, logits, capacity, top_k, expert_fn, ep_axis=None,
                     tracer_ref=None):
    """The MoE data path around :func:`plan_dispatch`: tokens ``[S, d]``
    -> expert batches ``[E, C, d]`` -> ``expert_fn`` -> the combined
    output ``[S, d]``. Returns ``(out, probs, dispatched_frac [E])``, from
    which a caller derives its aux loss. ``ep_axis`` and ``tracer_ref``
    are the reference's sharding hints; the port has no mesh to use them
    on."""
    probs, disp, combine = plan_dispatch(logits, capacity, top_k)
    expert_out = expert_fn(einsum("sec,sd->ecd", disp, tok))
    out = einsum("sec,ecd->sd", combine, expert_out)
    return out, probs, disp.sum(-1).mean(0)


def _balance_loss(weight, e, probs, frac):
    """``weight E sum_e mean(P_e) frac_e``, GShard's load-balance loss."""
    return weight * e * (probs.mean(0) * frac).sum()


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

class BaseGate(Layer):
    def __init__(self, d_model, num_experts, top_k):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.weight = self.create_parameter(
            [d_model, num_experts], default_initializer=XavierUniform())
        self.loss = None          # the aux loss of the last forward

    def gate_logits(self, x):
        """``x @ weight``, the op ``"matmul"``."""
        x, w = amp.promote(*amp.amp_cast_inputs("matmul", [x, self.weight]))
        return torch.matmul(x, w)


class NaiveGate(BaseGate):
    """Top-k softmax gate, no aux loss."""

    def __init__(self, d_model, num_expert=None, world_size=None, top_k=2,
                 num_experts=None, **kw):
        e = num_experts if num_experts is not None else (
            (num_expert or 1) * (world_size or 1))
        super().__init__(d_model, e, top_k)

    def aux_loss(self, probs, dispatch_frac):
        return None


class GShardGate(NaiveGate):
    """Top-2 gate with GShard's load-balance aux loss ``E sum_e mean(P_e)
    frac_e`` times ``balance_loss_weight``."""

    def __init__(self, d_model, num_expert=None, world_size=None, top_k=2,
                 balance_loss_weight=1.0, **kw):
        super().__init__(d_model, num_expert, world_size, top_k, **kw)
        self.balance_loss_weight = balance_loss_weight

    def aux_loss(self, probs, dispatch_frac):
        return _balance_loss(self.balance_loss_weight, self.num_experts,
                             probs, dispatch_frac)


class SwitchGate(GShardGate):
    """Top-1 switch-transformer gate (the same aux loss)."""

    def __init__(self, d_model, num_expert=None, world_size=None, top_k=1,
                 **kw):
        super().__init__(d_model, num_expert, world_size, top_k=1, **kw)


GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------

class ExpertFFN(Layer):
    """Every expert's FFN as stacked weights ``w1 [E, d, dh]``, ``w2 [E,
    dh, d]`` (biases ``[E, 1, dh]``, ``[E, 1, d]``): one batched einsum a
    projection."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu"):
        super().__init__()
        self.num_experts = num_experts
        self.w1 = self.create_parameter([num_experts, d_model, d_hidden],
                                        default_initializer=XavierUniform())
        self.b1 = self.create_parameter([num_experts, 1, d_hidden],
                                        is_bias=True)
        self.w2 = self.create_parameter([num_experts, d_hidden, d_model],
                                        default_initializer=XavierUniform())
        self.b2 = self.create_parameter([num_experts, 1, d_model],
                                        is_bias=True)
        self.activation = activation

    def forward_arrays(self, x, w1, b1, w2, b2):
        """``x [E, C, d]`` through the experts on the given (already
        cast) weights; GeLU is ``jax.nn.gelu``'s default, the tanh
        approximation."""
        h = torch.add(*amp.promote(einsum("ecd,edh->ech", x, w1), b1))
        h = (torch.nn.functional.gelu(h, approximate="tanh")
             if self.activation == "gelu" else torch.relu(h))
        return torch.add(*amp.promote(einsum("ech,ehd->ecd", h, w2), b2))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

class MoELayer(Layer):
    """``paddle.incubate.distributed.models.moe.MoELayer``.

    ``d_model``; ``experts``, a list of per-expert layers run one by one,
    or None for the stacked :class:`ExpertFFN` of ``num_experts`` and
    ``d_hidden``; ``gate``, a name (``"naive"``, ``"gshard"``,
    ``"switch"``), a dict with ``"type"`` and ``"top_k"``, or a gate
    layer; ``top_k``; ``capacity_factor``; ``ep_axis``, kept for the
    reference's signature. ``forward`` returns the combined output; the
    gate's aux loss (0 for ``"naive"``) is then ``self.aux_loss``, to be
    added to the training loss."""

    def __init__(self, d_model=None, experts=None, gate="gshard", top_k=2,
                 capacity_factor=1.25, num_experts=None, d_hidden=None,
                 ep_axis="dp", moe_group=None, mp_group=None, **kw):
        super().__init__()
        if isinstance(gate, dict):
            top_k = gate.get("top_k", top_k)
            gate = gate.get("type", "gshard")
        self.d_model = d_model
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        if experts is not None:
            self.experts = (experts if isinstance(experts, LayerList)
                            else LayerList(list(experts)))
            self.num_experts = len(self.experts)
            self.fused = None
        else:
            if not (num_experts and d_hidden):
                raise ValueError("the stacked MoE needs num_experts and "
                                 "d_hidden")
            self.num_experts = num_experts
            self.fused = ExpertFFN(num_experts, d_model, d_hidden)
            self.experts = None
        if isinstance(gate, str):
            self.gate = GATES[gate](d_model, num_experts=self.num_experts,
                                    top_k=top_k)
        else:
            self.gate = gate
        self.aux_loss = None

    def _plan(self, logits, capacity):
        return plan_dispatch(logits, capacity, self.top_k)

    def _aux(self, probs, frac):
        aux = self.gate.aux_loss(probs, frac)
        return aux if aux is not None else torch.zeros((), device=probs.device)

    def forward(self, x):
        shape = x.shape
        d = shape[-1]
        s = math.prod(shape[:-1])
        capacity = moe_capacity(s, self.num_experts, self.top_k,
                                self.capacity_factor)
        if self.fused is not None:
            f = self.fused
            xa, gw, w1, b1, w2, b2 = amp.amp_cast_inputs(
                "moe", [x, self.gate.weight, f.w1, f.b1, f.w2, f.b2])
            tok = xa.reshape(s, d)
            out, probs, frac = dispatch_combine(
                tok, tok.float() @ gw.float(), capacity, self.top_k,
                lambda ein: f.forward_arrays(ein, w1, b1, w2, b2))
            aux = self._aux(probs, frac)
            out = out.reshape(shape).to(xa.dtype)
        else:
            # per-expert layers, one after another
            xa, gw = amp.amp_cast_inputs("moe_dispatch",
                                         [x, self.gate.weight])
            tok = xa.reshape(s, d)
            probs, disp, combine = self._plan(tok.float() @ gw.float(),
                                              capacity)
            expert_in = einsum("sec,sd->ecd", disp, tok)
            aux = self._aux(probs, disp.sum(-1).mean(0))
            outs = [exp(sites.getitem(expert_in, i))
                    for i, exp in enumerate(self.experts)]
            expert_out = torch.stack(
                amp.promote(*amp.amp_cast_inputs("stack", outs)), dim=0)
            c, eo, xa = amp.amp_cast_inputs("moe_combine",
                                            [combine, expert_out, x])
            out = einsum("sec,ecd->sd", c, eo).reshape(shape).to(xa.dtype)
        self.aux_loss = aux
        self.gate.loss = aux
        return out
