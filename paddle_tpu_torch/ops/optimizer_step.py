"""The fused optimizer step's kernels (``csrc/optimizer_step.cu``).

K-A, :func:`adam_step_multi_tensor`, updates a whole group of parameters
with Adam or AdamW in one launch, in the order and with the roundings of
the port's eager loop (``optimizer.Adam._apply`` through
``_masterized_apply``): bf16 and fp16 parameters through their fp32 master
weights, fp32 parameters in place, fp32 moments. The global-norm clip's
scale, when given, is folded in: a clipped grad is ``(g.float() *
scale).to(g.dtype)``, as ``nn.ClipGradByGlobalNorm`` casts it back.
K-B, :func:`sum_squares_multi_tensor`, is that clip's fp32 sum of
squares over a list of grads, in two launches with no atomics.

Neither replaces a Pallas kernel: the reference's fused step is one XLA
program per parameter group (``paddle_tpu/optimizer/fused.py:65``). A
CUDA tensor goes to the kernels or raises; a CPU tensor runs the plain
versions beside them (:func:`adam_step_multi_tensor_plain`,
:func:`sum_squares_multi_tensor_plain`), which are the eager loop's ops.
A tensor that is not contiguous or not 16-byte aligned raises on CUDA;
it is never copied.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

#: elements a chunk: the unit of work of a block, a multiple of VEC
CHUNK = 16384
#: elements a thread loads a step (16 bytes of bf16)
VEC = 8
#: K-A's flags (``csrc/optimizer_step.cu``)
DECOUPLED, DECAY = 1, 2
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def chunk_table(numels, chunk=CHUNK):
    """Prefix sums of the tensors' chunk counts, ``[0, c0, c0 + c1, ...]``.
    Chunk ``c`` belongs to the tensor ``i`` with ``cs[i] <= c < cs[i + 1]``
    and covers its elements ``[(c - cs[i]) * chunk, min((c - cs[i] + 1) *
    chunk, numel))``."""
    out = [0]
    for n in numels:
        out.append(out[-1] + -(-int(n) // chunk))
    return out


def _kernel_operands(name, tensors, device):
    """Every CUDA operand must lie on ``device``, be contiguous and start on
    a 16-byte boundary: the kernels load 16 bytes a thread."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned for the fused optimizer kernels")


@dataclass(frozen=True)
class AdamHyper:
    """One step's hyperparameters for a group: ``lr`` (the group's rate),
    betas, ``eps``, ``weight_decay`` (coupled into the grad for Adam,
    decoupled for AdamW) and the step ``t`` its bias corrections use."""
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    step: int
    decoupled: bool

    def kernel_args(self):
        """K-A's by-value arguments as the eager loop's Python floats reach
        PyTorch's CUDA kernels: each cast to fp32 once after it is formed
        in double, and a division by a Python number a product with the
        number's reciprocal, taken in double and cast to fp32 (``1 / (1 -
        b^t)``; an fp32 reciprocal differs in the last bit now and then,
        as the card showed)."""
        f = np.float32
        bc1 = 1 - self.beta1 ** self.step
        bc2 = 1 - self.beta2 ** self.step
        values = (self.lr, self.beta1, 1 - self.beta1, self.beta2,
                  1 - self.beta2, 1.0 / bc1, 1.0 / bc2, self.eps,
                  self.weight_decay, 1 - self.lr * self.weight_decay)
        flags = ((DECOUPLED if self.decoupled else 0)
                 | (DECAY if self.weight_decay else 0))
        return [ctypes.c_float(float(f(v))) for v in values] + [
            ctypes.c_int(flags)]


class AdamGroup:
    """The tensors one K-A launch updates in place: parameters of one
    dtype, their fp32 masters (bf16 and fp16 parameters) or None (fp32
    parameters), fp32 moments, and each one's need-clip flag. On CUDA it
    holds the launch's device table (pointers, element counts, flags,
    chunk prefix sums). The tensors are updated in place, so the table
    stays valid until one of them is replaced: ``signature`` differs from
    :meth:`signature_of` the group's tensors then."""

    def __init__(self, params, masters, moment1s, moment2s, need_clip,
                 chunk=CHUNK):
        self.params, self.masters = list(params), list(masters)
        self.moment1s, self.moment2s = list(moment1s), list(moment2s)
        self.need_clip = [bool(c) for c in need_clip]
        self.chunk = chunk
        self.device = self.params[0].device
        self.dtype = self.params[0].dtype
        for p, master, m, v in zip(self.params, self.masters, self.moment1s,
                                   self.moment2s):
            want_master = self.dtype in _LOW_PRECISION
            if p.dtype != self.dtype or (master is not None) != want_master:
                raise ValueError("a K-A group holds parameters of one dtype: "
                                 "fp32 without a master, or bf16/fp16 with "
                                 "an fp32 master")
            for t in (m, v) + ((master,) if master is not None else ()):
                if t.dtype != torch.float32 or t.shape != p.shape:
                    raise ValueError("masters and moments are fp32 and "
                                     "shaped like their parameter")
        self.signature = self.signature_of(self.params, self.masters,
                                           self.moment1s, self.moment2s,
                                           self.need_clip)
        self.numels = [p.numel() for p in self.params]
        self.chunks = chunk_table(self.numels, chunk)
        self.table = None
        if self.device.type == "cuda":
            _kernel_operands("a K-A operand", [
                t for group in (self.params, self.masters, self.moment1s,
                                self.moment2s)
                for t in group if t is not None], self.device)
            rows = []
            for p, master, m, v, n, clip in zip(
                    self.params, self.masters, self.moment1s, self.moment2s,
                    self.numels, self.need_clip):
                rows += [p.data_ptr(), 0 if master is None
                         else master.data_ptr(), m.data_ptr(), v.data_ptr(),
                         n, int(clip)]
            self.table = torch.tensor(rows + self.chunks,
                                      dtype=torch.int64).to(self.device)

    @staticmethod
    def signature_of(params, masters, moment1s, moment2s, need_clip):
        """What a group's table depends on: every tensor's identity and
        address, and the flags."""
        return tuple((p.data_ptr(), id(p), None if a is None
                      else a.data_ptr(), m.data_ptr(), v.data_ptr(),
                      bool(c))
                     for p, a, m, v, c in zip(params, masters, moment1s,
                                              moment2s, need_clip))


def clip_scaled(g, scale):
    """The global-norm clip's cast back: ``g`` times the fp32 ``scale``,
    rounded to ``g``'s dtype."""
    return (g.float() * scale).to(g.dtype)


def adam_update_plain(w, g, m, v, hp):
    """``Adam._apply`` on one tensor, in place: ``w`` (the fp32 master or
    the fp32 parameter), its fp32 grad ``g``, and the moments."""
    lr, wd = hp.lr, hp.weight_decay
    if wd and not hp.decoupled:
        g = g + wd * w
    m.mul_(hp.beta1).add_((1 - hp.beta1) * g)
    v.mul_(hp.beta2).add_((1 - hp.beta2) * g * g)
    mhat = m / (1 - hp.beta1 ** hp.step)
    vhat = v / (1 - hp.beta2 ** hp.step)
    if wd and hp.decoupled:
        w.mul_(1 - lr * wd)
    w.sub_(mhat.mul_(lr).div_(vhat.sqrt_().add_(hp.eps)))


@torch.no_grad()
def adam_step_multi_tensor_plain(group, grads, hp, scale=None):
    """K-A's plain version: the eager loop's ops, tensor by tensor, the
    clip's cast back first where ``scale`` is given and the tensor is
    clipped, then the update on the master (``p`` receives it rounded) or
    on the fp32 parameter."""
    for p, master, m, v, clip, g in zip(group.params, group.masters,
                                        group.moment1s, group.moment2s,
                                        group.need_clip, grads):
        if scale is not None and clip:
            g = clip_scaled(g, scale)
        if master is None:
            adam_update_plain(p.detach(), g, m, v, hp)
        else:
            adam_update_plain(master, g.float(), m, v, hp)
            p.copy_(master)


def adam_step_multi_tensor(group, grads, hp, scale=None):
    """K-A: one Adam/AdamW step of every tensor of ``group``
    (:class:`AdamGroup`) with ``grads`` (one a parameter, of its dtype and
    shape) and the hyperparameters ``hp`` (:class:`AdamHyper`), the
    global-norm clip's fp32 ``scale`` (a 0-dim tensor) folded in where
    given. A CPU group runs :func:`adam_step_multi_tensor_plain`. CUDA
    launches are counted in ``adam_step_multi_tensor.launches``."""
    if len(grads) != len(group.params):
        raise ValueError(f"{len(grads)} grads for {len(group.params)} "
                         f"parameters")
    for p, g in zip(group.params, grads):
        if g.dtype != p.dtype or g.shape != p.shape:
            raise ValueError(f"a grad {g.dtype} {tuple(g.shape)} for a "
                             f"parameter {p.dtype} {tuple(p.shape)}")
    dev = group.device
    if dev.type == "cpu":
        return adam_step_multi_tensor_plain(group, grads, hp, scale)
    if dev.type != "cuda":
        raise ValueError(f"no fused optimizer step for device {dev}")
    _kernel_operands("a grad", grads, dev)
    if scale is not None and (scale.device != dev
                              or scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise ValueError("the clip's scale is one fp32 value on the "
                         "group's device")
    gptr = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64,
                        pin_memory=True).to(dev, non_blocking=True)
    _build.launch("ptt_adam_step", dev, [
        ctypes.c_int(_build.dtype_code(group.dtype)),
        ctypes.c_void_p(group.table.data_ptr()),
        ctypes.c_void_p(gptr.data_ptr()), ctypes.c_int(len(grads)),
        ctypes.c_longlong(group.chunks[-1]), ctypes.c_longlong(group.chunk),
        ctypes.c_void_p(None if scale is None else scale.data_ptr()),
        *hp.kernel_args()], ((adam_step_multi_tensor, "launches"),))


adam_step_multi_tensor.launches = 0


def sum_squares_multi_tensor_plain(grads):
    """K-B's plain version: ``g.float().square().sum()`` for each grad,
    added in order (``ClipGradByGlobalNorm``'s sum)."""
    total = None
    for g in grads:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return total


def sum_squares_multi_tensor(grads):
    """K-B: the fp32 sum of the squares of every element of ``grads``
    (fp32, bf16 or fp16, in any mix), as a 0-dim fp32 tensor on their
    device. A CPU list runs :func:`sum_squares_multi_tensor_plain`. On
    CUDA: one fp32 partial a chunk, then the partials by tensor and the
    tensors in order (two launches, each counted in
    ``sum_squares_multi_tensor.launches``); two runs give the same
    bits."""
    if not grads:
        raise ValueError("no grads to sum")
    dev = grads[0].device
    if dev.type == "cpu":
        return sum_squares_multi_tensor_plain(grads)
    if dev.type != "cuda":
        raise ValueError(f"no sum of squares kernel for device {dev}")
    _kernel_operands("a grad", grads, dev)
    numels = [g.numel() for g in grads]
    chunks = chunk_table(numels)
    rows = []
    for g, n in zip(grads, numels):
        rows += [g.data_ptr(), n, _build.dtype_code(g.dtype)]
    tab = torch.tensor(rows + chunks, dtype=torch.int64,
                       pin_memory=True).to(dev, non_blocking=True)
    partial = torch.empty(max(chunks[-1], 1), dtype=torch.float32,
                          device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    counters = ((sum_squares_multi_tensor, "launches"),)
    _build.launch("ptt_sum_squares_partial", dev, [
        ctypes.c_void_p(tab.data_ptr()), ctypes.c_int(len(grads)),
        ctypes.c_longlong(chunks[-1]), ctypes.c_longlong(CHUNK),
        ctypes.c_void_p(partial.data_ptr())], counters)
    _build.launch("ptt_sum_squares_finish", dev, [
        ctypes.c_void_p(tab.data_ptr()), ctypes.c_int(len(grads)),
        ctypes.c_void_p(partial.data_ptr()),
        ctypes.c_void_p(out.data_ptr())], counters)
    return out


sum_squares_multi_tensor.launches = 0
