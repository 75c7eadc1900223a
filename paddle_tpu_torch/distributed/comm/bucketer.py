"""Fusion buckets for the gradient exchange (port of
``paddle_tpu/distributed/comm/bucketer.py``): :class:`GradientBucketer`
and the ready-bucket overlap scheduler :class:`ReadyBucketScheduler`.

Layout contract: buckets are built from the parameter list's order,
shapes and dtypes only, never from gradient values or presence, so every
rank derives the same layout and the per-bucket collectives pair
(``signature()`` is the witness, equal to the reference's). Buckets are
dtype-homogeneous; a bucket closes when the next parameter of its dtype
would take it past ``fuse_grad_size_in_MB`` (0: one bucket a parameter).
With int8 quantization every parameter starts a fresh quantization block,
so no block's scale spans two tensors. Each parameter owns
``[offset, offset + numel)`` of its bucket's flat buffer.

A bucket's exchange copies its gradients into one flat buffer on their
device and all-reduces it: dense in the bucket's dtype (AVG is the sum
over the group divided by its size), or through the quantized wire of
``collectives.py`` in fp32. The scheduler launches the same exchange
asynchronously the moment a bucket's last gradient is final in backward,
so overlap on and off give the same bits.
"""
from __future__ import annotations

import torch

from .. import collective as _collective
from .collectives import PASSTHROUGH, start_allreduce_array
from .quantization import DEFAULT_BLOCK_SIZE
from .stats import get_comm_stats


def dtype_name(dtype):
    """``"float32"`` for ``torch.float32``: the reference's numpy name."""
    return str(dtype).replace("torch.", "")


class _Bucket:
    __slots__ = ("dtype", "items", "numel")

    def __init__(self, dtype):
        self.dtype = dtype
        self.items = []   # (param_index, offset, numel, shape)
        self.numel = 0


class _DenseWork:
    """A dense bucket's all-reduce in flight; ``wait()`` returns the
    reduced flat buffer."""

    def __init__(self, flat, group, op):
        self._flat = flat
        self._task = _collective.all_reduce(flat, op=op, group=group,
                                            sync_op=False)

    def wait(self, timeout=None):
        self._task.wait(timeout)
        return self._flat


class GradientBucketer:
    def __init__(self, parameters, fuse_grad_size_in_MB=32, quantization=None,
                 block_size: int = DEFAULT_BLOCK_SIZE, error_feedback=False):
        self._params = [p for p in parameters if p is not None]
        self._fuse_bytes = max(0.0, float(fuse_grad_size_in_MB)) * 2 ** 20
        self.quantization = (None if quantization in PASSTHROUGH
                             else quantization)
        self.block_size = int(block_size)
        self.error_feedback = bool(error_feedback)
        self._residuals = {}    # bucket index -> fp32 residual
        self._buckets = self._build()

    @classmethod
    def from_strategy(cls, parameters, strategy):
        """Built with a ``DistributedStrategy``'s comm options."""
        cfg = dict(getattr(strategy, "comm_configs", {}) or {})
        return cls(parameters,
                   fuse_grad_size_in_MB=getattr(strategy,
                                                "fuse_grad_size_in_MB", 32),
                   quantization=getattr(strategy, "comm_quantization", None),
                   block_size=cfg.get("block_size", DEFAULT_BLOCK_SIZE),
                   error_feedback=cfg.get("error_feedback", False))

    # -- layout --------------------------------------------------------------
    def _build(self):
        align = self.block_size if self.quantization == "int8" else 1
        buckets, open_by_dtype = [], {}
        for i, p in enumerate(self._params):
            dt, numel = p.dtype, p.numel()
            b = open_by_dtype.get(dt)
            if (b is None or (b.numel and (b.numel + numel) * dt.itemsize
                              > self._fuse_bytes)):
                b = _Bucket(dt)
                buckets.append(b)
                open_by_dtype[dt] = b
            b.items.append((i, b.numel, numel, tuple(p.shape)))
            b.numel += -(-numel // align) * align
        return buckets

    @property
    def buckets(self):
        return list(self._buckets)

    @property
    def num_buckets(self):
        return len(self._buckets)

    def signature(self):
        """Hashable layout: equal across ranks by construction."""
        return tuple((dtype_name(b.dtype),
                      tuple((it[0], it[1], it[2]) for it in b.items))
                     for b in self._buckets)

    # -- exchange ------------------------------------------------------------
    def _flatten(self, bucket, arrays):
        """The bucket's flat buffer (a copy, on its parameters' device):
        the given tensors at their offsets, zeros elsewhere."""
        device = self._params[bucket.items[0][0]].device
        flat = torch.zeros(bucket.numel, dtype=bucket.dtype, device=device)
        for (i, off, numel, _shape) in bucket.items:
            a = arrays[i]
            if a is not None:
                flat[off:off + numel].copy_(a.reshape(-1))
        return flat

    def _quantizable(self, bucket):
        return self.quantization is not None and bucket.dtype.is_floating_point

    def _residual(self, key, bucket):
        if not self.error_feedback:
            return None
        r = self._residuals.get(key)
        if r is None or r.numel() != bucket.numel:
            r = self._residuals[key] = torch.zeros(
                bucket.numel, dtype=torch.float32,
                device=self._params[bucket.items[0][0]].device)
        return r

    def launch_bucket(self, bi, arrays, group=None, op=None):
        """Start ONE bucket's collective; the handle's ``wait()`` returns
        the reduced flat vector. The unit the scheduler dispatches."""
        group = group or _collective._get_default_group()
        op = op if op is not None else _collective.ReduceOp.AVG
        bucket = self._buckets[bi]
        flat = self._flatten(bucket, arrays)
        if self._quantizable(bucket):
            return start_allreduce_array(
                flat, group=group, op=op, scheme=self.quantization,
                block_size=self.block_size,
                residual=self._residual(bi, bucket))
        return _DenseWork(flat, group, op)

    def exchange_bucket(self, bi, arrays, group=None, op=None):
        """Run ONE bucket's collective; returns the reduced flat vector."""
        return self.launch_bucket(bi, arrays, group, op).wait()

    def sync_arrays(self, arrays, group=None, op=None,
                    use_reduce_scatter=False):
        """Reduce ``arrays`` (aligned with the parameter list; ``None``
        contributes zeros) across ``group``, one collective a bucket;
        returns the reduced tensors (``None`` kept), views of the
        buckets."""
        if use_reduce_scatter:
            raise NotImplementedError(
                "the reduce-scatter wire pattern (sharding stage 2) comes "
                "with sharding, ROADMAP queue A item 8b")
        out = [None] * len(self._params)
        for bi, bucket in enumerate(self._buckets):
            red = self.exchange_bucket(bi, arrays, group=group, op=op)
            for (i, off, numel, shape) in bucket.items:
                if arrays[i] is not None:
                    out[i] = red[off:off + numel].view(shape)
        return out

    # -- parameter and gradient conveniences ---------------------------------
    @torch.no_grad()
    def sync_grads(self, group=None, op=None, use_reduce_scatter=False):
        """Exchange the parameters' gradients in place (the bucketed
        replacement of an ``all_reduce(p.grad)`` a tensor)."""
        grads = [getattr(p, "grad", None) for p in self._params]
        red = self.sync_arrays(grads, group=group, op=op,
                               use_reduce_scatter=use_reduce_scatter)
        for g, r in zip(grads, red):
            if r is not None:
                g.copy_(r)
        return self

    @torch.no_grad()
    def sync_params(self, group=None, op=None):
        """Reduce the parameter values themselves (LocalSGD's average)."""
        red = self.sync_arrays([p.detach() for p in self._params],
                               group=group, op=op)
        for p, r in zip(self._params, red):
            if r is not None:
                p.copy_(r)
        return self


class ReadyBucketScheduler:
    """Ready-bucket overlap over a :class:`GradientBucketer`.

    Fed by grad-ready callbacks (``autograd.register_grad_ready_callback``):
    the moment the last gradient of a bucket is final in backward, the
    bucket's (optionally quantized) collective is launched with
    ``async_op=True``; :meth:`finish` at the step boundary launches the
    buckets no gradient reached (read off the parameters), waits on every
    handle and writes the reduced gradients back. The same
    ``launch_bucket`` runs as on the barrier path, only earlier, so the
    bits are the same. At most ``inflight`` buckets are in flight; the
    oldest is waited on before another launches. ``timeout_s`` bounds
    each wait (the reference's ``PADDLE_COMM_OVERLAP_INFLIGHT`` and
    ``_TIMEOUT_S``). ``name`` tells concurrent schedulers apart in
    messages.
    """

    def __init__(self, bucketer, name="dp", group=None, op=None,
                 use_reduce_scatter=False, inflight=4, timeout_s=120):
        if use_reduce_scatter:
            raise NotImplementedError(
                "the reduce-scatter wire pattern (sharding stage 2) comes "
                "with sharding, ROADMAP queue A item 8b")
        self._b = bucketer
        self._name = name
        self._group = group
        self._op = op
        self._max_inflight = max(1, int(inflight))
        self._wait_timeout = timeout_s
        self._param_slot = {id(p): i for i, p in enumerate(bucketer._params)}
        self._bucket_of = {}
        for bi, bucket in enumerate(bucketer._buckets):
            for it in bucket.items:
                self._bucket_of[it[0]] = bi
        self._round = 0
        self._reset_round()

    def close(self):
        """Drop the round in flight without applying it (the scheduler
        holds no threads: its handles are torch's)."""
        self._reset_round()

    @property
    def bucketer(self):
        return self._b

    def matches(self, params):
        """True when ``params`` is the layout this scheduler was built
        over (the rebuild test its consumers run a step)."""
        return [id(p) for p in self._b._params] == [id(p) for p in params]

    def _reset_round(self):
        self._pending = {bi: {it[0] for it in b.items}
                         for bi, b in enumerate(self._b._buckets)}
        self._arrays = [None] * len(self._b._params)
        self._inflight = {}       # bucket -> handle, in launch order
        self._done = {}           # bucket -> reduced flat
        self._dispatched = set()

    # -- in backward -----------------------------------------------------------
    def mark_ready(self, t):
        """Grad-ready target: ignores tensors outside the parameter set;
        launches a bucket the moment its last parameter reports."""
        i = self._param_slot.get(id(t))
        if i is None:
            return
        bi = self._bucket_of[i]
        if bi in self._dispatched:
            # a second backward before the step boundary (accumulation
            # without no_sync): every rank drops the stale round at the
            # same parameter and exchanges the accumulated grads afresh
            self.discard()
        pend = self._pending[bi]
        pend.discard(i)
        if t.grad is not None:
            self._arrays[i] = t.grad
        if not pend:
            self._dispatch(bi, where="in_backward")

    def _dispatch(self, bi, where):
        if len(self._inflight) >= self._max_inflight:
            oldest = next(iter(self._inflight))
            self._done[oldest] = self._wait(oldest)
        get_comm_stats().record_bucket(where)
        with torch.no_grad():
            self._inflight[bi] = self._b.launch_bucket(
                bi, self._arrays, group=self._group, op=self._op)
        self._dispatched.add(bi)

    def _wait(self, bi):
        """The bucket's reduced flat vector, in the bucket's dtype (the
        write-back's one rounding, taken early: a waited bucket holds
        half the memory of its fp32 quantized result)."""
        handle = self._inflight.pop(bi)
        try:
            return handle.wait(self._wait_timeout).to(
                self._b._buckets[bi].dtype)
        except (RuntimeError, TimeoutError) as e:
            self._reset_round()
            raise TimeoutError(f"{e}\n{self._desync_diagnosis(bi)}") from e

    def _desync_diagnosis(self, bi):
        """Which buckets this rank launched in this round: a peer that
        skipped the step never launched the one it waits on."""
        launched = sorted(self._dispatched)
        missing = sorted(set(range(self._b.num_buckets)) - self._dispatched)
        return (f"gradient bucket {self._name}:b{bi} of round {self._round} "
                f"did not complete within {self._wait_timeout} s: this rank "
                f"launched buckets {launched}, not {missing}. A peer rank "
                f"that skipped this step never launched it; turn overlap off "
                f"(DistributedStrategy.comm_overlap = False) for uneven "
                f"steps")

    # -- step boundary ---------------------------------------------------------
    def finish(self):
        """Launch the leftovers, wait on every bucket, write the reduced
        gradients back onto ``p.grad``. True when any bucket was
        exchanged this round."""
        b = self._b
        for bi, bucket in enumerate(b._buckets):
            if bi in self._dispatched:
                continue
            # parameters whose hook never fired (unused this step, or
            # grads kept from an earlier backward): read off .grad
            got = False
            for it in bucket.items:
                i = it[0]
                if self._arrays[i] is None:
                    self._arrays[i] = getattr(b._params[i], "grad", None)
                got = got or self._arrays[i] is not None
            if got:
                self._dispatch(bi, where="at_barrier")
        exchanged = bool(self._inflight or self._done)
        try:
            for bi in list(self._inflight):
                self._done[bi] = self._wait(bi)
            with torch.no_grad():
                for bi in sorted(self._done):
                    self._apply_bucket(bi, self._done[bi])
        finally:
            self._round += 1
            self._reset_round()
        return exchanged

    def discard(self):
        """Drop the round without applying it (stale grads): waits out the
        launched buckets so the ranks' collectives stay paired."""
        for handle in self._inflight.values():
            try:
                handle.wait(self._wait_timeout)
            except (RuntimeError, TimeoutError):
                pass
        self._round += 1
        self._reset_round()

    def _apply_bucket(self, bi, red):
        bucket = self._b._buckets[bi]
        for (i, off, numel, shape) in bucket.items:
            g = getattr(self._b._params[i], "grad", None)
            if g is not None:
                g.copy_(red[off:off + numel].view(shape))
