"""DataParallel (port of ``paddle_tpu/distributed/parallel.py``: the
reference's per-rank mode, Paddle's reducer ``reducer.cc``): gradient
buckets exchanged over the data-parallel group during backward,
``no_sync`` for accumulation.

The reference's mesh mode (one controller, XLA inserting the reduction)
has no eager counterpart in torch; a dp-degree mesh is a world of dp
processes here (ROADMAP C51). Each rank runs its own backward; a
grad-ready callback on every trainable parameter feeds the ready-bucket
scheduler, which launches a bucket's average the moment its last
gradient is final, and a post-backward callback waits on the buckets
and writes the averaged gradients back before ``backward()`` returns.
With ``strategy.comm_overlap`` off the post-backward callback runs the
bucketed exchange at once instead. The buckets follow the strategy's
``fuse_grad_size_in_MB`` and ``comm_quantization`` (the fleet's, unless
one is given).

At world size 1 it exchanges nothing. Like the reference it does not
broadcast parameters at wrap: ranks start equal because they build from
the same seed or carry the same weights (``convert.load_jax_state``).
"""
from __future__ import annotations

import contextlib
import weakref

from ..autograd import callbacks
from ..nn.layer import Layer
from . import collective
from .parallel_env import get_world_size

#: live DataParallel wrappers, for HybridParallelOptimizer to find the
#: exchange that already covers its parameters
_LIVE = weakref.WeakSet()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._grad_sync_enabled = True
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        self._strategy = strategy
        self._overlap_scheduler = None
        self._comm_bucketer = None
        #: False once a backward under no_sync left unexchanged grads
        self._in_sync = True
        self._per_rank = get_world_size() > 1
        self._cb = self._ready_cb = None
        if not self._per_rank:
            return
        if self.group is None:
            self.group = collective._get_default_group()
        ref = weakref.ref(self)

        def _post():
            dp = ref()
            if dp is not None:
                dp._post_backward()

        def _ready(t):
            dp = ref()
            if dp is not None:
                dp._on_grad_ready(t)

        params = self._trainable()
        self._cb = callbacks.register_post_backward_callback(_post, params)
        self._ready_cb = callbacks.register_grad_ready_callback(_ready,
                                                                params)
        _LIVE.add(self)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _trainable(self):
        return [p for p in self._layers.parameters() if p.requires_grad]

    def _dp_strategy(self):
        if self._strategy is not None:
            return self._strategy
        from . import fleet
        return fleet.get_strategy()

    def covers(self, params):
        """True when this wrapper exchanges every one of ``params``."""
        mine = {id(p) for p in self._trainable()}
        return self._cb is not None and all(id(p) in mine for p in params)

    def grads_in_sync(self):
        """True when the last backward's gradients were exchanged (no
        backward under ``no_sync`` since)."""
        return self._in_sync

    # -- the reducer -----------------------------------------------------------
    def _on_grad_ready(self, t):
        """A gradient is final: route it into the ready-bucket scheduler
        (the reducer's per-variable hook)."""
        if not self._grad_sync_enabled:
            self._in_sync = False
            return
        sched = self._overlap_scheduler
        if sched is False:          # overlap off, latched once a model
            return
        if sched is None:
            strategy = self._dp_strategy()
            if not getattr(strategy, "comm_overlap", True):
                self._overlap_scheduler = False
                return
            from .comm import GradientBucketer, ReadyBucketScheduler
            sched = self._overlap_scheduler = ReadyBucketScheduler(
                GradientBucketer.from_strategy(self._trainable(), strategy),
                name="dp", group=self.group, op=collective.ReduceOp.AVG)
        sched.mark_ready(t)

    def _post_backward(self):
        """The reducer's flush: finish the overlap round when one is
        live, else exchange every bucket now."""
        if not self._grad_sync_enabled:
            return
        sched = self._overlap_scheduler
        if sched is not None and sched is not False:
            if sched.matches(self._trainable()):
                sched.finish()
                self._in_sync = True
                return
            # the parameter set changed under the scheduler: rebuild at
            # the next backward, exchange this one barrier-style
            sched.close()
            self._overlap_scheduler = None
        self._sync_gradients()

    def _sync_gradients(self):
        """The bucketed (and, per the strategy, quantized) exchange of
        every trainable parameter's gradient."""
        if not self._per_rank or not self._grad_sync_enabled:
            return
        params = self._trainable()
        if not any(p.grad is not None for p in params):
            return
        from .comm import GradientBucketer
        b = self._comm_bucketer
        if b is None or [id(p) for p in b._params] != [id(p) for p in params]:
            b = self._comm_bucketer = GradientBucketer.from_strategy(
                params, self._dp_strategy())
        b.sync_grads(group=self.group, op=collective.ReduceOp.AVG)
        self._in_sync = True

    def shutdown(self):
        """Retire the wrapper: its callbacks unregistered, its scheduler
        closed; it exchanges nothing after."""
        if self._cb is not None:
            callbacks.unregister_post_backward_callback(self._cb)
            self._cb = None
        if self._ready_cb is not None:
            callbacks.unregister_grad_ready_callback(self._ready_cb)
            self._ready_cb = None
        sched = self._overlap_scheduler
        if sched is not None and sched is not False:
            sched.close()
        self._overlap_scheduler = False
        self._grad_sync_enabled = False
        _LIVE.discard(self)

    @contextlib.contextmanager
    def no_sync(self):
        """No gradient exchange inside (gradient accumulation)."""
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev

    # -- delegation ------------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return self._layers.named_parameters(
            prefix=prefix, remove_duplicate=remove_duplicate,
            recurse=include_sublayers if recurse is None else recurse)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def train(self, mode=True):
        self._layers.train(mode)
        self.training = mode
        return self

    def eval(self):
        return self.train(False)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        self._sync_gradients()
