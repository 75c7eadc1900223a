"""HybridParallelOptimizer (port of
``paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py``): the
data-parallel gradient exchange of the per-rank tiers, then the inner
optimizer's step.

``step`` consumes a live overlap round (buckets launched during backward
by its grad-ready callbacks) or runs the bucketed exchange itself, over
the hybrid group's dp group, then steps the inner optimizer (the port's
``AdamW`` runs fused under ``amp.decorate`` O2). When a ``DataParallel``
already exchanges these parameters (``fleet.distributed_model``), the
exchange is its: the reference averages the same pre-exchange gradients
twice, once in each, which gives the same result (ROADMAP C51); the
optimizer exchanges only what a backward under ``no_sync`` left behind.

Sharding stage 1 (``DygraphShardingOptimizer``) and the meta-optimizers
that own their exchange (DGC, LocalSGD) come with ROADMAP queue A item
8b.
"""
from __future__ import annotations

import weakref

from ...autograd import callbacks
from ..collective import ReduceOp
from ..parallel_env import get_world_size


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._hcg = hcg
        self._strategy = strategy
        self._comm_bucketer = None
        self._overlap_sched = None
        self._overlap_cb = None
        if strategy is not None and strategy.degrees().get("sharding", 1) > 1:
            raise NotImplementedError(
                "sharding stage 1 (DygraphShardingOptimizer) comes with "
                "ROADMAP queue A item 8b")
        self._inner_opt = optimizer
        self._maybe_install_overlap()

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _params(self):
        return [p for p in getattr(self._inner_opt, "_parameter_list", [])
                if p is not None and p.requires_grad]

    def _group(self):
        return None if self._hcg is None else \
            self._hcg.get_data_parallel_group()

    def _dp_exchange_applies(self):
        s = self._strategy
        return (s is not None and s.degrees().get("dp", 1) > 1
                and get_world_size() > 1)

    def _data_parallel(self):
        """The live ``DataParallel`` exchanging all these parameters, or
        None."""
        from ..parallel import _LIVE
        params = self._params()
        return next((dp for dp in list(_LIVE) if dp.covers(params)), None)

    # -- overlap -----------------------------------------------------------------
    def _maybe_install_overlap(self):
        """A grad-ready callback on the parameters, so that each bucket's
        dp collective launches during backward; ``step`` then waits."""
        if not getattr(self._strategy, "comm_overlap", True) or \
                not self._dp_exchange_applies():
            return
        ref = weakref.ref(self)

        def _ready(t):
            opt = ref()
            if opt is not None:
                opt._on_grad_ready(t)

        self._overlap_cb = callbacks.register_grad_ready_callback(
            _ready, self._params())

    def _on_grad_ready(self, t):
        if self._data_parallel() is not None:
            return
        sched = self._overlap_sched
        if sched is None:
            from ..comm import GradientBucketer, ReadyBucketScheduler
            sched = self._overlap_sched = ReadyBucketScheduler(
                GradientBucketer.from_strategy(self._params(),
                                               self._strategy),
                name="hpo", group=self._group(), op=ReduceOp.AVG)
        sched.mark_ready(t)

    def _consume_overlap(self):
        """True when a live overlap round covered the exchange."""
        sched = self._overlap_sched
        if sched is None:
            return False
        if not sched.matches(self._params()):
            sched.close()
            self._overlap_sched = None
            return False
        return sched.finish()

    # -- the exchange ------------------------------------------------------------
    def _maybe_sync_dp_grads(self):
        if not self._dp_exchange_applies():
            return
        params = self._params()
        if not params:
            return
        from ..comm import GradientBucketer
        b = self._comm_bucketer
        if b is None or [id(p) for p in b._params] != [id(p) for p in params]:
            b = self._comm_bucketer = GradientBucketer.from_strategy(
                params, self._strategy)
        b.sync_grads(group=self._group(), op=ReduceOp.AVG)

    def step(self):
        dp = self._data_parallel() if self._dp_exchange_applies() else None
        if dp is None or not dp.grads_in_sync():
            if not self._consume_overlap():
                self._maybe_sync_dp_grads()
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self._inner_opt.clear_grad()
        return None, None

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad
