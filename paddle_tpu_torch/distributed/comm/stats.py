"""Communication counters (port of
``paddle_tpu/distributed/comm/stats.py``).

Every collective of the gradient path records one entry a call on the
issuing rank: ``logical_bytes`` is what the exchange would cost in fp32
(the tensor's own dtype for the dense collectives), ``wire_bytes`` what
this rank put on the wire (int8 codes and per-block scales on the
quantized path). The reference's thread ranks share one counter; the
port's ranks are processes, each with its own (ROADMAP C51): sum them
over the ranks to compare.

Two counters have no reference counterpart. ``host_staged`` counts the
calls whose CUDA tensors went through host memory because their gloo
group takes CUDA tensors only for ``all_reduce`` and ``broadcast``;
``overlap_buckets`` counts gradient buckets dispatched by the
ready-bucket scheduler during backward (``in_backward``) and at the step
boundary (``at_barrier``), the reference's telemetry counter
``paddle_comm_overlap_buckets_total``. The reference's Prometheus bridge
waits for the profiler's port (ROADMAP queue A item 9).
"""
from __future__ import annotations

import threading
from collections import defaultdict


class CommStats:
    """Counters for collective communication volume and compression."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.calls = 0
            self.logical_bytes = 0
            self.wire_bytes = 0
            self.quant_max_error = 0.0
            self.host_staged = 0
            self.overlap_buckets = {"in_backward": 0, "at_barrier": 0}
            self.by_kind = defaultdict(lambda: {"calls": 0, "logical_bytes": 0,
                                                "wire_bytes": 0})

    def record(self, kind: str, logical_bytes: int, wire_bytes: int,
               max_error: float = 0.0):
        with self._lock:
            self.calls += 1
            self.logical_bytes += int(logical_bytes)
            self.wire_bytes += int(wire_bytes)
            if max_error > self.quant_max_error:
                self.quant_max_error = float(max_error)
            k = self.by_kind[kind]
            k["calls"] += 1
            k["logical_bytes"] += int(logical_bytes)
            k["wire_bytes"] += int(wire_bytes)

    def record_staged(self):
        with self._lock:
            self.host_staged += 1

    def record_bucket(self, where: str):
        with self._lock:
            self.overlap_buckets[where] += 1

    @property
    def compression_ratio(self) -> float:
        """logical/wire: above 1 the wire was cheaper than fp32."""
        return self.logical_bytes / self.wire_bytes if self.wire_bytes else 1.0

    def as_dict(self):
        with self._lock:
            return {
                "calls": self.calls,
                "logical_bytes": self.logical_bytes,
                "wire_bytes": self.wire_bytes,
                "compression_ratio": round(self.compression_ratio, 4),
                "quant_max_error": self.quant_max_error,
                "host_staged": self.host_staged,
                "overlap_buckets": dict(self.overlap_buckets),
                "by_kind": {k: dict(v) for k, v in self.by_kind.items()},
            }


_GLOBAL = CommStats()


def get_comm_stats() -> CommStats:
    return _GLOBAL


def reset_comm_stats():
    _GLOBAL.reset()
