"""paddle.distributed.comm (port of
``paddle_tpu/distributed/comm/__init__.py``): the bucketed and quantized
gradient exchange (EQuARX-style blockwise int8, arXiv:2506.17615).

* :class:`GradientBucketer` fuses the parameters' gradients into
  dtype-homogeneous buckets of ``fuse_grad_size_in_MB`` with a layout
  every rank derives alike, one collective a bucket;
  :class:`ReadyBucketScheduler` launches a bucket's collective during
  backward, the moment its last gradient is final;
* :func:`all_reduce_quantized` / :func:`reduce_scatter_quantized` put
  blockwise int8 or bf16 on the wire, with optional error feedback;
* :class:`CommStats` counts calls, logical and wire bytes, the largest
  quantization error, host-staged calls and buckets dispatched.

``DistributedStrategy.comm_quantization``, ``fuse_grad_size_in_MB``,
``comm_configs`` and ``comm_overlap`` route ``DataParallel`` and
``HybridParallelOptimizer`` through it.
"""
from __future__ import annotations

from .stats import CommStats, get_comm_stats, reset_comm_stats  # noqa: F401
from .quantization import (  # noqa: F401
    DEFAULT_BLOCK_SIZE, SCHEMES, decode_wire, dequantize_blockwise,
    encode_wire, quantize_blockwise,
)
from .collectives import (  # noqa: F401
    PASSTHROUGH, all_reduce_quantized, allreduce_array,
    reduce_scatter_array, reduce_scatter_quantized, start_allreduce_array,
)
from .bucketer import GradientBucketer, ReadyBucketScheduler  # noqa: F401


def comm_config_from_strategy(strategy) -> dict:
    """:class:`GradientBucketer`'s keyword arguments from a
    ``DistributedStrategy`` (None gives the defaults)."""
    cfg = dict(getattr(strategy, "comm_configs", {}) or {})
    return {
        "fuse_grad_size_in_MB": getattr(strategy, "fuse_grad_size_in_MB", 32),
        "quantization": getattr(strategy, "comm_quantization", None),
        "block_size": cfg.get("block_size", DEFAULT_BLOCK_SIZE),
        "error_feedback": cfg.get("error_feedback", False),
    }
