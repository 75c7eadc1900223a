"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper. It imports torch and numpy, never JAX and nothing of
``paddle_tpu``.

It serves Llama three ways: ``LlamaForCausalLM.generate`` (greedy,
seeded sampling, beam search; concat or paged KV cache), the static
window batcher ``ServingEngine`` around it, and the continuous-batching
``ContinuousServingEngine`` (ragged ticks, or the legacy prefill-chunk
plus decode-step scheduler with ``enable_ragged=False``), with
speculative decoding (``spec_decode=True``: the drafters of
``inference.speculative``) on the ragged ticks. It trains
Llama in Paddle's eager loop: ``loss, logits = model(ids,
labels=labels)``, ``loss.backward()``, then an optimizer of
``optimizer`` (``AdamW`` and Paddle's others) with
``nn.ClipGradByGlobalNorm`` and the schedulers of ``optimizer.lr``; Adam
and AdamW steps run fused, one kernel launch a parameter group. Mixed
precision is Paddle's: ``amp.decorate(model, opt, level="O2",
dtype="bfloat16")``, the forward under ``amp.auto_cast(level="O2",
dtype="bfloat16")`` (or O1 on fp32 parameters), and
``amp.GradScaler`` for fp16; without AMP a bf16 model computes in fp32
after the rope, as the reference's does. ``save``
and ``load`` read and write Paddle's checkpoints, the reference's
included.
Serving runs fully int8 with ``ContinuousServingEngine(model,
kv_dtype="int8", weight_dtype="int8")``: int8 KV pages with fp32 row
scales, and every ``nn.Linear`` on int8 weights through
``quantization.quantize_linears``. Attention and the int8 matmul run on
hand-written CUDA kernels under ``csrc/`` (ragged paged attention, flash
attention forward and backward, paged decode, each attention kernel also
over int8 pages, the weight-only int8 matmul, and the fused optimizer
step's multi-tensor AdamW and sum of squares), built with ``nvcc``
at first use. Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the plain PyTorch
versions instead.
"""
from . import amp, nn, optimizer, quantization
from .convert import jax_layout, load_jax_state
from .framework.io import load, save
from .inference.serving import ContinuousServingEngine, ServingEngine
from .models.llama import (LlamaConfig, LlamaForCausalLM,
                           LlamaPretrainingCriterion, llama3_8b, llama_tiny)

__all__ = ["LlamaForCausalLM", "LlamaConfig", "LlamaPretrainingCriterion",
           "llama_tiny", "llama3_8b", "ContinuousServingEngine",
           "ServingEngine", "load_jax_state", "jax_layout", "load", "save",
           "amp", "nn", "optimizer", "quantization"]
