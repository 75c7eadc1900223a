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

The language-model zoo of ``models`` serves and trains the same way:
``GPTForCausalLM`` (GPT-3 widths, a tied head, bf16 KV pages), BERT and
ERNIE (``BertForSequenceClassification``, ``BertForPretraining``),
``T5ForConditionalGeneration`` (greedy ``generate``) and
``MixtralForCausalLM`` (Llama's attention with the GShard mixture of
experts of ``incubate.distributed.models.moe``); ``nn`` holds the
transformer layers (``MultiHeadAttention``, ``Transformer``).

It trains PaddleClas's ResNet on images the same way:
``vision.models.resnet50(num_classes=10)``, ``nn.CrossEntropyLoss``,
``optimizer.Momentum``, under ``amp.decorate(level="O2")`` (the norm
layers stay fp32) and ``auto_cast``. ``nn`` is Paddle's layer surface:
``Layer`` (a ``torch.nn.Module`` with Paddle's names and ``state_dict``
order), the convolution, pooling, norm, activation, loss and common
layers, ``nn.functional``, ``nn.initializer`` and ``nn.utils``; the op
registry is ``ops.schema``.

The op surface is Paddle's: ``import paddle_tpu_torch as paddle``, then
``paddle.to_tensor``, the creation, math, manipulation and logic ops at
the top level and in ``paddle.tensor``, and ``paddle.linalg``. Tensors
are ``torch.Tensor``; new ones land on ``paddle.get_device()``, ``"gpu:0"``
(CUDA) by default, so call ``paddle.set_device("cpu")`` first on a
machine without CUDA. Random ops draw from one ``torch.Generator`` a
device, reseeded by ``paddle.seed``.

The training-loop surface is Paddle's too. ``paddle.Tensor`` is
``torch.Tensor``, given at import the Paddle members it lacks
(``framework/tensor_patch.py``: ``stop_gradient``, ``astype``,
``set_value``, ``place`` and the op methods; nothing torch has is
overridden). ``autograd`` holds ``grad``, ``backward``, the grad modes
and ``PyLayer``; ``io`` the datasets, samplers and ``DataLoader`` (worker
processes, batches prefetched to the card on a side stream); ``metric``
and ``callbacks`` what ``Model.fit`` (``hapi.py``: ``paddle.Model``,
``summary``, ``flops``) reports to; ``jit.to_static`` compiles a layer or
function with ``torch.compile``, flash attention's kernels staying
custom ops inside it.

Local Hugging Face checkpoints (Llama, GPT-2, BERT, T5) load through
``models.pretrained`` (``LlamaForCausalLM.from_pretrained``).
``vision.transforms`` and ``vision.datasets`` are Paddle's host-side
data pipeline; ``fft``, ``signal`` and ``audio`` the spectral ops and
features on ``torch.fft``; ``text`` Viterbi decoding and the text
datasets. ``geometric`` holds the segment pools and message passing of
graph learning (gathers and one scatter on the card), ``sparse`` the COO
and CSR tensors with their ops (``torch.sparse``, cuSPARSE SpMM),
sparse attention and the sparse 3-D convolutions, and ``distribution``
Paddle's distributions, transforms and KL registry, drawing from the
port's generators.

``distributed`` runs data-parallel training on ``torch.distributed``, one
process a rank (NCCL on the card, gloo on the CPU): ``spawn`` or a
launcher, ``fleet.init`` with the ``[dp, pp, sharding, sep, mp]`` mesh,
``fleet.distributed_model`` / ``distributed_optimizer``, Paddle's
collectives and the bucketed, optionally int8 gradient exchange.
"""
import sys as _sys

import torch as _torch

from . import amp, nn, optimizer, quantization, vision
from .framework import tensor_patch as _tensor_patch
from .framework.core import (CPUPlace, CUDAPlace, Place, device_count,
                             get_device, is_compiled_with_cuda,
                             is_compiled_with_xpu, set_device, to_tensor)
from .framework.param_attr import ParamAttr
from .framework.dtype import (bfloat16, bool_, complex64, complex128,
                              float16, float32, float64, get_default_dtype,
                              int8, int16, int32, int64, set_default_dtype,
                              uint8)
from .framework.random import (get_cuda_rng_state, get_rng_state, seed,
                               set_cuda_rng_state, set_rng_state)
from . import ops as tensor
from .ops import *  # noqa: F401,F403
from .ops import bitwise_not as bitwise_invert
from .ops import linalg
from .ops.linalg import (corrcoef, cov, dist, inv as inverse, matrix_power,
                         norm)
from .convert import jax_layout, load_jax_state
from .framework.io import load, save
from .inference.serving import ContinuousServingEngine, ServingEngine
from .models.llama import (LlamaConfig, LlamaForCausalLM,
                           LlamaPretrainingCriterion, llama3_8b, llama_tiny)
from . import autograd, callbacks, incubate, io, jit, metric, models
from . import audio, fft, signal, text
from . import distribution, geometric, sparse
from . import distributed
from .autograd import (PyLayer, enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .hapi import Model, flops, summary
from .jit.api import disable_static, enable_static, in_dynamic_mode

Tensor = _torch.Tensor
_tensor_patch.install()

__all__ = ["LlamaForCausalLM", "LlamaConfig", "LlamaPretrainingCriterion",
           "llama_tiny", "llama3_8b", "ContinuousServingEngine",
           "ServingEngine", "load_jax_state", "jax_layout", "load", "save",
           "amp", "nn", "optimizer", "quantization", "vision", "ParamAttr",
           "set_device",
           "get_device", "to_tensor", "bfloat16", "bool_", "complex64",
           "complex128", "float16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "get_default_dtype",
           "set_default_dtype", "seed", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "tensor",
           "bitwise_invert", "inverse", "norm", "dist", "matrix_power",
           "cov", "corrcoef", "Tensor", "Place", "CPUPlace", "CUDAPlace",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_xpu",
           "autograd", "callbacks", "incubate", "io", "jit", "metric",
           "models", "audio", "fft", "signal", "text", "distribution",
           "geometric", "sparse", "distributed", "PyLayer",
           "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled", "Model", "flops", "summary", "disable_static",
           "enable_static", "in_dynamic_mode"] + tensor.__all__

_sys.modules[__name__ + ".tensor"] = tensor     # import paddle_tpu_torch.tensor
