"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper. It imports torch and numpy, never JAX and nothing of
``paddle_tpu``.

This slice serves Llama through the continuous-batching engine: its
ragged paged attention runs on two hand-written CUDA kernels
(``csrc/ragged_paged_attention.cu``), built with ``nvcc`` at first use.
Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the plain PyTorch versions instead.
"""
from .convert import load_jax_state
from .inference.serving import ContinuousServingEngine
from .models.llama import LlamaConfig, LlamaForCausalLM, llama3_8b, llama_tiny

__all__ = ["LlamaForCausalLM", "LlamaConfig", "llama_tiny", "llama3_8b",
           "ContinuousServingEngine", "load_jax_state"]
