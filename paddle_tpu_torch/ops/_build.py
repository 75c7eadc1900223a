"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on its own, with the ``.cuh``
headers beside it, into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), for ``sm_90a``. Libraries
land in ``build/kernels/`` at the repository root, named by a digest of
the source, the headers and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. All sources compile in parallel,
one ``nvcc`` each. Nothing is built at import: the first call that needs
a kernel builds it, and a failed build raises. Every launch goes through
:func:`launch`, the one place the wrappers' launch counters rise; a
launch made while a CUDA graph is being captured runs only at the
graph's replays, so it is recorded instead (:func:`record_launches`) and
credited at each replay (:meth:`LaunchRecord.credit`). The tensor-core
kernels encode their TMA tensor maps with libcuda's
``cuTensorMapEncodeTiled``, looked up at run time through the CUDA
runtime's entry-point query, so no library links against ``libcuda``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
#: the q-block kernels' unit variant, one source a page size
UNIT_PAGES = (4, 8, 16, 32)
SOURCES = ("ragged_paged_attention.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "paged_attention.cu", "quant_matmul.cu",
           "optimizer_step.cu", "qblock_runtime.cu") + tuple(
               f"qblock_unit_p{p}.cu" for p in UNIT_PAGES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the ``dtype`` argument of every exported kernel function
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: argtypes of every exported function, by library stem
SIGNATURES = {
    **{f"qblock_unit_p{p}": {
        f"ptt_ragged_qblock_p{p}": [_I] + [_P] * 9 + [_I] * 9 + [_F, _P],
        f"ptt_ragged_qblock_p{p}_q8": [_I] + [_P] * 11 + [_I] * 9
                                      + [_F, _P],
    } for p in UNIT_PAGES},
    "qblock_runtime": {
        "ptt_ragged_qblock_rt": [_I] + [_P] * 9 + [_I] * 9 + [_F, _P],
        "ptt_ragged_qblock_rt_q8": [_I] + [_P] * 11 + [_I] * 9 + [_F, _P],
        "ptt_ragged_qblock_rt_smem": [_I] * 5 + [_P],
    },
    "ragged_paged_attention": {
        "ptt_ragged_token": [_I] + [_P] * 7 + [_I] * 7 + [_F, _P],
        "ptt_ragged_qblock_smem": [_I] * 8,
        "ptt_ragged_token_q8": [_I] + [_P] * 9 + [_I] * 7 + [_F, _P],
        "ptt_ragged_token_split": [_I] + [_P] * 7 + [_I] * 7 + [_F]
                                  + [_I] * 2 + [_P],
        "ptt_ragged_token_split_q8": [_I] + [_P] * 9 + [_I] * 7 + [_F]
                                     + [_I] * 2 + [_P],
        "ptt_ragged_token_split_smem": [_I] * 8,
    },
    "flash_attention": {
        "ptt_flash_fwd": [_I] + [_P] * 5 + [_L] * 12 + [_I] * 11 + [_F, _P],
        "ptt_flash_fwd_wgmma": [_I] + [_P] * 5 + [_L] * 12 + [_I] * 11
                               + [_F, _P],
    },
    "flash_attention_bwd": {
        "ptt_flash_bwd_dq": [_I] + [_P] * 7 + [_L] * 15 + [_I] * 9
                            + [_F, _P],
        "ptt_flash_bwd_dkv": [_I] + [_P] * 8 + [_L] * 18 + [_I] * 9
                             + [_F, _P],
        "ptt_flash_bwd_dq_wgmma": [_I] + [_P] * 7 + [_L] * 15 + [_I] * 9
                                  + [_F, _P],
        "ptt_flash_bwd_dkv_wgmma": [_I] + [_P] * 8 + [_L] * 18 + [_I] * 9
                                   + [_F, _P],
    },
    "paged_attention": {
        "ptt_paged_decode": [_I] + [_P] * 6 + [_I] * 7 + [_F, _P],
        "ptt_paged_decode_q8": [_I] + [_P] * 8 + [_I] * 7 + [_F, _P],
        "ptt_paged_decode_split": [_I] + [_P] * 6 + [_I] * 7 + [_F]
                                  + [_I] * 2 + [_P],
        "ptt_paged_decode_split_q8": [_I] + [_P] * 8 + [_I] * 7 + [_F]
                                     + [_I] * 2 + [_P],
        "ptt_paged_decode_split_smem": [_I] * 7,
    },
    "quant_matmul": {
        "ptt_int8_matmul": [_I] + [_P] * 4 + [_I] * 3 + [_P],
        "ptt_int8_matmul_wgmma": [_I] + [_P] * 5 + [_I] * 7 + [_P],
        "ptt_int8_matmul_fp32": [_I] + [_P] * 5 + [_I] * 6 + [_P],
        "ptt_int8_matmul_fp32_smem": [_I] * 3,
    },
    "optimizer_step": {
        "ptt_adam_step": [_I, _P, _P, _I, _L, _L, _P] + [_F] * 10
                         + [_I, _P],
        "ptt_sum_squares_partial": [_P, _I, _L, _L, _P, _P],
        "ptt_sum_squares_finish": [_P, _I, _P, _P, _P],
    },
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(source):
    src = CSRC / source
    # the shared headers are part of every source's digest
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return src, BUILD_DIR / f"{src.stem}_{digest}.so"


def build(sources=SOURCES):
    """Compile every source whose library is missing, all at once.
    Returns ``{stem: path}`` and the seconds the builds took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, paths = [], {}
    for source in sources:
        src, so = _target(source)
        paths[src.stem] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_kernels():
    """Build (if needed) and load every kernel library; returns one
    namespace whose attributes are the exported C functions."""
    paths, _ = build()
    ns = type("Kernels", (), {})()
    for stem, funcs in SIGNATURES.items():
        lib = ctypes.CDLL(str(paths[stem]))
        for name, argtypes in funcs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(ns, name, fn)
        if not hasattr(ns, "ptt_error_string"):
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            ns.ptt_error_string = lib.ptt_error_string
    return ns


def dtype_code(dtype):
    """The kernels' code for ``dtype``; raises for a type they lack."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}; the kernels take "
                        f"{list(_DTYPE_CODE)}")
    return _DTYPE_CODE[dtype]


#: the attention kernels' codes for 16-bit q and out over fp32 pages (the
#: pools of a 16-bit model under AMP's O2, whose cached op casts q alone)
_MIXED_CODE = {torch.bfloat16: 3, torch.float16: 4}


def attention_dtype_code(q_dtype, page_dtype):
    """The attention kernels' ``dtype`` argument for q (and out) of
    ``q_dtype`` over pages of ``page_dtype``: :func:`dtype_code` where
    they agree or the pages are int8 (their codes take any q), 3 / 4 for
    bf16 / fp16 q over fp32 pages; raises for any other pair."""
    code = dtype_code(q_dtype)
    if page_dtype in (q_dtype, torch.int8):
        return code
    if page_dtype == torch.float32 and q_dtype in _MIXED_CODE:
        return _MIXED_CODE[q_dtype]
    raise TypeError(f"no attention kernel takes {q_dtype} q over "
                    f"{page_dtype} pages")


def _bump(target, key, n):
    """Add ``n`` to counter ``key`` of ``target``: an attribute of a
    wrapper function, or an item of a dict (counts by shape)."""
    if isinstance(target, dict):
        target[key] = target.get(key, 0) + n
    else:
        setattr(target, key, getattr(target, key) + n)


class LaunchRecord:
    """The launches one CUDA graph capture recorded, by counter;
    :meth:`credit` adds them once, for one replay of the graph."""

    def __init__(self):
        self.counts = {}            # (id(target), key) -> [target, key, n]

    def add(self, counters):
        for target, key in counters:
            self.counts.setdefault((id(target), key), [target, key, 0])[2] += 1

    def credit(self):
        for target, key, n in self.counts.values():
            _bump(target, key, n)


_capture = threading.local()


@contextlib.contextmanager
def record_launches():
    """Yields the :class:`LaunchRecord` that the launches made on this
    thread while a CUDA graph is being captured go to (they run at the
    graph's replays, not now). A launch under a capture with no record
    open raises."""
    if getattr(_capture, "record", None) is not None:
        raise RuntimeError("record_launches() is already open on this "
                           "thread")
    _capture.record = rec = LaunchRecord()
    try:
        yield rec
    finally:
        _capture.record = None


def _open_record(capturing):
    """The record a launch goes to: none when no capture is under way;
    under one, this thread's open record (raises if there is none)."""
    if not capturing:
        return None
    rec = getattr(_capture, "record", None)
    if rec is None:
        raise RuntimeError("a kernel launched under a CUDA graph capture "
                           "outside record_launches(): its replays would "
                           "go uncounted")
    return rec


def launch(fn_name, device, args, counters=()):
    """Call the exported ``fn_name`` with ``args`` (ctypes values, or
    Python numbers its argtypes convert) on ``device``'s current stream,
    and count it in ``counters`` (``(target, key)`` pairs, see
    :func:`_bump`), or record it under a graph capture. The C
    side returns the cudaError_t of its shared-memory request and launch;
    any error raises (an oversized block is refused by
    cudaFuncSetAttribute). The device context is entered only when
    ``device`` is not the current one."""
    lib = load_kernels()
    rec = _open_record(torch.cuda.is_current_stream_capturing())
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        rc = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.ptt_error_string(rc).decode()} ({rc})")
    if rec is not None:
        rec.add(counters)
        return
    for target, key in counters:
        _bump(target, key, 1)
