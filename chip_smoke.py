#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on error (non-zero exit, no result line):

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` with nvcc;
2. kernel parity at Llama-3-8B attention shapes (32 heads, 8 kv heads,
   head_dim 128, page 16) on a mixed ragged layout: both kernels against
   their plain PyTorch versions in fp32 (TF32 off, tolerance 1e-5), in
   bf16 against the fp32 plain version rounded to bf16 (one bf16 ulp
   plus the fp32 tolerance per element), and kernel against kernel in
   fp32 (1e-5);
3. serving: a full-width, 32-layer Llama-3-8B in bf16 with seeded random
   weights serves 8 concurrent requests (prompts of 32-600 tokens, four
   sharing a 64-token prefix, 16 new tokens each) through
   ``ContinuousServingEngine.generate``, once on the default q-block
   kernel and once on the per-token kernel, each with the launch counts
   zeroed just before and read just after (after one uncounted warm
   pass); one further instrumented pass per kernel times every tick and
   captures one real tick's layer-0 attention inputs, replayed through
   both kernels and the plain versions; and a ragged forward of a
   two-layer fp32 model at the same widths is held against its
   cache-free forward on a short prompt;
4. timing of both kernels and their plain versions at the captured tick
   (CUDA events, median over 50 launches with L2 flushed between them),
   the bound for the same work, and the serving tick time;
5. tick breakdown: per tick of the instrumented passes, the forward, the
   schedule build and the attention calls, and both kernels replayed at
   every tick shape.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import subprocess
import sys
import threading
import time

import numpy as np

N_HEADS, N_KV, HEAD_DIM, PAGE = 32, 8, 128, 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_TOL = 1e-5
SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
REF = "paddle_tpu/ops/pallas/ragged_paged_attention.py"


def log(*args):
    print(*args, flush=True)


def max_err(a, b, rows):
    return float((a[rows].float() - b[rows].float()).abs().max())


def check(name, err, tol, what="max_abs_err"):
    log(f"  {name}: {what} {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")


def bf16_err(torch, out, ref32, rows):
    """A bf16 kernel output against its fp32 plain version rounded to
    bf16: (max abs error, max of error / allowance). The kernel
    accumulates in fp32 like the plain version, so before its final
    rounding it lies within FP32_TOL of it; both roundings together add
    at most one bf16 ulp of the reference. The allowance per element is
    therefore ``ulp_bf16(ref) + FP32_TOL``, and the check is <= 1."""
    ref = ref32[rows].float().bfloat16().float()
    diff = (out[rows].float() - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return float(diff.max()), float((diff / (ulp + FP32_TOL)).max())


def span_rows(q_starts, q_lens):
    return np.concatenate([np.arange(s, s + n)
                           for s, n in zip(q_starts, q_lens)])


# ---------------------------------------------------------------------------
# phase 2: kernel parity on a synthetic mixed layout
# ---------------------------------------------------------------------------

def parity_layout(torch, rpa, dev):
    """Decode spans, a 37-token prefill straddling q-blocks, two
    sequences aliasing the same prefix pages, and padding tokens."""
    max_len, nslots = 2048, 8
    pps = max_len // PAGE
    num_pages = nslots * pps + 1
    tbl = np.zeros((nslots, pps), np.int32)
    for s in range(nslots):
        tbl[s] = np.arange(1 + s * pps, 1 + (s + 1) * pps)
    tbl[5, :4] = tbl[4, :4]                        # shared 64-token prefix
    #            slot, q_start, q_len, ctx
    spans = [(0, 0, 1, 700), (1, 1, 1, 33), (2, 2, 1, 1),
             (3, 3, 37, 137), (4, 40, 20, 84), (5, 60, 1, 70)]
    desc = tuple(np.asarray([s[i] for s in spans], np.int32)
                 for i in range(4))
    T = 64                                          # 3 padding tokens
    g = torch.Generator(device=dev).manual_seed(1234)
    shape = (N_KV, num_pages, PAGE, HEAD_DIM)
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    q = torch.randn((T, N_HEADS, HEAD_DIM), generator=g, device=dev)
    return q, kp, vp, tbl, desc


def compare_kernels(torch, rpa, q, kp, vp, tbl, desc, label):
    """Kernels vs plain versions in fp32 and bf16, kernel vs kernel in
    fp32. Returns the errors by kernel."""
    rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=q.device)
    scale = HEAD_DIM ** -0.5
    plans = {impl: rpa.make_plan(q.shape[0], *desc, tbl, PAGE, impl=impl,
                                 device=q.device) for impl in rpa.IMPLS}
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    q32, k32, v32 = q.float(), kp.float(), vp.float()
    qb, kb, vb = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    errs, out32 = {}, {}
    for impl in rpa.IMPLS:
        out32[impl] = kern[impl](q32, k32, v32, plans[impl], scale)
        ref32 = plain[impl](q32, k32, v32, plans[impl], scale)
        e32 = max_err(out32[impl], ref32, rows)
        check(f"{label} {impl} fp32 kernel vs plain", e32, FP32_TOL)
        # bf16 kernel against the fp32 plain version on the same
        # bf16-rounded inputs, rounded to bf16
        ob = kern[impl](qb, kb, vb, plans[impl], scale)
        rb = plain[impl](qb.float(), kb.float(), vb.float(), plans[impl],
                         scale)
        assert ob.dtype == torch.bfloat16
        eb, ulps = bf16_err(torch, ob, rb, rows)
        log(f"  {label} {impl} bf16 kernel vs bf16(fp32 plain): "
            f"max_abs_err {eb:.3e}")
        check(f"{label} {impl} bf16 kernel vs bf16(fp32 plain)", ulps,
              1.0, "max error / (1 bf16 ulp + fp32 tol)")
        errs[impl] = {"fp32": e32, "bf16": eb}
    torch.cuda.synchronize()
    check(f"{label} qblock vs token kernel fp32",
          max_err(out32["qblock"], out32["token"], rows), FP32_TOL)
    return errs, plans


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def make_prompts():
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, 128256, 64)
    lengths = [600, 32, 257, 45]                    # unrelated prompts
    tails = [40, 100, 9, 300]                       # after the shared prefix
    prompts = [rng.randint(0, 128256, n) for n in lengths]
    prompts += [np.concatenate([prefix, rng.randint(0, 128256, n)])
                for n in tails]
    warm = np.concatenate([prefix, rng.randint(0, 128256, 20)])
    return [p.astype(np.int64) for p in prompts], warm.astype(np.int64)


class TickProbe:
    """Instruments one serving run, tick by tick: the model forward on
    the host clock up to a device sync, the schedule build
    (``make_plan``, host clock, its device copies included) and every
    layer's attention call between two CUDA events. Keeps each tick's
    descriptors and block tables, and layer 0's inputs of the largest
    tick that mixes decode and prefill spans."""

    def __init__(self, torch, gen_module, model, n_layers):
        self.torch, self.mod, self.model = torch, gen_module, model
        self.n_layers = n_layers
        self.orig_attn = gen_module.ragged_paged_attention
        self.orig_plan = gen_module.make_plan
        self.calls, self.best, self.score = 0, None, -1
        self.ticks = []          # dict per forward

    def attention(self, q, kp, vp, tables, slots, starts, lens, ctx, **kw):
        if self.calls % self.n_layers == 0:
            self.ticks[-1].update(tbl=tables.copy(), pool=(kp, vp),
                                  tokens=q.shape[0],
                                  desc=(slots, starts, lens, ctx))
            mixed = (lens == 1).any() and (lens > 1).any()
            score = int(lens.sum()) + (10 ** 6 if mixed else 0)
            if score > self.score:
                self.score = score
                self.best = dict(q=q.clone(), kp=kp.clone(), vp=vp.clone(),
                                 tbl=tables.copy(),
                                 desc=(slots, starts, lens, ctx))
        self.calls += 1
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.orig_attn(q, kp, vp, tables, slots, starts, lens, ctx,
                             **kw)
        b.record()
        self.ticks[-1]["events"].append((a, b))
        return out

    def make_plan(self, *args, **kw):
        t0 = time.perf_counter()
        plan = self.orig_plan(*args, **kw)
        self.ticks[-1]["plan_ms"] += (time.perf_counter() - t0) * 1e3
        return plan

    def forward(self, *args, **kw):
        self.ticks.append(dict(events=[], plan_ms=0.0))
        t0 = time.perf_counter()
        out = self.orig_forward(*args, **kw)
        self.torch.cuda.synchronize()
        self.ticks[-1]["fwd_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def summary(self):
        """Per tick: tokens, forward ms, attention ms (sum over layers of
        the event pairs), make_plan ms."""
        return [dict(tokens=int(np.asarray(t["desc"][2]).sum()),
                     fwd_ms=t["fwd_ms"], plan_ms=t["plan_ms"],
                     attn_ms=sum(a.elapsed_time(b) for a, b in t["events"]))
                for t in self.ticks]

    def __enter__(self):
        self.mod.ragged_paged_attention = self.attention
        self.mod.make_plan = self.make_plan
        self.orig_forward = self.model.forward
        self.model.forward = self.forward
        return self

    def __exit__(self, *exc):
        self.mod.ragged_paged_attention = self.orig_attn
        self.mod.make_plan = self.orig_plan
        del self.model.forward
        self.torch.cuda.synchronize()


def serve(torch, pt, rpa, model, impl, prompts, warm, capture=None):
    """Warm the engine (compiles nothing, but fills cuBLAS workspaces and
    registers the shared prefix), then zero the launch counts and serve
    all prompts concurrently. Returns outputs, counts and timings."""
    eng = pt.ContinuousServingEngine(model, max_batch_size=8, max_len=2048,
                                     page_size=PAGE, token_budget=256,
                                     prefill_chunk_tokens=256,
                                     ragged_impl=impl)
    results = [None] * len(prompts)
    errors = []

    def run(i, p):
        try:
            results[i] = eng.generate(p, max_new_tokens=16,
                                      timeout=600).numpy()
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    with eng:
        eng.generate(warm, max_new_tokens=16, timeout=600)
        steps0, hits0 = eng.ragged_steps, eng.prefix_hits
        rpa.qblock_attention.launches = 0
        rpa.token_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture or contextlib.nullcontext():
            threads = [threading.Thread(target=run, args=(i, p))
                       for i, p in enumerate(prompts)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
        wall = time.perf_counter() - t0
        launches = {"qblock": rpa.qblock_attention.launches,
                    "token": rpa.token_attention.launches}
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serving failed: {errors!r}")
        stats = dict(steps=eng.ragged_steps - steps0,
                     hits=eng.prefix_hits - hits0, wall=wall,
                     launches=launches,
                     useful=eng.useful_tokens_total,
                     padded=eng.padded_tokens_total)
    return results, stats


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=50, warmup=5):
    """Median ms of ``fn()`` over ``iters`` launches, CUDA events around
    each, with a 256 MiB write between launches to flush the 50 MB L2
    (in the engine the previous layer's weights and pools evict it)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(q, kp, tbl, desc):
    """Least time for this tick's ragged attention on an H100: the larger
    of the bytes it must move (q and out once, every K/V page the spans'
    contexts cover once, the descriptors) over 3.35 TB/s and its flops
    (QK^T and PV for every visible key of every span token) over the
    989 TFLOP/s bf16 peak."""
    slots, starts, lens, ctxs = (np.asarray(a) for a in desc)
    el = q.element_size()
    pages = set()
    flops = 0
    for s, ql, c in zip(slots, lens, ctxs):
        pages.update(tbl[s, :-(-int(c) // PAGE)].tolist())
        vis = np.arange(c - ql + 1, c + 1)          # keys each token sees
        flops += 4 * N_HEADS * HEAD_DIM * int(vis.sum())
    nbytes = (2 * q.numel() * el
              + 2 * len(pages) * N_KV * PAGE * HEAD_DIM * el
              + tbl.nbytes + 4 * 4 * len(slots))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def tick_breakdown(torch, rpa, probes, scale, n_layers):
    """Where each engine's tick time goes. For every tick of the two
    instrumented runs: the forward (host clock to a device sync), the
    schedule build and the attention calls in place (CUDA events around
    each layer's call). For the q-block run's ticks also both kernels
    replayed alone at that tick's descriptors (L2 flushed, median of 10)
    times the layer count."""
    log("phase 5: tick breakdown (bf16, every tick of the 8-request load)")
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    out = {}
    for run, probe in probes.items():
        log(f"  run {run}: tick tokens q_lens | fwd_ms attn_ms plan_ms"
            + (" | replay x32: qblock_ms token_ms" if run == "qblock"
               else ""))
        ticks = []
        for i, (t, s) in enumerate(zip(probe.ticks, probe.summary())):
            line = (f"    {i:2d} {t['tokens']:3d} "
                    f"{np.asarray(t['desc'][2]).tolist()} | "
                    f"{s['fwd_ms']:.3f} {s['attn_ms']:.3f} "
                    f"{s['plan_ms']:.3f}")
            if run == "qblock":
                kp, vp = t["pool"]
                g = torch.Generator(device="cuda").manual_seed(i)
                q = torch.randn((t["tokens"], N_HEADS, HEAD_DIM),
                                generator=g, device="cuda", dtype=kp.dtype)
                for impl in rpa.IMPLS:
                    plan = rpa.make_plan(t["tokens"], *t["desc"], t["tbl"],
                                         PAGE, impl=impl, device="cuda")
                    s[f"replay_{impl}_ms"] = n_layers * time_ms(
                        torch, lambda: kern[impl](q, kp, vp, plan, scale),
                        iters=10, warmup=2)
                line += (f" | {s['replay_qblock_ms']:.3f} "
                         f"{s['replay_token_ms']:.3f}")
            log(line)
            ticks.append(s)
        tot = {k: sum(s[k] for s in ticks) for k in ticks[0]
               if k != "tokens"}
        log(f"  run {run} sums over {len(ticks)} ticks: " + ", ".join(
            f"{k} {v:.3f}" for k, v in tot.items()))
        out[run] = dict(ticks=len(ticks), **tot)
    log(json.dumps({"tick_breakdown": out}))


# ---------------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}")

    log("phase 1: build")
    _, build_s = _build.build()
    _build.load_kernels()
    log(f"  build_seconds {build_s:.2f}")

    log("phase 2: kernel parity at Llama-3-8B attention shapes")
    q, kp, vp, tbl, desc = parity_layout(torch, rpa, dev)
    compare_kernels(torch, rpa, q, kp, vp, tbl, desc, "synthetic")
    del q, kp, vp
    torch.cuda.empty_cache()

    log("phase 3: serving Llama-3-8B (32 layers, bf16, random weights)")
    cfg = pt.llama3_8b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    prompts, warm = make_prompts()
    # one uncounted pass fills cuBLAS's choices for every tick shape, so
    # the two counted runs below are timed warm and alike
    serve(torch, pt, rpa, model, "qblock", prompts, warm)
    runs = {}
    for impl in rpa.IMPLS:
        outs, st = serve(torch, pt, rpa, model, impl, prompts, warm)
        runs[impl] = (outs, st)
        log(f"  {impl}: {st['steps']} ticks, {st['hits']} prefix hits, "
            f"launches {st['launches']}, wall {st['wall']:.3f} s")
        for p, o in zip(prompts, outs):
            if o.shape != (1, p.shape[0] + 16) or \
                    not np.array_equal(o[0, :p.shape[0]], p) or \
                    not ((o >= 0) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"bad output shape/content {o.shape}")
        if st["steps"] <= 0 or st["hits"] <= 0:
            raise AssertionError(f"{impl}: no ticks or no prefix hits")
        want = cfg.num_hidden_layers * st["steps"]
        if st["launches"][impl] != want:
            raise AssertionError(f"{impl} kernel launched "
                                 f"{st['launches'][impl]} times, expected "
                                 f"{want} (32 x ticks)")
    for a, b in zip(runs["qblock"][0], runs["token"][0]):
        if not np.array_equal(a, b):
            raise AssertionError("q-block and per-token engines disagree")
    log("  greedy streams identical under both kernels")
    # one instrumented pass per kernel: tick-by-tick forward, schedule
    # and attention times; the q-block pass also keeps one real tick's
    # layer-0 attention inputs
    probes = {}
    for impl in rpa.IMPLS:
        probes[impl] = TickProbe(torch, gen, model, cfg.num_hidden_layers)
        serve(torch, pt, rpa, model, impl, prompts, warm,
              capture=probes[impl])
    cap = probes["qblock"]
    short = np.concatenate([prompts[1], runs["qblock"][0][1][0, 32:47]])
    del model
    torch.cuda.empty_cache()

    # the ragged path against the cache-free forward on a short prompt,
    # in fp32 (TF32 off) at full width and two layers: the plain
    # attention reference is itself bf16 in a bf16 model and drifts
    # several percent over 32 layers
    ref_cfg = pt.llama3_8b()
    ref_cfg.num_hidden_layers = 2
    ref_model = pt.LlamaForCausalLM(ref_cfg, device="cuda", seed=0)
    with torch.inference_mode():
        ref = ref_model(short[None])[0]
        cache = gen.SlotPagedKVCache(1, page_size=PAGE, max_len=2048)
        cache.assign(0, short)
        cache.begin_ragged([(0, 0, short.shape[0])])
        got = ref_model(short[None], cache=cache,
                        position_ids=np.arange(short.shape[0]))[0]
    if not (torch.isfinite(got).all() and got.shape == (47, cfg.vocab_size)):
        raise AssertionError("ragged logits not finite or mis-shaped")
    rel = float((got - ref).abs().max() / ref.abs().max())
    check("ragged vs cache-free logits (relative, fp32, 2 layers)", rel,
          1e-4)
    del ref_model, cache, ref, got
    torch.cuda.empty_cache()

    log("  captured tick: " + json.dumps(
        {k: np.asarray(v).tolist() for k, v in
         zip(("slots", "q_starts", "q_lens", "ctx"), cap.best["desc"])}))
    c = cap.best
    cerrs, plans = compare_kernels(torch, rpa, c["q"], c["kp"], c["vp"],
                                   c["tbl"], c["desc"], "captured")

    log("phase 4: timing at the captured tick (bf16)")
    scale = HEAD_DIM ** -0.5
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    bms, bby = bound_ms(c["q"], c["kp"], c["tbl"], c["desc"])
    rows = []
    for impl, name, line in (("qblock", "ragged_qblock", 215),
                             ("token", "ragged_token", 389)):
        args = (c["q"], c["kp"], c["vp"], plans[impl], scale)
        ms = time_ms(torch, lambda: kern[impl](*args))
        pms = time_ms(torch, lambda: plain[impl](*args), iters=10)
        log(f"  {name}: {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({bby}), library: none (no single PyTorch call computes "
            f"ragged paged attention)")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": f"{REF}:{line}",
                     "launches": runs[impl][1]["launches"][impl],
                     "max_abs_err": cerrs[impl]["bf16"],
                     "max_abs_err_fp32": cerrs[impl]["fp32"],
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": None})
    tick_breakdown(torch, rpa, probes, scale, cfg.num_hidden_layers)
    for impl in rpa.IMPLS:
        st = runs[impl][1]
        gen_tokens = 16 * len(prompts)
        log(f"  serving[{impl}]: tick {st['wall'] / st['steps'] * 1e3:.2f} ms"
            f" ({st['steps']} ticks), {gen_tokens / st['wall']:.1f} "
            f"generated tokens/s, {st['useful']} useful / {st['padded']} "
            f"padded tokens over the engine's life")

    log(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                 # noqa: BLE001 — any phase failing
        import traceback
        traceback.print_exc()
        sys.exit(1)
