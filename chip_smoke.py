#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 7,11    # the build and those phases

Phases, each fatal on error (non-zero exit, no result line). With no
arguments all run; ``--phases`` picks some of 2-6 (one unit: they share
one model and its captures), 7, 8, 9, 10, 11, 12, 13 and 14 after the
build, and
such a run ends on a ``{"partial": ...}`` line instead of the result
line:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and print every kernel's registers
   and spills from ``ptxas -v``, ptxas's wgmma notes for B1, B2, B3 and
   B10 and the dynamic shared memory of each q-block (kernel 6, B7),
   cluster kernel 8/B9 (with its splits and pages a round at the mixed
   and pure-decode ticks, held equal to the wrapper's formula), cluster
   B4/B5 (with its splits and ring stages at the decode shapes, held
   equal to the wrapper's formula) and tensor-core B1, B2, B3 and B10
   block, and B10's fp32 stream block at each weight shape (held equal to
   this script's formula);
2. kernel parity at Llama-3-8B attention shapes (32 heads, 8 kv heads,
   head_dim 128, page 16): the two ragged kernels on a mixed layout and
   on the per-token split's edge cases (every token seeing 1 key over
   128-page tables, fewer pages than splits, contexts ending on page
   edges, G = 1, one token over three rounds of 8 splits, a 64-token
   prefill of 19 rounds, bucket padding), kernel 8 and B9 as both
   variants (the cluster kernel the rule takes and the block kernel,
   each forced) in fp32, bf16 and fp16, the cluster kernel twice in bf16
   giving the same bits, and at every split count 1-8 on a decode
   layout,
   flash attention forward (B1, out and lse) on causal, offset,
   non-causal and dead-row cases and one at head_dim 64, in fp32 through
   the scalar kernel and in bf16 and fp16 through the tensor-core kernel
   (its own rule, below), the flash backward (B2 dQ, B3 dK/dV)
   on causal, non-causal ragged, dead-row, lse-cotangent and
   head_dim-64 chunk-after-cache cases, in
   fp32 through the scalar kernels and in bf16 and fp16 through the
   tensor-core kernels (their own rule, below), paged
   decode (B4) on a batch of 8 with contexts 1-700 and shared pages and on
   the context split's edge cases (every context 1 token over 128-page
   tables, fewer pages than splits, contexts ending on page edges, G = 1,
   one sequence, 128-page tables under 3-39-page contexts), both variants
   (the rule's cluster kernel and the block kernel, forced), in fp32, bf16
   and fp16 (``ulp_err``: one ulp of the rounded fp32 plain version plus
   1e-5), the cluster kernel twice in bf16 giving the same bits; the
   int8-page kernels B7 and B9 on the ragged layout and B5 on the paged
   ones, pages quantised by the cache's codec; the weight-only int8 matmul
   (B10) at 14 M from 1 to 300 (both tensor-core regimes, both fp32
   ones, their crossovers and every token-tile edge) for the five (K, N)
   of Llama-3-8B, each tensor-core and each fp32 variant also forced at
   the other's M, a K that is no whole number of k-tiles, a K % 16 != 0
   that takes the scalar kernel by rule in every dtype, and two split-K
   launches of each stream and of the fp32 GEMM that must give the same
   bits: bf16 and fp16 on the tensor-core kernels under ROADMAP C20
   (``c20_error``: one ulp of the fp32 plain version rounded to the
   dtype plus 1e-5 of its max; the worst ratio per weight shape is
   printed), fp32 on the fp32 stream and GEMM.
   Each kernel against its plain PyTorch version in fp32 (TF32 off,
   tolerance 1e-5; for gradients and B10 1e-5 of each output's max) and
   in bf16 against the fp32 plain version rounded to bf16 (one bf16 ulp
   plus the fp32 tolerance per element); the ragged kernels also against
   each other in fp32 (1e-5), native and int8 alike; (a) kernel 6 and
   B7 at pages of 4, 8, 12, 32 and 64, head_dim 72 and misaligned pools
   (``page_shapes``: the rule's variant, the runtime kernel forced where
   the unit one runs giving the same bits, C21 against kernel 8 / B9's
   block variant, times against page 16), and at pages of 128, head_dim
   256 (the runtime kernel in runs of keys; kernel 8 takes no such page,
   so the plain version alone holds it); and under ROADMAP
   C21 (``check_c21``): kernel 6 gives the same bits as kernel 8, and B7
   as B9, on every span row, in fp32, bf16 and fp16 (wherever the ragged
   kernels are compared: here, on the captured ticks of phase 4 and on
   every replayed tick of phase 6). The tensor-core B1
   rounds its weights to bf16 or fp16 before P.V (ROADMAP C15): its lse
   within 1e-5 (relative) of the plain version on the same inputs; its
   output within ``ulp + u max|V| + 1e-5`` of the fp32 plain version
   rounded to the dtype (``wgmma_out_error``, the worst-case bound) and
   within ``ulp + slack + 1e-5`` of a model of its own rounding points
   (``rounding_model``, ``model_error``: the tight check, where the
   slack covers only weights that may round either way), printed beside
   the one-ulp rule's ratio and SDPA's ratios under all three. The
   tensor-core B2 and B3 round p and ds to bf16 or fp16 before their
   products (ROADMAP C17): each gradient within ``ulp + rounding + 1e-5
   max`` of the fp32 plain version rounded to the dtype
   (``wgmma_grad_error``; ``rounding`` is u |dS||K|, u |dS|^T|Q| or u
   |P|^T|dO|, plus the subnormal floor for fp16) and within ``ulp +
   slack + 1e-5 max`` of a model of their rounding points
   (``bwd_rounding_model``, ``grad_model_error``);
3. serving a full-width, 32-layer Llama-3-8B in bf16 with seeded random
   weights (created in fp32, as the reference creates them, and cast to
   bf16 before any cache exists; the rope makes q and k fp32 and the
   caches hold their pages in k's dtype, so the cached attention, every
   Linear after layer 0's attention and the logits compute in fp32, as
   the reference's do: every serving path is held to fp32 pools, int8
   codes with fp32 scales under int8 KV, and fp32 logits, ROADMAP C25,
   ``check_c25``), every path with the launch
   counts zeroed just before and read just after, after one uncounted
   warm pass. The continuous engines' counted runs take their default,
   CUDA graphs (each ragged token bucket and the legacy decode step
   captured at its first use, then replayed;
   a replay credits the launches its graph recorded, so the counts stay
   exact); their instrumented passes run eagerly (``cuda_graphs=False``),
   since the probes wrap Python that a replay does not run:
   a. ``ContinuousServingEngine`` (ragged) serves 8 concurrent requests
      (prompts of 32-600 tokens, four sharing a 64-token prefix, 16 new
      tokens each), once on the q-block kernel and once on the per-token
      kernel (launches = 32 x ticks, every per-token launch on the
      cluster kernel, whose count says so); one further instrumented pass
      per
      kernel times every tick and captures one tick's layer-0 inputs;
   b. the static ``ServingEngine`` batches 8 concurrent 512-token
      prompts (16 new tokens) into one ``generate``: B1 launches 32 times
      (the prefill, whose SDPA gets the rope's fp32 q and k beside the
      bf16 v and computes them in fp32: every B1 launch of phase 3 is on
      the scalar kernel, and the tensor-core count, 0, says so), B4 32 x
      15 times
      (the decode steps, every one on the cluster kernel, whose count
      says so; the block kernel's count, 0, is printed); an instrumented
      pass times every forward and captures layer 0's prefill and decode
      attention inputs;
   c. ``ContinuousServingEngine(enable_ragged=False)`` serves the load of
      (a): B1 launches 32 x the prefill chunks padded to >= 128 tokens
      (scalar: they read fp32 pages back),
      B4 32 x the decode steps (all on the cluster kernel), with prefix
      hits; an instrumented pass
      times every tick and captures layer 0's inputs of a decode step and
      of a flash-sized chunk that reads back a prefix;
   e. right after (c), on the same model, the fully-int8 configuration,
      ``ContinuousServingEngine(kv_dtype="int8", weight_dtype="int8")``,
      serves the load of (a) three times, after one uncounted q-block
      pass whose engine quantises the model's 225 Linears in place (its
      wall is printed; the counted engines find none left): ragged
      q-block (B7 = 32 x ticks), ragged per-token (B9 = 32 x ticks, all
      on the cluster kernel) and
      legacy (B5 = 32 x decode steps, all on the cluster kernel, B1 = 32
      x chunks padded to >=
      128); B10 = 225 x forwards in each: layer 0's q, k and v
      projections (bf16 x, the first norm's output) on the tensor-core
      variant their M names (the stream at M <= 32, the GEMM above; the
      two counts add up to 3 x forwards), the other 222 calls a forward
      (fp32 x) on the fp32 variant their M names (the stream at M <= 64,
      the GEMM above), none on the scalar kernel; kernels 6 and 8 and B4
      never
      launch. B10's launches by M, as its wrapper counts them
      (``int8_matmul.launches_by_m``; a replay credits what its graph
      recorded), are 225 x the forwards by token count
      (``count_tick_shapes``) and printed. Prints
      the native and int8 ``page_nbytes``; instrumented passes time every
      tick and capture layer 0's inputs of B7/B9, B5 and B10 (M = 8 and
      256);
   f. right after (c), CUDA graphs against eager, bf16: the q-block,
      per-token and legacy engines each serve the load of (a) twice in
      the same order (``run_in_order``: every request queued while the
      serve loop is held, so both runs have the same ticks), once eagerly
      and once with graphs after ``warmup_programs`` captured every
      declared shape: greedy streams bit-identical, launch counts equal
      by kernel and variant (each ragged kernel 32 a tick, the decode
      kernel 32 a decode step), every tick of the graph run a replay and
      none a capture, each kernel in both traced runs' traces as many
      times as its counters say, less records the trace dropped (at most
      half; so the trace observes the replayed kernels whose counts are
      credits), and C21 (``check_c21``) on the
      engines' fixed
      q-block grid (``max_slots=8``) at every tick of the graph run, over
      layer 0's live pool. Each run takes a CUDA-only ``torch.profiler``
      trace; a marker kernel at each tick's start splits it into ticks on
      the device's clock (``split_ticks``): per tick the host's wall, the
      host's time in the forward, the device's window and busy time and
      the idle share (1 - busy / window); the eager run also the host's
      time by module (``HostBreakdown``). Then seeded sampling
      (``SAMPLED``) on the q-block engine, two graph runs and one eager
      run of the load in order, all equal, and ``abort`` under load: the
      8 requests fail with ``RuntimeError("ServingEngine aborted")``
      after the first decode tick, every slot freed, and ``start()``
      serves again on a new cache, capturing anew, the stream a fresh
      engine serves;
   g. right after (e), the same as (f) for the fully-int8 engines, and
      B10's launches by M equal in every run and 225 x the forwards by
      token count;
   d. training: Llama-3-8B widths cut to 4 layers (1.92 B parameters;
      AdamW's fp32 master weights and moments leave no room for more on
      one card), built in fp32 and made bf16 by the PaddleNLP recipe,
      ``amp.decorate(model, opt, level="O2", dtype="bfloat16")``, four
      Paddle-style steps (``loss, logits = model(ids, labels=labels)``
      under ``amp.auto_cast(level="O2", dtype="bfloat16")``,
      ``loss.backward()``, ``AdamW`` with the master weights ``decorate``
      asks for, ``ClipGradByGlobalNorm(1.0)``, warmup into cosine decay)
      on one repeated 2 x 2048-token batch: the loss finite
      and falling, B1, B2 and B3 each 4 launches a step, every one on
      the tensor-core kernels, and the optimizer the fused engine
      (``fuse_step`` on auto: 39 tensors): K-A once for each of its 2
      groups (the decayed weights, the norms), K-B twice, no eager
      dispatch; then one step with ``use_recompute``, B1 8; a step whose
      forward, backward and optimizer each run under a CUDA-only
      ``torch.profiler`` trace (device ms by kernel name); then, on one
      more backward's grads, K-B twice (the same bits) within 1e-6 of an
      fp64 sum, and K-A against its plain version (the eager loop's ops)
      on copies of layer 0's q_proj, gate_proj and norm and the final
      norm's state and a 4099-element tensor (K-A's tail), bf16 with
      masters and fp32, bit for bit, twice (the same bits); K-A over the
      step's groups and K-B over every grad timed against their byte
      bounds. Then the four steps again from the same seed with
      ``fuse_step = False`` (the eager loop; its clip sums through K-B):
      the losses within 1e-5 relative of the fused run's and every master
      weight within 1e-5 of its max. Each step timed (forward, backward,
      optimizer) with each phase's peak memory, the steady step's peak
      accounted by category (weights, grads, masters, moments, logits,
      the rest), with tokens/s; the fused run's last step's layer-0
      attention inputs and dO are captured;
   h. right after (f), speculative decoding (``spec_full_width``): the
      load of (a) in order on the q-block engine with graphs, spec off,
      then ``spec_k=4`` with the n-gram drafter and with a two-layer
      draft model at full width (seed 1), each plainly and traced: verify
      ticks replay the declared buckets' graphs (no capture, a replay a
      tick), kernel 6 32 times a tick, every rejected draft rolled back;
      drafted and accepted tokens, target forwards per generated token,
      the replayed forwards' device ms by token bucket, busy ms and idle
      share, tokens/s, and whether the streams equal spec off's (at the
      first difference, the logits gap between the verify position and
      the same position decoded alone: ROADMAP C23, reported, not held);
   i. right after (g), the same fully int8;
   k. right after (h), serving under ``amp.auto_cast(level="O2",
      dtype="bfloat16")``, the reference's recipe for 16-bit serving
      (``amp_serving``): the q-block, per-token and legacy engines on the
      load of (a) and the static engine on (b)'s, counted, with every
      attention launch a ``<bf16, float>`` one (kernels 6, 8 and 4: the
      cached attention op casts q alone, the pools stay fp32, C29;
      ``*_mixed`` counts) and the legacy and static prefills on the
      tensor-core B1 (SDPA casts q, k and v to bf16); pools fp32 and
      logits bf16 (``check_c25``); the q-block engine under O1 bf16 (q
      stays fp32: the fp32 variants); eager instrumented q-block and
      legacy passes capture layer 0's inputs (bf16 q over fp32 pages) and
      count ``amp.promote``'s weight copies (``PromoteCounter``: none
      under O2); the q-block engine's replayed ticks, plain and traced
      (tokens/s, decode and mixed tick ms, busy ms, idle share, device ms
      by kernel); the graph keys (``amp_graph_keys``: one engine's
      one-token bucket captured outside and inside O2, fp32 logits
      outside and bf16 inside); then each new variant, the rule's and
      the other forced, in bf16 and fp16, bit-equal to its fp32 variant
      on the upcast q, within one ulp plus 1e-5 of the max of the plain
      version (``hold_mixed``), C21 over the fp32 pages
      (``check_c21(mixed=True)``), and timed on the captured mixed and
      pure-decode ticks and decode step. After (i), the fully-int8
      engines under O2 (``amp_serving_int8``): the int8 Linear is the
      reference's op ``"int8_linear"``, so all 225 B10 calls a forward
      take bf16 x on the tensor-core variants by M and none the fp32
      ones;
   j. right after (d), ``paddle.amp`` on the training step at the same
      widths and batch, each step's launch counts zeroed before and held
      after, and a step the scaler skips held to leave the watched
      parameters, masters, moments and step counts as they were: (a) O2
      fp16 (``decorate``, ``auto_cast``) with a default ``GradScaler``,
      4 steps: B1, B2, B3 on the tensor-core kernels, K-A once a group and
      K-B twice on each step taken, none on a skipped one; the scale
      after each step; (b) O1 fp16 on fp32 parameters with a
      ``GradScaler``, 2 steps: the rope's fp32 q and k beside fp16 v take
      B1, B2, B3's scalar fp32 kernels (as the reference's Pallas kernel
      casts all three to fp32); (c) a bf16 model without AMP (``.to``),
      one step at 2 layers: fp32 logits, the scalar flash kernels (C24);
      each with times and peaks; (d) two layers, fp32 parameters: the
      dtype trace (``amp.debugging.collect_operator_stats``) under O1
      fp16 and O2 bf16 at 16 tokens (the dense route) and 128 (flash)
      equal op by op to the same model's on the CPU (whose trace
      ``tests/test_torch_amp.py`` holds to the reference's); then O2
      fp16 with a ``GradScaler`` over 4 steps of one 512-token sequence,
      inf and nan planted in a grad at steps 1 and 2: exactly those
      skipped, the card's unscale (PyTorch's multi-tensor pass) bit for
      bit ``(g.float() * inv).to(g.dtype)``, and the fused run's losses
      and master weights equal to the eager run's (C22; within 1e-5,
      bit-equality printed);
4. paths against each other on a two-layer fp32 model at the same widths
   (TF32 off): ``generate`` over the concat and the paged cache, the
   legacy engine and the ragged engine on both grids (q-block and
   per-token) give identical greedy streams on three
   prompts (47, 300 and 160 tokens); the ragged forward and ``generate``'s
   paged cache give logits within 1e-4 (relative) of the cache-free
   forward; one training step's loss and every gradient through the
   kernels within 1e-6 and 1e-4 (relative) of the same step with SDPA
   swapped, for the check only, to dense attention in autograd; the
   fully-int8 engine's three schedulers give identical greedy streams on
   the three prompts; (b) the q-block engine at pages of 8 and 32
   (native) and 8 and 64 (int8 KV pages) on the load of (a) in order,
   with graphs: greedy streams equal to page 16's and ``generate``'s,
   kernel 6 / B7 twice a tick by the variant the rule takes (the runtime
   kernel at fp32 pages of 32 and int8 pages of 64); (d) self-speculation
   (``draft_model=`` the target) and (e) an always-wrong drafter on eight
   short prompts: streams equal spec off's and ``generate``'s,
   acceptance > 0.9 with fewer target forwards than tokens, every wrong
   draft rolled back; every B1, B2, B3 and B10 launch of this phase takes
   the scalar fp32 kernels (their launches are the scalar variants'
   main-path counts, and the tensor-core counts stay 0); then every
   kernel against its
   plain version (phase 2's rules) on the inputs captured in phase 3,
   the ragged kernels at both captured ticks (the largest mixed one and
   the pure-decode one with the most tokens), native and int8;
5. timing (CUDA events, median over 50 launches with L2 flushed between
   them and the device then held in a short spin, so that each launch is
   queued before its start event and the time is the device's) of every
   kernel, its plain version and, where one PyTorch call
   computes the same function, that call, beside the bound for the same
   work, all on the inputs captured in phase 3: the ragged kernels at
   the captured mixed and pure-decode ticks (``time_ragged``; a q-block
   row is the engines' fixed grid, its output held bit-equal to the
   live-units grid's, whose time it carries beside, and the per-token
   kernel's time on the same inputs; kernel 8
   and B9 as the rule's cluster kernel beside the block kernel, the
   parent's design, forced on the same inputs, and at the pure-decode
   tick the cluster kernel at every split count), B1: the scalar kernel
   at the static prefill and the legacy chunk (the serving paths' fp32
   inputs since C25) and on fp32 copies of the training step's inputs,
   the tensor-core kernel at the training step with its TFLOP/s over
   visible pairs and the host's time per call, and on bf16 copies of the
   serving captures; B2 and B3 at the training step (tensor cores, with TFLOP/s
   over visible pairs, against SDPA's backward, whose kernels a profiler
   trace names; and the scalar kernels on fp32 copies of the same
   inputs, against SDPA's fp32 backward), B4 at each engine's
   decode step, B7 and B9 at the two int8 ticks, B5 at the int8 legacy decode
   step (B4 and B5 as the rule's cluster kernel, beside the block kernel,
   the parent's design, forced on the same inputs, and the cluster kernel
   under other splits), B10 at M = 8 and 256 for each weight shape on the
   captured x (bf16 at layer 0's q, k and v projections, fp32 elsewhere;
   with GB/s or TFLOP/s, against ``torch.matmul`` on the layer's
   dequantised weight in x's dtype, the host's time per call of both;
   on fp32 copies the fp32 variant against its fp32 bound, fp32
   ``torch.matmul`` and the scalar kernel; summed over one forward),
   both tensor-core B10 variants at M = 16-64 and both fp32 ones at M =
   48-96 (their crossovers) and the tensor-core stream at M = 8 under
   split plans for 0.5, 1 and 2 blocks an SM; the serving numbers of
   every path, the
   legacy and ragged ones from uninstrumented runs, the int8 ones from
   the runs of 3e (instrumented only by B10's M histogram), and the
   training step's;
6. tick breakdown of the ragged engines: per tick of the instrumented
   passes, the forward, the schedule build and the attention calls, and
   both ragged kernels replayed at every tick shape (kernel 6 on the
   engines' fixed grid), with C21 held there
   on a random q over layer 0's pool and over that pool quantised by the
   cache's codec;
7. the ops layer (``paddle_tpu_torch.ops``) on the card (``ops_phase``):
   with the default device creation and random ops land on CUDA, the
   CUDA generator reproduces a stream after the same ``seed`` and not
   after another, torch's global RNG untouched; ``OPS_SAMPLE`` (83 ops
   of the five modules, seeded numpy inputs) on CUDA tensors against the
   same calls on CPU tensors: dtypes and shapes equal, floats within
   1e-5 of the CPU result's largest magnitude (TF32 off), the rest
   exact;
8. the nn surface and PaddleClas ResNet-50 (``nn_phase``): (a) every
   case of the CPU tests' functional table (``tests/torch_nn_cases.py``,
   all 111 registry functional ops and 7 aliases) on CUDA tensors
   against CPU tensors, forward and gradients (1e-5 and 1e-4 of the
   CPU's largest magnitude, TF32 off; dtypes, shapes and integers
   exact); (b) ResNet-50 with 10 classes: one fp32 training step at
   batch 8 stage by stage against the CPU and an fp64 copy (outputs,
   loss, gradients, BN statistics), then bench.py's configuration, batch
   256 of 3 x 32 x 32 images, 20 steps of PaddleClas's recipe
   (``decorate`` O2 bf16 with fp32 BatchNorms, ``auto_cast``, Momentum
   0.9 with L2Decay 1e-4 on fp32 masters) on one seeded batch: the loss
   finite and falling, the O2 dtype trace equal to the CPU's, no port
   kernel launched; it prints images/s, the forward, backward and
   optimizer ms, the peak memory and the device ms by kernel of one
   step beside the card's name and power limit;
9. the training-loop surface (``loop_phase``): (a) the Llama recipe of
   phase 3d (4 layers at Llama-3-8B widths, 2 x 2048 tokens, O2 bf16,
   fused AdamW with the global-norm clip) on batches of a seeded token
   set through ``paddle.io.DataLoader`` (``DistributedBatchSampler``, one
   replica, shuffled, two workers), its forward under
   ``paddle.jit.to_static`` (one compile, then hits), 1 + LOOP_STEPS
   steps, then the same steps eagerly: B1-B3 (tensor cores) launched
   once a layer a step in both, the loss curves within LOOP_O2_RTOL at
   every step, no attention kernel but the port's in a traced step; a
   two-layer fp32 copy (TF32 off) compiled against eager, the loss within
   1e-5 and every gradient within 1e-4 of the largest; (b) PaddleClas's
   ResNet-50 recipe (the network cut to HAPI_BLOCKS bottleneck blocks a
   stage) through ``paddle.Model.fit`` (Momentum 0.1/0.9,
   L2Decay 1e-4, top-1 and top-5 ``Accuracy``; fp32) over a seeded
   in-memory CIFAR-shaped set (``DataLoader``, batch 256, shuffled,
   ``drop_last``, four workers), HAPI_ITERS steps eager and with the
   network under ``to_static``: the first step's loss against a
   hand-written step on the same batch (1e-6 eager, 1e-4 compiled),
   ``evaluate``'s accuracy against the one from ``predict``'s logits; it
   prints compile seconds, step ms (compiled against eager), images/s,
   idle shares of traced steps, peak memory and the loader's wait per
   step;
11. the language-model zoo (``zoo_phase``): (a) GPT-3-1.3B at full
   depth: in fp32 ``generate`` on the paged cache against the q-block and
   per-token engines in order (those two equal, C21; generate's streams
   equal or leaving at a near-tie); under O2 bf16 (a bf16 GPT serves on
   bf16 pages: no rope) both engines with CUDA graphs on eight prompts of
   128-600 tokens, the replayed ticks, and ``generate`` on the paged and
   the dense caches, every launch counted by variant (B1 ``bfloat16 d128
   g1 causal``, kernels 4, 6 and 8 ``<bf16, bf16>``); layer 0's captured
   inputs of B1, B4 and kernels 6 and 8 held against their plain versions
   and timed; O2 AdamW steps at 2 x 2048 (B1-B3 at group 1, K-A; the step
   time the median of ZOO_COUNTED_STEPS), layer 0's captured q, k, v and
   dO of a step holding B1, B2 and B3 against their plain versions; 2
   layers in fp32 against the port on the CPU (logits, gradients, the
   first update of every element); (b) Mixtral-8x7B widths at 2
   layers: fp32 logits on 64 tokens against the CPU, layer 0's routing on the captured states (flips only
   at gaps the router logits' difference spans), ``generate`` on the
   paged cache and the q-block engine with graphs under O2, one O2 step
   at 1 layer; (c) BERT-base: six AdamW steps at 32 x 128 with a padding
   mask at 2 layers of full width (the depth cut to keep the run inside
   its time), compiled (``jit.to_static``) and eager, the losses within the
   reference test's rtol 2e-4 / atol 2e-5, an eval at 8 x 512 without a
   mask (B1 non-causal at d 64, fp32 and O1 bf16) held and timed; (d) T5
   (t5-small widths) fp32 logits and greedy ``generate`` against the
   CPU. Prints a ``{"zoo": ...}`` line;
12. the vision zoo, PP-YOLOE and the RNNs (``vision_phase``): (a)
   ViT-B/16 at full width, O2 AdamW steps at batch 64 on ``DataLoader``
   batches (B1-B3 non-causal at ``bfloat16 d64 g1 full``, 197 tokens, the
   last key tile ragged; the median of five steps, its split, peak
   memory, a traced step's idle share), the O2 eval's images/s at batch
   128, layer 0's captured q, k, v and dO holding B1, B2 and B3 to C15 /
   C17 in bf16 and fp16 and timed against SDPA, and 2 layers in fp32
   against the CPU; (b) PP-YOLOE (80 classes, width 32, neck 96) at 640
   x 640: fp32 AdamW steps at batch 8 on batches from four ``DataLoader``
   workers running the example's augmentation (the loop's waits,
   images/s, idle share), ``predict`` on two images with NMS's kept set
   equal to the CPU's on the same arrays, one fp32 step against the CPU
   by phase 8's rule; (c) LeNet, VGG-16, AlexNet, SqueezeNet 1.1,
   MobileNet V1 / V2 / V3-Large, ShuffleNetV2, DenseNet-121, GoogLeNet
   (auxiliary heads on) and InceptionV3 (299 x 299): one fp32 training
   step at batch 2 against the CPU by phase 8's rule, on PyTorch's own
   CUDA convolutions and on cuDNN's, O2 eval images/s at batch 64; (d) a 2-layer bidirectional LSTM, a GRU and a SimpleRNN
   (512 wide, batch 64, 128 steps, ragged lengths) against the CPU within
   1e-5 of each tensor's largest, forward and backward ms; (e) the vision
   ops against the CPU. Prints a ``{"vision": ...}`` line;
13. Hugging Face checkpoints, the spectral features, the data pipeline
   and Viterbi decoding (``pretrained_phase``): (a) checkpoints this
   script writes with its own safetensors writer under ``TMPDIR``:
   Llama-3-8B widths at 2 layers in bf16, two shards and an index,
   through ``LlamaForCausalLM.from_pretrained(dtype="bfloat16")``
   against the same model set directly from the tensors: parameters,
   O2 logits, O2 ``generate`` on the paged cache (B1 ``bfloat16 d128
   g4 causal``, kernel 4 ``<bf16, float>``) and the O2 q-block engine
   with CUDA graphs (kernel 6 ``<bf16, float>``), each bit for bit, the
   load's GB/s and the first token after it; layer 0's captures of the
   loaded model holding B1, B4 and kernel 6 to their plain versions,
   timed; GPT-2's layout at GPT-3-1.3B widths (2 layers; fp32 logits and
   an O2 paged ``generate``), BERT-base (its 8 x 512 eval, B1 fp32 d 64)
   and T5-v1.1-small (logits, greedy ``generate``) the same way; (b)
   ``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram`` and
   ``MFCC`` on 16 clips of 10 s at 16 kHz, ``stft`` -> ``istft`` and
   the 22 ``fft`` functions on [64, 4096], each against the CPU within
   1e-5 of its largest and timed; (c) a CIFAR-10 tarball through
   ``Cifar10`` and PaddleClas's train transforms in four ``DataLoader``
   workers into O2 ResNet-18 steps at 256 (images/s, the loop's wait;
   the first batch equal to a CPU loader's under the same seed); (d)
   ``viterbi_decode`` at [64, 128, 50] against the CPU (paths equal).
   Prints a ``{"pretrained": ...}`` line;
14. ``geometric``, ``sparse`` and ``distribution`` (``phase14``; no
   kernel of the table runs here: these modules run PyTorch's and
   cuSPARSE's / cuDNN's calls, as the reference runs XLA's): (a) OGB's
   GCN (3 layers, hidden 256, dropout 0.5) on an ogbn-arxiv-sized graph
   (169,343 nodes, 1,166,243 edges from a seed with skewed degrees, plus
   self loops), aggregating by ``geometric.send_ue_recv`` and by
   ``sparse.matmul`` on the CSR adjacency: both routes' logits and
   first-step gradients against the CPU's fp32 and an fp64 run by phase
   8's rule, Adam steps a route, and ``send_u_recv`` sum / mean / max,
   ``send_ue_recv``, ``send_uv`` held and timed; (b) sparse attention
   over BigBird-base's pattern (blocks of 64, 3 sliding, 2 global, 3
   random, 12 heads of 64) timed at 4096 tokens beside SDPA with the same
   boolean mask, held against the CPU at 1024; (c) SECOND's
   ``SubmConv3D`` and stride-2 ``Conv3D`` (4 -> 16, kernel 3) on KITTI's
   [41, 1600, 1408] grid with 16,000 voxels, weights carried from the
   CPU, timed, and held against the CPU on [41, 200, 176] at the same
   occupancy (patterns equal); (d) Categorical over 128,256 tokens at
   batch 64, a 256-dim MultivariateNormal at batch 1024, the Gamma, Beta
   and Dirichlet reparameterised gradients at 4096 x 64, a SAC
   tanh-Normal head, every KL pair: deterministic functions against the
   CPU, sample moments within 5 standard errors. Prints a
   ``{"graph_sparse_distribution": ...}`` line.

Prints a ``{"graph_breakdown": ...}`` line (phases 3f and 3g, per engine
and mode), a ``{"spec": ...}`` line (3h, 3i, 4(d), 4(e)), an
``{"amp": ...}`` line (3j), an ``{"amp_serving": ...}`` line (3k), an
``{"ops": ...}`` line (phase 7), an ``{"nn": ...}`` line (phase 8), a
``{"loop": ...}`` line (phase 9; B1-B3's rows below count its launches), a
``{"zoo": ...}`` line (phase 11; its launches and timed shapes go into
the rows of B1-B4, kernels 6 and 8 and K-A/K-B), a ``{"vision": ...}``
line (phase 12; B1-B3's and K-A's rows count its launches, B1-B3's
carry ViT's timed shape under ``vit_shapes``), a ``{"pretrained":
...}`` line (phase 13; B1's, B4's and kernel 6's rows count its
launches and carry the loaded Llama's timed shapes under
``pretrained_shapes``), a ``{"graph_sparse_distribution": ...}`` line
(phase 14), a
``{"kernels": [...]}`` line with all ten TPU kernels (kernel 6 and B7
also as their runtime variants, with launches by variant and path) and the
fused optimizer step's two (K-A and K-B, no Pallas counterpart,
``"pallas": false``; B1, B2 and B3
each as its two variants, B10 as its three, with the dtypes each
serves; kernel 8, B9, B4 and B5 as the cluster kernels the main paths
run, the block kernels under ``block_variant``; kernels 6, 8 and 4 also
as their ``<16-bit, float>`` variants, ``*_mixed``), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import ctypes
import gc
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import types
from collections import Counter

import numpy as np

N_HEADS, N_KV, HEAD_DIM, PAGE = 32, 8, 128, 16
N_LAYERS = 32
#: the least share of a kernel's counted launches a CUDA trace must show
#: (traces have dropped up to 7 % of a kernel's records)
TRACE_KEEPS = 0.5
N_LINEARS = 7 * N_LAYERS + 1       # the quantised Llama's, lm_head included
#: the Linears that see bf16 activations in the bf16 model: layer 0's q,
#: k and v projections (every later one sees fp32, ROADMAP C24/C25)
BF16_LINEARS = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
FP32_TOL = 1e-5
NEW_TOKENS = 16
#: the engines' slots: the q-block kernels' fixed grid takes at most
#: this many owners a q-block
ENGINE_SLOTS = 8
#: the training phase: Llama-3-8B widths cut to 4 layers (AdamW with fp32
#: master weights and moments needs ~16 B a parameter: 32 layers, 8.0 B
#: parameters, would need ~128 GB; 4 layers, 1.92 B, ~31 GB)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 2048, 4
#: the fused optimizer's groups in a training step (K-A launches): the
#: decayed weights, and the norms
TRAIN_GROUPS = 2
CSRC = "paddle_tpu_torch/csrc/"
SOURCE = CSRC + "ragged_paged_attention.cu"
QBLOCK_SOURCE = CSRC + "qblock.cuh"
REF = "paddle_tpu/ops/pallas/ragged_paged_attention.py"


_T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(title):
    """A phase's heading, with the seconds since the script started."""
    log(f"{title} [{time.perf_counter() - _T0:.0f} s]")


def max_err(a, b, rows):
    return float((a[rows].float() - b[rows].float()).abs().max())


def check(name, err, tol, what="max_abs_err"):
    log(f"  {name}: {what} {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")


def ulp_err(torch, out, ref32, tol=FP32_TOL):
    """A bf16 or fp16 kernel output against its fp32 plain version on the
    same (rounded) inputs, rounded to the dtype: the kernel accumulates in
    fp32 like the plain version, so before its one rounding it lies within
    ``tol`` (FP32_TOL, or 1e-5 of the plain version's max) of it, and both
    roundings add at most one ulp of the reference (fp16's no less than
    its subnormal spacing). The allowance per element is therefore
    ``ulp(ref) + tol``. Returns (max abs error, max error / allowance);
    the rule holds at <= 1."""
    name = str(out.dtype).split(".")[-1]
    ref = ref32.to(out.dtype).float()
    ulp = torch.ldexp(torch.ones_like(ref),
                      torch.frexp(ref).exponent - ULP_BITS[name])
    if name == "float16":
        ulp = ulp.clamp_min(FP16_TINY)
    diff = (out.float() - ref).abs()
    return float(diff.max()), float((diff / (ulp + tol)).max())


def span_rows(q_starts, q_lens):
    return np.concatenate([np.arange(s, s + n)
                           for s, n in zip(q_starts, q_lens)])


def ptxas_summary(build):
    """Registers and spill bytes of every kernel instantiation, from the
    ``ptxas -v`` lines in each library's build log (dynamic shared memory
    is the launch's own, not in the log). Names are demangled with
    ``c++filt`` where the machine has it."""
    import re
    import shutil
    rows = []
    for source in build.SOURCES:
        log_path = build._target(source)[1].with_suffix(".log")
        entry, spills = None, ""
        for line in log_path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                rows.append((source, entry, m.group(1), spills))
                entry = None
    names = [r[1] for r in rows]
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(rows):
            names = [re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", n)
                     for n in out.stdout.splitlines()]
    for (source, _, regs, spills), name in zip(rows, names):
        log(f"  ptxas {source}: {name} {regs} registers, {spills}")


def wgmma_smem(d, nwg, src):
    """Dynamic shared memory of one tensor-core B1 block, as ``TcSmem<D,
    NWG>::kBytes`` in ``src`` (the text of ``flash_attention.cu``) lays it
    out: Q's 64-column boxes, a ring of K and V tiles, the mbarriers and
    1 KB of alignment slack."""
    import re
    tile_k, stages = (int(re.search(rf"constexpr int {name} = (\d+);",
                                    src).group(1))
                      for name in ("kTileK", "kStages"))
    boxes = d // 64
    return (boxes * nwg * 64 * 128 + 2 * stages * boxes * tile_k * 128
            + (1 + 3 * stages) * 8 + 1024)


def b1_notes(build):
    """The tensor-core B1's launch shape and dynamic shared memory per
    instantiation, and ptxas's notes on its wgmma (injected fences,
    serialised products)."""
    import re
    src, so = build._target("flash_attention.cu")
    for d in (64, 128):
        for nwg in (1, 2):
            log(f"  flash_fwd_wgmma_kernel d={d}, {nwg} consumer "
                f"warpgroup(s) + 1 producer: {(nwg + 1) * 128} threads, "
                f"{wgmma_smem(d, nwg, src.read_text())} bytes of dynamic "
                f"shared memory" + (", setmaxnreg 240 consumer / 24 producer"
                                    if nwg == 2 else ""))
    log_path = so.with_suffix(".log")
    for line in log_path.read_text().splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:the )?function '.*?"
                      r"flash_fwd_wgmma_kernelI(\w+?)Li(\d+)ELi(\d)E", line)
        if m:
            log(f"  ptxas {m.group(1)} flash_fwd_wgmma_kernel<"
                f"{re.sub(r'^[0-9]+', '', m.group(3))}, "
                f"{m.group(4)}, {m.group(5)}>: {m.group(2)[:120]}")


def bwd_smem(d, nwg, dkv, src):
    """Dynamic shared memory of one tensor-core B2 (``dkv`` False) or B3
    block, as ``TcBwdSmem`` in ``src`` (the text of
    ``flash_attention_bwd.cu``) lays it out: the two resident operands
    (NWG * 64 rows), the ring of the two streamed 64-row tiles (B3's
    stages also hold the tile's lse and delta rows), the mbarriers and 1
    KB of alignment slack."""
    import re
    tile, stages = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
                    for name in ("kTcTile", "kTcStages"))
    boxes = d // 64
    return (2 * boxes * nwg * 64 * 128 + 2 * stages * boxes * tile * 128
            + stages * (2 * tile * 4 if dkv else 0) + (1 + 2 * stages) * 8
            + 1024)


def bwd_notes(build):
    """The tensor-core B2 and B3's launch shape and dynamic shared memory
    per instantiation, and ptxas's notes on their wgmma."""
    import re
    src, so = build._target("flash_attention_bwd.cu")
    text = src.read_text()
    for kernel, dkv in (("flash_bwd_dq_wgmma_kernel", False),
                        ("flash_bwd_dkv_wgmma_kernel", True)):
        for d in (64, 128):
            for nwg in (1, 2):
                log(f"  {kernel} d={d}, {nwg} consumer warpgroup(s) + 1 "
                    f"producer: {(nwg + 1) * 128} threads, "
                    f"{bwd_smem(d, nwg, dkv, text)} bytes of dynamic shared "
                    f"memory" + (", setmaxnreg 240 consumer / 24 producer"
                                 if nwg == 2 else ""))
    notes = 0
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:the )?function '.*?"
                      r"(flash_bwd_dk?v?q?_wgmma_kernel)I(\w+?)Li(\d+)"
                      r"ELi(\d)E", line)
        if m:
            notes += 1
            log(f"  ptxas {m.group(1)} {m.group(3)}<"
                f"{re.sub(r'^[0-9]+', '', m.group(4))}, {m.group(5)}, "
                f"{m.group(6)}>: {m.group(2)[:120]}")
    log(f"  ptxas wgmma notes for B2/B3: {notes}")


#: the tensor-core B10's instantiations: (token tile, consumer warpgroups)
B10_TILES = ((8, 1), (16, 1), (32, 1), (128, 2))


def b10_smem(mt, nwg, src):
    """Dynamic shared memory of one tensor-core B10 block, as ``MmSmem<MT,
    NWG>::kBytes`` in ``src`` (the text of ``quant_matmul.cu``) lays it
    out: a ring of [weight box, two x boxes], the mbarriers and 1 KB of
    alignment slack."""
    import re
    tk, stages = (int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
                  for name in ("kTK", "kStages"))
    return stages * (nwg * 64 * tk + 2 * mt * 128) + 2 * stages * 8 + 1024


def b10_notes(build):
    """The tensor-core B10's launch shape and dynamic shared memory per
    instantiation, and ptxas's notes on its wgmma; the fp32 kernels'
    shared memory (their registers and spills are in the ptxas
    summary)."""
    import re
    from paddle_tpu_torch.ops.quant_matmul import split_plan as qm_plan
    src, so = build._target("quant_matmul.cu")
    text = src.read_text()
    for mt, nwg in B10_TILES:
        log(f"  int8_matmul_wgmma_kernel token tile {mt}, {nwg} consumer "
            f"warpgroup(s) + 1 producer warp: {nwg * 128 + 32} threads, "
            f"{b10_smem(mt, nwg, text)} bytes of dynamic shared memory")
    notes = 0
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:the )?function '.*?"
                      r"int8_matmul_wgmma_kernel", line)
        if m:
            notes += 1
            log(f"  ptxas {m.group(1)} int8_matmul_wgmma_kernel: "
                f"{m.group(2)[:120]}")
    log(f"  ptxas wgmma notes for B10: {notes}")
    # the fp32 kernels: the stream's block (the weight ring, the part's x
    # slice, barriers, alignment slack) at each Llama-3-8B weight and the
    # token tiles of the M the engines use, as the C side computes it
    # and as this script does from the source's constants; the GEMM's
    lib = build.load_kernels()
    stages, tk = (int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
                  for name in ("kFStages", "kTK"))
    for k, n in MATMUL_SHAPES:
        for m in (8, 64):
            mt, _, splits, tpp = qm_plan("fp32_stream", m, n, k)
            got = lib.ptt_int8_matmul_fp32_smem(0, mt, tpp)
            want = stages * 128 * tk + mt * tpp * tk * 4 + 2 * stages * 8 \
                + 1024
            log(f"  int8_matmul_fp32_stream_kernel K={k} N={n} M={m}: token "
                f"tile {mt}, {splits} parts of {tpp} k-tiles, 288 threads, "
                f"{got} bytes of dynamic shared memory")
            if got != want or got > 232448:
                raise AssertionError(f"fp32 stream shared memory {got}, "
                                     f"expected {want} within 232448")
    log(f"  int8_matmul_fp32_gemm_kernel: 256 threads, "
        f"{lib.ptt_int8_matmul_fp32_smem(1, 128, 1)} bytes of dynamic "
        f"shared memory")


def qblock_notes(build, rpa):
    """The q-block kernels' (6 and B7) launch shape and dynamic shared
    memory at Llama-3-8B widths (32 heads over 8 kv heads, head_dim 128,
    page 16, q-block 8, tables of 128 pages) for each page type, and the
    fixed grid the engines launch (8 slots): its units and job width at
    the 8- and 256-token buckets. The units' page lists take min(J,
    table width) ints, so the fixed job width costs no shared memory."""
    lib = build.load_kernels()
    for b in (8, 256):
        u_max, j_max = rpa.qblock_caps(b, 8, 8, 128)
        log(f"  qblock_unit_kernel fixed grid at a {b}-token bucket: "
            f"{u_max} x {N_KV} blocks, {j_max} jobs a q-block")
    for name, el in (("fp32 pages", 4), ("bf16/fp16 pages", 2),
                     ("int8 pages (B7)", 1)):
        for page in rpa.UNIT_PAGE_SIZES:
            pps = -(-2048 // page)
            smem = lib.ptt_ragged_qblock_smem(el, N_HEADS, N_KV, HEAD_DIM,
                                              page, 8, 8 * pps, pps)
            want = rpa.unit_smem_bytes(el, el == 1, 8 * N_HEADS // N_KV,
                                       page, HEAD_DIM, 8, pps)
            if smem != want:
                raise AssertionError(f"unit shared memory {smem} != {want}")
            log(f"  qblock_unit_kernel<{page}>, {name}: 256 threads, "
                f"{smem} bytes of dynamic shared memory")
    plan = (ctypes.c_int * 3)()
    for page, d, _ in PAGE_SHAPES:
        smem = lib.ptt_ragged_qblock_rt_smem(N_HEADS, N_KV, d, page, 8, plan)
        if not smem:
            raise AssertionError(f"no runtime q-block plan at page {page}, "
                                 f"head_dim {d}")
        log(f"  qblock_runtime_kernel, page {page}, head_dim {d}: 256 "
            f"threads, {plan[0]} rows a pass, chunks of {plan[1]} pages, "
            f"{plan[2]} keys a run, {smem} bytes of dynamic shared memory")


def token_notes(build, rpa):
    """The cluster kernel 8/B9's launch at Llama-3-8B's ragged ticks (32
    heads over 8 kv heads, head_dim 128, page 16, the engine's 128-page
    tables) on this card's SMs, for the mixed tick's 256 tokens and a
    pure-decode tick's 8: the splits (the cluster's blocks), the pages a
    block takes a round and the dynamic shared memory of a block for each
    page type, from the C library, held equal to the wrapper's formula."""
    lib = build.load_kernels()
    n_sm = rpa._sm_count(0)
    for tokens in (256, 8):
        splits = rpa.token_splits(tokens, N_KV, 128, n_sm)
        for name, el, quant in (("fp32 pages", 4, 0), ("bf16/fp16 pages", 2, 0),
                                ("int8 pages (B9)", 1, 1)):
            args = (el, bool(quant), N_HEADS // N_KV, HEAD_DIM, 128, splits)
            smem = lib.ptt_ragged_token_split_smem(
                el, quant, N_HEADS // N_KV, PAGE, HEAD_DIM, 128, splits,
                rpa.token_round_pages(splits))
            if smem != rpa.token_smem_bytes(*args):
                raise AssertionError(f"token split shared memory {smem} != "
                                     f"{rpa.token_smem_bytes(*args)}")
            log(f"  token_split_kernel, {name}, {tokens} tokens: 128 "
                f"threads, clusters of {splits} on {n_sm} SMs, "
                f"{rpa.token_round_pages(splits)} pages a block a round, "
                f"{smem} bytes of "
                f"dynamic shared memory")


def paged_notes(build, pa):
    """The cluster B4/B5 kernel's launch at Llama-3-8B's decode (batch 8,
    32 heads over 8 kv heads, head_dim 128, page 16) on this card's SMs,
    for the static engine's 33-page and the legacy cache's 128-page tables:
    the splits (the cluster's blocks), the ring's stages and the dynamic
    shared memory of a block for each page type, from the C library, held
    equal to the wrapper's formula."""
    lib = build.load_kernels()
    n_sm = pa._sm_count(0)
    for pps in (33, 128):
        splits = pa.paged_decode_splits(8, N_KV, pps, n_sm)
        for name, el, quant in (("fp32 pages", 4, 0), ("bf16/fp16 pages", 2, 0),
                                ("int8 pages (B5)", 1, 1)):
            args = (el, bool(quant), N_HEADS // N_KV, HEAD_DIM, pps, splits)
            stages = pa.split_stages(*args)
            smem = lib.ptt_paged_decode_split_smem(el, quant, *args[2:],
                                                   stages)
            if smem != pa.split_smem_bytes(*args, stages):
                raise AssertionError(f"split shared memory {smem} != "
                                     f"{pa.split_smem_bytes(*args, stages)}")
            log(f"  paged_decode_split_kernel, {name}, {pps}-page tables: "
                f"128 threads, clusters of {splits} on {n_sm} SMs, "
                f"{stages} stages, {smem} bytes of dynamic shared memory")


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
        eb, ulps = ulp_err(torch, ob[rows], rb[rows])
        log(f"  {label} {impl} bf16 kernel vs bf16(fp32 plain): "
            f"max_abs_err {eb:.3e}")
        check(f"{label} {impl} bf16 kernel vs bf16(fp32 plain)", ulps,
              1.0, "max error / (1 bf16 ulp + fp32 tol)")
        errs[impl] = {"fp32": e32, "bf16": eb}
    torch.cuda.synchronize()
    check(f"{label} qblock vs token kernel fp32",
          max_err(out32["qblock"], out32["token"], rows), FP32_TOL)
    check_c21(torch, rpa, q, (kp, vp), plans, rows, label)
    errs["token_variants"] = compare_token_variants(
        torch, rpa, q, (kp, vp), plans["token"], rows, label)
    return errs, plans


def compare_token_variants(torch, rpa, q, pages, plan, rows, label):
    """Kernel 8 (native pages ``(k, v)``, cast with q) or B9 (``(k_codes,
    v_codes, k_scales, v_scales)``), both variants, the ``"cluster"`` the
    rule takes here (asserted) and the ``"block"``, each forced: in fp32
    (TF32 off) against the plain version (1e-5), in bf16 and fp16 against
    the fp32 plain version on the rounded inputs, rounded (``ulp_err`` <=
    1), on the span rows; each forced launch adds one to its variant's
    count; the cluster kernel twice in bf16 gives the same bits. Returns
    the largest errors as ``{variant}_{dtype}``."""
    quant = len(pages) == 4
    fn = rpa.token_attention_q8 if quant else rpa.token_attention
    kernel = "B9" if quant else "kernel 8"
    scale = HEAD_DIM ** -0.5
    rule = rpa.token_variant(q, *pages[:2], plan.dev["tables"].shape[1],
                             rpa._sm_count(q.device.index), *pages[2:])
    if rule[0] != "cluster":
        raise AssertionError(f"{label} {kernel}: the rule took {rule}")
    errs = {}
    for variant in rpa.TOKEN_VARIANTS:
        for short, name in PAGED_DTYPES.items():
            dt = getattr(torch, name)
            qd = q.to(dt)
            pd = pages if quant else tuple(p.to(dt) for p in pages)
            before = getattr(fn, f"{variant}_launches")
            out = fn(qd, *pd, plan, scale, variant=variant)
            if getattr(fn, f"{variant}_launches") != before + 1:
                raise AssertionError(f"{label} {kernel}: {variant} not "
                                     f"counted")
            ref = rpa.token_attention_plain(
                qd.float(), *(pd[:2] if quant else (p.float() for p in pd)),
                plan, scale, *pd[2:])
            if out.dtype != dt:
                raise AssertionError(f"{label} {kernel}: {out.dtype} out")
            what = f"{label} {kernel} {variant} {short}"
            if short == "fp32":
                e = max_err(out, ref, rows)
                check(f"{what} kernel vs plain", e, FP32_TOL)
            else:
                e, ratio = ulp_err(torch, out[rows], ref[rows])
                check(f"{what} kernel vs {short}(fp32 plain)", ratio, 1.0,
                      "max error / (1 ulp + fp32 tol)")
            errs[f"{variant}_{short}"] = e
            if variant == "cluster" and short == "bf16":
                again = fn(qd, *pd, plan, scale, variant=variant)
                if not torch.equal(out.view(torch.int16),
                                   again.view(torch.int16)):
                    raise AssertionError(f"{what}: two launches differ")
                log(f"  {what} twice: bit-identical")
    torch.cuda.synchronize()
    return errs


@contextlib.contextmanager
def forced_token_splits(rpa, splits):
    """Inside the block, the cluster kernel 8/B9 splits every (token, kv
    head) over ``splits`` blocks (None: the rule's): the wrapper's
    ``token_splits`` is replaced, and put back after."""
    rule = rpa.token_splits
    if splits is not None:
        rpa.token_splits = lambda *args: splits
    try:
        yield
    finally:
        rpa.token_splits = rule


#: the cluster kernel's splits held to C21 and the plain version on one
#: layout, and timed at the pure-decode tick
TOKEN_SPLITS = tuple(range(1, 9))


def compare_token_splits(torch, rpa, q, kp, vp, tbl, desc, label):
    """The cluster kernel 8 and B9 under every split count of
    TOKEN_SPLITS on one layout: C21 against the q-block kernels in fp32,
    bf16 and fp16, and the fp32 plain version within 1e-5."""
    from paddle_tpu_torch.models.generation import quantize_kv_rows
    rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=q.device)
    plans = {impl: rpa.make_plan(q.shape[0], *desc, tbl, PAGE, impl=impl,
                                 device=q.device) for impl in rpa.IMPLS}
    (kq, ks), (vq, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
    scale = HEAD_DIM ** -0.5
    worst = 0.0
    for splits in TOKEN_SPLITS:
        with forced_token_splits(rpa, splits):
            for pages in ((kp, vp), (kq, vq, ks, vs)):
                check_c21(torch, rpa, q, pages, plans, rows,
                          f"{label} S={splits}", verbose=False)
                fn = (rpa.token_attention_q8 if len(pages) == 4
                      else rpa.token_attention)
                out = fn(q, *pages, plans["token"], scale,
                         variant="cluster")
                ref = rpa.token_attention_plain(
                    q, *pages[:2], plans["token"], scale, *pages[2:])
                worst = max(worst, max_err(out, ref, rows))
    check(f"{label} cluster kernel 8 and B9 at S = "
          f"{', '.join(map(str, TOKEN_SPLITS))} vs plain (fp32)", worst,
          FP32_TOL)
    log(f"  C21 {label}: q-block == per-token (cluster) bit for bit at "
        f"every S, native and int8, in {', '.join(C21_DTYPES)}")


def ragged_edge_layouts(torch, dev):
    """Edge cases of kernel 8/B9's context split at Llama-3-8B widths
    (head_dim 128, page 16, the engine's 128-page tables; 32 query heads
    over 8 kv heads, G = 4, unless named): every token seeing 1 key (idle
    rows, padding), fewer pages than splits (3 tokens, 8 splits, 1-3
    pages), contexts ending on page edges, G = 1 (8 heads over 8 kv
    heads), one token (8 splits, 44 pages: three rounds), a 64-token
    prefill of 38-page contexts (one split, 19 rounds) and bucket padding
    (10 tokens outside every span). Yields (label, (q, k_pages, v_pages,
    tables, descriptors))."""
    cases = {
        "ctx 1 on 128-page tables": (N_HEADS, [(s, s, 1, 1)
                                               for s in range(8)], 8),
        "fewer pages than splits": (N_HEADS, [(0, 0, 1, 2), (1, 1, 1, 17),
                                              (2, 2, 1, 40)], 3),
        "contexts on page edges": (N_HEADS, [
            (s, s, 1, c) for s, c in enumerate([16, 32, 64, 96, 128, 160,
                                                512, 528])], 8),
        "G=1": (N_KV, [(0, 0, 1, 5), (1, 1, 1, 300), (2, 2, 3, 520),
                       (3, 5, 1, 700)], 6),
        "one token": (N_HEADS, [(0, 0, 1, 700)], 1),
        "64-token prefill, 38 pages": (N_HEADS, [(0, 0, 64, 600)], 64),
        "bucket padding": (N_HEADS, [(0, 0, 1, 300), (1, 1, 5, 77)], 16),
    }
    nslots, pps = 8, 128
    g = torch.Generator(device=dev).manual_seed(29)
    for i, (label, (heads, spans, tokens)) in enumerate(cases.items()):
        perm = np.random.RandomState(40 + i).permutation(nslots * pps) + 1
        tbl = perm.reshape(nslots, pps).astype(np.int32)
        tbl[-1, :3] = tbl[1, :3]
        desc = tuple(np.asarray([x[j] for x in spans], np.int32)
                     for j in range(4))
        shape = (N_KV, nslots * pps + 1, PAGE, HEAD_DIM)
        kp = torch.randn(shape, generator=g, device=dev)
        vp = torch.randn(shape, generator=g, device=dev)
        q = torch.randn((tokens, heads, HEAD_DIM), generator=g, device=dev)
        yield label, (q, kp, vp, tbl, desc)


#: phase 2(a)'s layouts of kernel 6 and B7 beyond the engines' page of
#: 16: (page size, head_dim, pools 16-byte misaligned), at Llama-3-8B's 32
#: query heads over 8 kv heads
PAGE_SHAPES = ((4, 128, False), (8, 128, False), (12, 128, False),
               (32, 128, False), (64, 128, False), (16, 72, False),
               (16, 128, True), (128, 256, False))


def token_block_fits(g, page, d):
    """Whether kernel 8 / B9's ``"block"`` variant takes pages of ``page``
    keys at head_dim ``d`` with ``g`` query heads a kv head: its fp32
    tile (``smem_floats`` in ``attention_common.cuh``) within
    SMEM_LIMIT."""
    from paddle_tpu_torch.ops.paged_attention import SMEM_LIMIT
    floats = (g * (d + 1) + page * (d + 1) + page * d + g * page + g * d
              + 3 * g)
    return 4 * floats <= SMEM_LIMIT


def page_layout(torch, dev, page, d):
    """``parity_layout``'s spans (decode spans, a 37-token prefill
    straddling q-blocks, two sequences aliasing their first pages, bucket
    padding) at pages of ``page`` keys and head_dim ``d``: tables of
    ceil(2048 / page) pages, slot 5 sharing slot 4's first 64 // page
    pages. fp32 pools and q."""
    max_len, nslots = 2048, 8
    pps = -(-max_len // page)
    num_pages = nslots * pps + 1
    tbl = np.zeros((nslots, pps), np.int32)
    for s in range(nslots):
        tbl[s] = np.arange(1 + s * pps, 1 + (s + 1) * pps)
    shared = 64 // page
    tbl[5, :shared] = tbl[4, :shared]
    spans = [(0, 0, 1, 700), (1, 1, 1, 33), (2, 2, 1, 1),
             (3, 3, 37, 137), (4, 40, 20, 84), (5, 60, 1, 70)]
    desc = tuple(np.asarray([s[i] for s in spans], np.int32)
                 for i in range(4))
    g = torch.Generator(device=dev).manual_seed(1234 + 1000 * page + d)
    shape = (N_KV, num_pages, page, d)
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    q = torch.randn((64, N_HEADS, d), generator=g, device=dev)
    return q, kp, vp, tbl, desc


def misalign(torch, t):
    """A copy of ``t`` whose data starts one element past its storage's
    (16-byte aligned) start: an address that is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 == 0:
        raise AssertionError("misalign gave an aligned copy")
    return out


def page_shape_case(torch, rpa, gen, page, d, misaligned, base_ms=None):
    """Kernel 6 and B7 at pages of ``page`` keys, head_dim ``d`` (pools
    misaligned when asked) on ``page_layout``, on the engines' fixed grid,
    in fp32, bf16 and fp16: the rule's variant (``qblock_variant``: the
    unit kernel at pages of 4, 8, 16 and 32 with head_dim % 16 == 0,
    aligned pools and a block that fits shared memory, else the runtime
    one; each launch counted by its variant) against the plain version
    (1e-5 in fp32, ``ulp_err`` <= 1 in bf16 and fp16); C21 bit for bit
    against kernel 8 / B9 (their ``"block"`` variant, which takes every
    shape; the cluster one too at page 16, head_dim % 16 == 0, aligned);
    where the rule takes the unit kernel, the runtime kernel forced on the
    same inputs gives the same bits. Then times (bf16 q, bf16 or int8
    pages) of the rule's variant and, where it is the unit kernel, of the
    runtime one forced, beside the plain version, the bound and
    ``base_ms`` (the unit kernel at page 16 on the same contexts). Returns
    the row."""
    dev = torch.device("cuda")
    q, kp, vp, tbl, desc = page_layout(torch, dev, page, d)
    rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=dev)
    scale = d ** -0.5
    plans = {"qblock": rpa.make_plan(q.shape[0], *desc, tbl, page,
                                     impl="qblock", device=dev,
                                     max_slots=ENGINE_SLOTS),
             "token": rpa.make_plan(q.shape[0], *desc, tbl, page,
                                    impl="token", device=dev)}
    prep = misalign if misaligned else None
    label = f"page {page}, head_dim {d}" + (", misaligned pools"
                                            if misaligned else "")
    (kq, ks), (vq, vs) = gen.quantize_kv_rows(kp), gen.quantize_kv_rows(vp)
    row = {"shape": label}
    for quant, fn in ((False, rpa.qblock_attention),
                      (True, rpa.qblock_attention_q8)):
        kernel = "B7" if quant else "kernel 6"
        worst, ran = {}, {}
        for short, name in PAGED_DTYPES.items():
            dt = getattr(torch, name)
            qd = q.to(dt)
            pd = (kq, vq, ks, vs) if quant else (kp.to(dt), vp.to(dt))
            if prep is not None:
                pd = tuple(prep(torch, x) for x in pd)
            want = rpa.qblock_variant(qd, pd[0], pd[1], plans["qblock"],
                                      *pd[2:])
            if misaligned and want != "runtime":
                raise AssertionError(f"{label}: the rule took {want}")
            ran[short] = want
            before = getattr(fn, f"{want}_launches")
            out = fn(qd, *pd, plans["qblock"], scale)
            if getattr(fn, f"{want}_launches") != before + 1:
                raise AssertionError(f"{label} {kernel}: {want} not counted")
            ref = rpa.qblock_attention_plain(
                qd.float(), *(pd[:2] if quant else (x.float() for x in pd)),
                plans["qblock"], scale, *pd[2:])
            what = f"{label} {kernel} {want} {short}"
            if short == "fp32":
                worst[short] = max_err(out, ref, rows)
                check(f"{what} kernel vs plain", worst[short], FP32_TOL)
            else:
                worst[short], ratio = ulp_err(torch, out[rows], ref[rows])
                check(f"{what} kernel vs {short}(fp32 plain)", ratio, 1.0,
                      "max error / (1 ulp + fp32 tol)")
            if want == "unit":
                other = fn(qd, *pd, plans["qblock"], scale,
                           variant="runtime")
                bits = torch.int32 if dt == torch.float32 else torch.int16
                if not torch.equal(out[rows].view(bits),
                                   other[rows].view(bits)):
                    raise AssertionError(f"{what}: the runtime kernel's "
                                         f"bits differ from the unit's")
        pages = (kq, vq, ks, vs) if quant else (kp, vp)
        c21 = token_block_fits(N_HEADS // N_KV, page, d)
        if c21:
            check_c21(torch, rpa, q, pages, plans, rows, label + (
                " int8" if quant else ""), verbose=False,
                token_variant="block", prep=prep)
        if page == rpa.SPLIT_PAGE and d % 16 == 0 and not misaligned:
            check_c21(torch, rpa, q, pages, plans, rows, label + (
                " int8" if quant else ""), verbose=False)
        # times on bf16 q (pages bf16 or int8)
        qb = q.bfloat16()
        pb = (kq, vq, ks, vs) if quant else (kp.bfloat16(), vp.bfloat16())
        if prep is not None:
            pb = tuple(prep(torch, x) for x in pb)
        key = "int8" if quant else "bf16"
        timed = {"variant": ran["bf16"],
                 "variants_by_dtype": ran,
                 "ms": time_ms(torch, lambda: fn(qb, *pb, plans["qblock"],
                                                 scale)),
                 "plain_ms": time_ms(torch, lambda: rpa.qblock_attention_plain(
                     qb, *pb[:2], plans["qblock"], scale, *pb[2:]),
                     iters=3, warmup=1),
                 **bound_ms(qb, pb[0], tbl, desc, quant=quant),
                 "max_abs_err": worst["bf16"],
                 "max_abs_err_fp32": worst["fp32"],
                 "max_abs_err_fp16": worst["fp16"]}
        if ran["bf16"] == "unit":
            timed["runtime_ms"] = time_ms(torch, lambda: fn(
                qb, *pb, plans["qblock"], scale, variant="runtime"))
        if base_ms is not None:
            timed["page16_ms"] = base_ms[key]
        row[key] = timed
        log(f"  {label}, {kernel} (by dtype {ran}): parity fp32 "
            f"{worst['fp32']:.3e}, bf16 {worst['bf16']:.3e}, fp16 "
            f"{worst['fp16']:.3e}; "
            + (f"C21 against kernel {'B9' if quant else '8'} held in "
               f"{', '.join(C21_DTYPES)}" if c21 else
               f"no C21 check: kernel {'B9' if quant else '8'} takes no "
               f"pages of {page} keys at head_dim {d} (its block's fp32 "
               f"tile outgrows shared memory)")
            + f"; {timed['ms']:.4f} ms"
            + (f" (the runtime kernel forced: {timed['runtime_ms']:.4f} ms,"
               f" the same bits)" if "runtime_ms" in timed else "")
            + (f", the unit kernel at page 16 on the same contexts "
               f"{timed['page16_ms']:.4f} ms" if base_ms is not None
               else "")
            + f", plain {timed['plain_ms']:.4f} ms, bound "
            f"{timed['bound_ms']:.6f} ms ({timed['bound_by']})")
    return row


def page_shapes(torch, rpa, gen):
    """Phase 2(a): kernel 6 and B7 on the engines' page of 16 (the base
    of the times) and at every shape of PAGE_SHAPES (``page_shape_case``).
    Returns the rows, the base first."""
    base = page_shape_case(torch, rpa, gen, PAGE, HEAD_DIM, False)
    rows = [base]
    ms = {key: base[key]["ms"] for key in ("bf16", "int8")}
    for page, d, misaligned in PAGE_SHAPES:
        rows.append(page_shape_case(torch, rpa, gen, page, d, misaligned,
                                    base_ms=ms if d == HEAD_DIM else None))
    torch.cuda.empty_cache()
    return rows


def decode_layout(torch, dev):
    """A pure-decode tick like the serving load's: 8 tokens over contexts
    of 47-615 (3-39 pages) in the engine's 128-page tables."""
    nslots, pps = 8, 128
    ctx = [47, 100, 200, 300, 400, 500, 600, 615]
    tbl = (np.random.RandomState(31).permutation(nslots * pps).reshape(
        nslots, pps) + 1).astype(np.int32)
    desc = tuple(np.asarray(x, np.int32) for x in (
        range(8), range(8), [1] * 8, ctx))
    g = torch.Generator(device=dev).manual_seed(37)
    shape = (N_KV, nslots * pps + 1, PAGE, HEAD_DIM)
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    q = torch.randn((8, N_HEADS, HEAD_DIM), generator=g, device=dev)
    return q, kp, vp, tbl, desc


#: B1 parity cases at Llama-3-8B widths: (b, sq, sk, causal, q_offset,
#: kv_offset, head_dim). 384 and 300 rows end mid-block for the
#: reference's tiling or the kernels'; the kv_offset-40 case has rows
#: 0..39 with no valid key; the last runs the head_dim-64 kernels.
FLASH_CASES = [(2, 384, 384, True, 0, 0, 128), (2, 300, 300, True, 0, 0, 128),
               (1, 128, 640, True, 512, 0, 128),
               (2, 200, 333, False, 0, 0, 128), (1, 64, 100, True, 0, 40, 128),
               (2, 256, 256, True, 0, 0, 64)]


def rel_lse_err(lse, ref_lse):
    """lse against its plain version, relative to max(1, |lse|)."""
    return float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max())


#: unit roundoff of the tensor-core B1's weights P, by dtype name
P_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
#: the most that rounding a value below the dtype's normal range moves
#: it: half the spacing of its subnormals (fp16 gradients at training
#: scale reach them; bf16's lie far below any value here)
P_UNDERFLOW = {"bfloat16": 2.0 ** -134, "float16": 2.0 ** -25}
#: relative difference between two fp32 computations of one softmax
#: weight (scores summed in another order, ``exp2f`` against ``exp``)
#: that ``rounding_model`` allows for: a weight this close to a rounding
#: boundary of the dtype may round to either neighbour
P_ETA = 2.0 ** -14


def ulp_of(torch, ref):
    """One ulp of each element of ``ref`` (bf16 or fp16 values)."""
    mant = 8 if ref.dtype == torch.bfloat16 else 11
    r = ref.float()
    return torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - mant)


def wgmma_out_error(torch, out, ref32, v, tol=FP32_TOL):
    """The tensor-core B1's bound against the reference (ROADMAP C15):
    ``out`` (bf16 or fp16) against ``ref32``, the fp32 plain version on
    the same inputs rounded to the dtype, with per-element allowance
    ``ulp(ref) + u max|V| + tol``. Each weight rounded to the dtype moves
    by at most u of itself, so ``sum p v / l`` moves by at most ``u
    max|v|``; the two roundings of the output add at most one ulp.
    Returns ``(max abs error, max error / allowance, max error / (ulp +
    tol))``: the bound holds iff the second is <= 1; the third is the
    one-ulp rule of the fp32-accumulating kernels, for comparison."""
    ref = ref32.float().to(out.dtype)
    diff = (out.float() - ref.float()).abs()
    ulp = ulp_of(torch, ref)
    u = P_ROUNDOFF[str(out.dtype).removeprefix("torch.")]
    allow = ulp + u * float(v.float().abs().max()) + tol
    return (float(diff.max()), float((diff / allow).max()),
            float((diff / (ulp + tol)).max()))


def rounding_model(torch, fa, q, k, v, causal, qo, ko, dtype, eta=P_ETA):
    """The tensor-core B1's rounding points in plain torch: the
    reference's recurrence as ``fa.flash_attention_plain`` runs it (its
    tiles, the keys each row visits, the finite mask), kernel layout, on
    fp32 copies of q, k, v, with the weights P rounded to ``dtype``
    before ``P V`` while l sums the fp32 p. Returns ``(out32, slack)``:
    the output before its final rounding, and per element the most that
    the weights lying within ``eta`` (relative) of a rounding boundary
    can move it if a kernel rounds them to their other neighbour:
    ``sum |gap_i| |v_i| / l`` over those weights, ``gap_i`` the distance
    between the two neighbours."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    bq, bk = fa.ref_blocks(sq, sk)
    sq_pad, sk_pad = -(-sq // bq) * bq, -(-sk // bk) * bk
    dev = q.device

    def pad(x, n):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, n - x.shape[2]))
    qg = pad(q, sq_pad).reshape(b, hk, g * sq_pad, d)
    kf, vf = pad(k, sk_pad), pad(v, sk_pad)
    rows = torch.arange(sq_pad, device=dev)
    q_ids = (qo + rows)[:, None]
    last_q = (qo + rows // bq * bq + bq - 1)[:, None]
    m = torch.full((b, hk, g * sq_pad, 1), fa.NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hk, g * sq_pad, d), device=dev)
    slack = torch.zeros_like(acc)
    run = torch.ones((g * sq_pad, 1), dtype=torch.bool, device=dev)
    for j in range(sk_pad // bk):
        kj, vj = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
        s = (qg @ kj.transpose(-1, -2)) * d ** -0.5
        k_ids = j * bk + torch.arange(bk, device=dev)[None, :]
        mask = (k_ids < sk).expand(sq_pad, bk)
        if causal:
            mask = mask & (q_ids >= ko + k_ids)
            run = (last_q >= ko + j * bk).repeat(g, 1)
        s = torch.where(mask.repeat(g, 1), s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        gap = ((p * (1 + eta)).to(dtype).float()
               - (p * (1 - eta)).to(dtype).float())
        l = torch.where(run, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * corr + p.to(dtype).float() @ vj, acc)
        slack = torch.where(run, slack * corr + gap @ vj.abs(), slack)
        m = torch.where(run, m_new, m)
    den = l.clamp_min(1e-30)
    return tuple((x / den).reshape(b, hq, sq_pad, d)[:, :, :sq]
                 for x in (acc, slack))


def model_error(torch, out, model32, slack, tol=FP32_TOL):
    """The tensor-core B1's tight check: ``out`` against its rounding
    model (``rounding_model``) rounded to the dtype, per element within
    ``ulp + slack + tol`` (the final roundings, the weights that may round
    either way, fp32 sums in another order). Returns ``(max abs error,
    max error / allowance, max error / (ulp + tol))``: the check holds iff
    the second is <= 1; the third is without the slack."""
    ref = model32.to(out.dtype)
    diff = (out.float() - ref.float()).abs()
    ulp = ulp_of(torch, ref)
    return (float(diff.max()), float((diff / (ulp + slack + tol)).max()),
            float((diff / (ulp + tol)).max()))


def grad_ulp(torch, ref):
    """One ulp of each element of ``ref`` (bf16 or fp16), counting the
    dtype's subnormal spacing below its normal range (fp16 gradients at
    training scale lie there) and at 0, so that a gradient's exact zeros
    (rows with no valid key) allow one subnormal step and no more."""
    spacing = 2 * P_UNDERFLOW[str(ref.dtype).removeprefix("torch.")]
    return torch.where(ref == 0, 0.0, ulp_of(torch, ref)).clamp_min(spacing)


def bwd_rounding_model(torch, fa, q, k, v, dout, lse, delta, causal, qo, ko,
                       dtype, eta=P_ETA):
    """The tensor-core B2 and B3's rounding points in plain torch (ROADMAP
    C17): the reference backward as ``fa.flash_bwd_dq_plain`` and
    ``fa.flash_bwd_dkv_plain`` run it (their padding, tiles and order,
    kernel layout, fp32 copies of the inputs), with p rounded to ``dtype``
    before ``P^T dO`` and ds before ``dS K`` and ``dS^T Q``, ds in the
    kernels' order (``p (dp - delta) scale``, then rounded). Returns
    ``{name: (model32, slack, rounding)}`` for dq, dk and dv: the gradient
    before its final rounding; per element the most that the values lying
    within ``eta`` of a rounding boundary can move it if a kernel rounds
    them to their other neighbour (``sum gap |y|``, ``gap`` the distance
    between the two neighbours; for ds the window is ``eta p scale (|dp|
    + |delta|)``, relative to the magnitudes before the cancellation in
    ``dp - delta``); and the C17 bound's rounding term, the most that
    rounding p and ds to the dtype can move it: ``u sum |x| |y| + e sum_{x
    != 0} |y|`` over the products' terms (``x`` the fp32 ds or p, ``y`` K,
    Q or dO), u the dtype's unit roundoff and e its subnormal floor
    (``P_UNDERFLOW``); 0 for fp32."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    name = str(dtype).removeprefix("torch.")
    u, e = P_ROUNDOFF.get(name, 0.0), P_UNDERFLOW.get(name, 0.0)
    qg, kf, vf, dog, lse_p, delta_p, tiling = fa._bwd_setup(q, k, v, dout,
                                                            lse, delta)
    g, sq_pad = tiling[0], tiling[3]
    qh, doh = (x.view(b, hk, g, sq_pad, d) for x in (qg, dog))

    def rnd(x):
        return x.to(dtype).float()

    def gap(x, w):
        return rnd(x + w) - rnd(x - w)

    def heads(x):
        return x.view(b, hk, g, sq_pad, -1).transpose(-1, -2)

    def c17(x):
        return u * x.abs() + e * (x != 0)

    dq = [torch.zeros_like(qg) for _ in range(3)]
    dk, dv = [[], [], []], [[], [], []]
    for j in range(tiling[4] // tiling[2]):
        p, ds, kj, vj = fa._bwd_tile(qg, kf, vf, dog, lse_p, delta_p, tiling,
                                     j, sk, causal, scale, qo, ko)
        dp = dog @ vj.transpose(-1, -2)
        w_ds = eta * p * (dp.abs() + delta_p.abs()) * scale
        for acc, x in zip(dq, (rnd(ds) @ kj, gap(ds, w_ds) @ kj.abs(),
                               c17(ds) @ kj.abs())):
            acc += x
        for out, x, y in ((dk, (rnd(ds), gap(ds, w_ds), c17(ds)),
                           (qh, qh.abs(), qh.abs())),
                          (dv, (rnd(p), gap(p, eta * p), c17(p)),
                           (doh, doh.abs(), doh.abs()))):
            for lst, xi, yi in zip(out, x, y):
                lst.append((heads(xi) @ yi).sum(2))
    return {"dq": tuple(x.view(b, hq, -1, d)[:, :, :sq] for x in dq),
            "dk": tuple(torch.cat(x, dim=2)[:, :, :sk] for x in dk),
            "dv": tuple(torch.cat(x, dim=2)[:, :, :sk] for x in dv)}


def wgmma_grad_error(torch, got, ref32, rounding, tol=FP32_TOL):
    """The tensor-core B2/B3's bound against the reference (ROADMAP C17):
    a bf16 or fp16 gradient ``got`` against ``ref32``, the fp32 plain
    version on the same inputs rounded to the dtype, with per-element
    allowance ``ulp(ref) + rounding + tol max|ref32|``: each p or ds
    rounded to the dtype moves by at most u of itself (or by the
    subnormal floor below the normal range), so the gradient moves by at
    most ``rounding`` (from ``bwd_rounding_model``); the two roundings of
    the output add at most one ulp, and ``tol`` of the gradient's max
    covers fp32 sums in another order (a gradient sums terms of either
    sign). Returns ``(max abs error, max error / allowance, max error /
    (ulp + tol max|ref32|))``: the bound holds iff the second is <= 1;
    the third is the one-ulp rule."""
    ref = ref32.float().to(got.dtype)
    diff = (got.float() - ref.float()).abs()
    ulp = grad_ulp(torch, ref)
    t = tol * float(ref32.float().abs().max())
    return (float(diff.max()), float((diff / (ulp + rounding + t)).max()),
            float((diff / (ulp + t)).max()))


def grad_model_error(torch, got, model32, slack, tol=FP32_TOL):
    """The tensor-core B2/B3's tight check: ``got`` against its rounding
    model (``bwd_rounding_model``) rounded to the dtype, per element
    within ``ulp + slack + tol max|model32|``. Returns ``(max abs error,
    max error / allowance, max error / (ulp + tol max|model32|))``: the
    check holds iff the second is <= 1; the third is without the slack."""
    ref = model32.to(got.dtype)
    diff = (got.float() - ref.float()).abs()
    ulp = grad_ulp(torch, ref)
    t = tol * float(model32.abs().max())
    return (float(diff.max()), float((diff / (ulp + slack + t)).max()),
            float((diff / (ulp + t)).max()))


def sdpa_out(torch, q, k, v, causal, qo, ko):
    """PyTorch's SDPA on the same kernel-layout inputs, and the query rows
    that see at least one key (SDPA returns no defined value for the
    others)."""
    sq, sk = q.shape[2], k.shape[2]
    kw, rows = {}, slice(None)
    if causal and sq == sk and qo == ko == 0:
        kw = {"is_causal": True}
    elif causal:
        i = torch.arange(sq, device=q.device)[:, None] + qo
        j = torch.arange(sk, device=q.device)[None, :] + ko
        kw = {"attn_mask": i >= j}
        rows = kw["attn_mask"].any(1)
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw)
    return out, rows


def compare_flash_case(torch, fa, q, k, v, causal, qo, ko, label):
    """B1 against its plain version on kernel-layout ``[b, h, s, d]``
    tensors (strided views allowed). fp32, on the scalar kernel: out
    within FP32_TOL, lse within FP32_TOL relative to max(1, |lse|). bf16
    and fp16, on the inputs rounded to the dtype, through the tensor-core
    kernel (its launch count says so): lse within FP32_TOL relative of the
    plain version on those inputs; out within the C15 bound of the fp32
    plain version (``wgmma_out_error``) and within the tight check of its
    rounding model (``model_error``), which fails a kernel whose output
    strays from those rounding points by more than the final rounding and
    the weights that may round either way. The one-ulp rule's ratio, and
    SDPA's ratios under all three, are printed beside them. Returns the
    errors."""
    q, k, v = (x.float() for x in (q, k, v))
    n_tc = fa.flash_attention.wgmma_launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, None, qo, ko)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, None, qo, ko)
    if fa.flash_attention.wgmma_launches != n_tc:
        raise AssertionError(f"{label}: fp32 ran the tensor-core kernel")
    e32 = float((out - ref).abs().max())
    el = rel_lse_err(lse, ref_lse)
    check(f"{label} fp32 out", e32, FP32_TOL)
    check(f"{label} fp32 lse", el, FP32_TOL, "max rel err")
    errs = {"fp32": e32, "lse": el}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        x = [t.to(dtype) for t in (q, k, v)]
        n_tc = fa.flash_attention.wgmma_launches
        o, lse = fa.flash_attention_with_lse(*x, causal, None, qo, ko)
        if fa.flash_attention.wgmma_launches != n_tc + 1 or o.dtype != dtype:
            raise AssertionError(f"{label} {name}: not the tensor-core kernel")
        ref, ref_lse = fa.flash_attention_plain(*(t.float() for t in x),
                                                causal, None, qo, ko)
        el = rel_lse_err(lse, ref_lse)
        check(f"{label} {name} lse (tensor cores)", el, FP32_TOL,
              "max rel err")
        e, ratio, one_ulp = wgmma_out_error(torch, o, ref, x[2])
        model, slack = rounding_model(torch, fa, *x, causal, qo, ko, dtype)
        em, tight, no_slack = model_error(torch, o, model, slack)
        lib, rows = sdpa_out(torch, *x, causal, qo, ko)
        _, lib_rule, lib_one_ulp = wgmma_out_error(
            torch, lib[:, :, rows], ref[:, :, rows], x[2])
        _, lib_tight, _ = model_error(torch, lib[:, :, rows],
                                      model[:, :, rows], slack[:, :, rows])
        log(f"  {label} {name} out: max_abs_err {e:.3e}, vs the rounding "
            f"model {em:.3e}; without the slack {no_slack:.3f}; one-ulp "
            f"rule {one_ulp:.3f}; SDPA on the same inputs: C15 bound "
            f"{lib_rule:.3f}, tight check {lib_tight:.3f}, one-ulp rule "
            f"{lib_one_ulp:.3f}")
        check(f"{label} {name} out vs {name}(fp32 plain)", ratio, 1.0,
              "max error / (ulp + u max|V| + fp32 tol)")
        check(f"{label} {name} out vs {name}(rounding model)", tight, 1.0,
              "max error / (ulp + slack + fp32 tol)")
        errs.update({name: e, f"{name}_rule": ratio, f"lse_{name}": el,
                     f"{name}_one_ulp": one_ulp, f"{name}_tight": tight,
                     f"{name}_no_slack": no_slack,
                     f"{name}_sdpa_rule": lib_rule,
                     f"{name}_sdpa_tight": lib_tight,
                     f"{name}_sdpa_one_ulp": lib_one_ulp})
    torch.cuda.synchronize()
    return errs


def worst_of(*errs):
    return {k: max(e[k] for e in errs) for k in errs[0]}


def compare_flash(torch, fa, dev):
    """B1 on the synthetic FLASH_CASES; returns the largest errors."""
    g = torch.Generator(device=dev).manual_seed(99)
    errs = []
    for b, sq, sk, causal, qo, ko, d in FLASH_CASES:
        q = torch.randn((b, N_HEADS, sq, d), generator=g, device=dev)
        k = torch.randn((b, N_KV, sk, d), generator=g, device=dev)
        v = torch.randn((b, N_KV, sk, d), generator=g, device=dev)
        errs.append(compare_flash_case(
            torch, fa, q, k, v, causal, qo, ko,
            f"B1 b={b} sq={sq} sk={sk} causal={causal} q_off={qo} "
            f"kv_off={ko} d={d}"))
    return worst_of(*errs)


def grad_err(got, ref):
    """A gradient against its plain version: max abs error over the
    plain version's max."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


#: B2/B3 parity cases at Llama-3-8B widths: (b, sq, sk, causal, q_offset,
#: kv_offset, lse cotangent, head_dim). 384 and 300 rows end mid-tile,
#: 200 x 333 is ragged on both axes, the kv_offset-40 case has rows 0..39
#: with no valid key (their forward is the mean of V, their gradient
#: zero), the last is a chunk after 170 cached tokens on the head_dim-64
#: kernels.
FLASH_BWD_CASES = [(2, 384, 384, True, 0, 0, False, 128),
                   (1, 200, 333, False, 0, 0, False, 128),
                   (1, 64, 100, True, 0, 40, False, 128),
                   (2, 300, 300, True, 0, 0, True, 128),
                   (1, 130, 300, True, 170, 0, False, 64)]


def compare_flash_bwd_case(torch, fa, q, k, v, dout, g_lse, causal, qo, ko,
                           label):
    """B2 and B3 against their plain versions on kernel-layout tensors
    (strided views allowed), with out and lse from B1 and delta from
    them. fp32, on the scalar kernels (their launch counts say so): each
    gradient within FP32_TOL of its max. bf16 and fp16, on the inputs
    rounded to the dtype, through the tensor-core kernels: each gradient
    within the C17 bound of the fp32 plain version (``wgmma_grad_error``)
    and within the tight check of its rounding model
    (``grad_model_error``), with the one-ulp rule's ratio and the ratio
    without the slack printed beside them. Returns the errors."""
    errs = {}
    kinds = (fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = {torch.float32: "fp32", torch.bfloat16: "bf16",
                torch.float16: "fp16"}[dtype]
        qx, kx, vx, dx = (t.to(dtype) for t in (q, k, v, dout))
        out, lse = fa.flash_attention_with_lse(qx, kx, vx, causal, None, qo,
                                               ko)
        delta = fa.bwd_delta(out, dx, g_lse)
        args = (lse, delta, causal, None, qo, ko)
        n_tc = [f.wgmma_launches for f in kinds]
        got = (fa.flash_bwd_dq(qx, kx, vx, dx, *args),
               *fa.flash_bwd_dkv(qx, kx, vx, dx, *args))
        want_tc = [n + (dtype != torch.float32) for n in n_tc]
        if [f.wgmma_launches for f in kinds] != want_tc:
            raise AssertionError(f"{label} {name}: B2/B3 variant wrong "
                                 f"({[f.wgmma_launches for f in kinds]} "
                                 f"tensor-core launches, expected {want_tc})")
        f32 = [t.float() for t in (qx, kx, vx, dx)]
        ref = (fa.flash_bwd_dq_plain(*f32, *args),
               *fa.flash_bwd_dkv_plain(*f32, *args))
        model = (None if dtype == torch.float32 else bwd_rounding_model(
            torch, fa, *f32, lse, delta, causal, qo, ko, dtype))
        for gname, gr, r in zip(("dq", "dk", "dv"), got, ref):
            assert gr.dtype == dtype and gr.shape == r.shape, gname
            if dtype == torch.float32:
                e = grad_err(gr, r)
                check(f"{label} fp32 {gname}", e, FP32_TOL, "max err / max")
                errs[f"{gname}_fp32"] = e
                errs[f"{gname}_fp32_abs"] = float((gr - r).abs().max())
                continue
            m32, slack, rounding = model[gname]
            e, ratio, one_ulp = wgmma_grad_error(torch, gr, r, rounding)
            em, tight, no_slack = grad_model_error(torch, gr, m32, slack)
            log(f"  {label} {name} {gname}: max_abs_err {e:.3e}, vs the "
                f"rounding model {em:.3e}; without the slack "
                f"{no_slack:.3f}; one-ulp rule {one_ulp:.3f}")
            check(f"{label} {name} {gname} vs {name}(fp32 plain)", ratio,
                  1.0, "max error / (ulp + rounding + tol max)")
            check(f"{label} {name} {gname} vs {name}(rounding model)",
                  tight, 1.0, "max error / (ulp + slack + tol max)")
            errs.update({f"{gname}_{name}": e, f"{gname}_{name}_rule": ratio,
                         f"{gname}_{name}_tight": tight,
                         f"{gname}_{name}_no_slack": no_slack,
                         f"{gname}_{name}_one_ulp": one_ulp})
    torch.cuda.synchronize()
    return errs


def compare_flash_bwd(torch, fa, dev):
    """B2 and B3 on FLASH_BWD_CASES; returns the largest errors."""
    g = torch.Generator(device=dev).manual_seed(98)
    errs = []
    for b, sq, sk, causal, qo, ko, with_lse, d in FLASH_BWD_CASES:
        q = torch.randn((b, N_HEADS, sq, d), generator=g, device=dev)
        k = torch.randn((b, N_KV, sk, d), generator=g, device=dev)
        v = torch.randn((b, N_KV, sk, d), generator=g, device=dev)
        dout = torch.randn((b, N_HEADS, sq, d), generator=g, device=dev)
        g_lse = (torch.randn((b, N_HEADS, sq), generator=g, device=dev)
                 if with_lse else None)
        errs.append(compare_flash_bwd_case(
            torch, fa, q, k, v, dout, g_lse, causal, qo, ko,
            f"B2/B3 b={b} sq={sq} sk={sk} causal={causal} q_off={qo} "
            f"kv_off={ko} lse_cotangent={with_lse} d={d}"))
    return worst_of(*errs)


def paged_layout(torch, dev):
    """Batch 8 with contexts 1-700 over permuted pages, rows 3 and 7
    sharing their first 10 pages, unused table entries 0."""
    ctx = np.asarray([1, 16, 17, 700, 33, 64, 129, 700], np.int32)
    pps = 48
    tbl = np.zeros((8, pps), np.int32)
    perm = np.random.RandomState(5).permutation(8 * pps) + 1
    for i, c in enumerate(ctx):
        n = -(-int(c) // PAGE)
        tbl[i, :n] = perm[i * pps:i * pps + n]
    tbl[7, :10] = tbl[3, :10]
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (N_KV, 8 * pps + 1, PAGE, HEAD_DIM)
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    q = torch.randn((8, N_HEADS, HEAD_DIM), generator=g, device=dev)
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(ctx).to(dev))


def paged_edge_layouts(torch, dev):
    """Edge cases of B4/B5's context split at Llama-3-8B widths (head_dim
    128, page 16; 32 query heads over 8 kv heads, G = 4, unless named):
    every context 1 token over 128-page tables (the legacy step's idle
    slots), contexts of fewer pages than splits, contexts ending on page
    edges, G = 1 (8 heads over 8 kv heads), one sequence (the most
    splits), and the legacy cache's 128-page tables under contexts of 3-39
    pages; rows 1 and the last share their first 3 pages. Yields (label,
    (q, k_pages, v_pages, tables, context_lens))."""
    cases = {"ctx 1 on 128-page tables": (N_HEADS, [1] * 8, 128),
             "fewer pages than splits": (N_HEADS, [2, 17, 20, 33, 48, 64,
                                                   70, 80], 128),
             "contexts on page edges": (N_HEADS, [16, 32, 64, 96, 128, 160,
                                                  512, 528], 40),
             "G=1": (N_KV, [5, 300, 520, 1, 16, 64, 100, 700], 48),
             "one sequence": (N_HEADS, [700], 48),
             "128-page tables, 3-39 pages": (N_HEADS, [40, 100, 200, 300,
                                                      400, 500, 600, 615],
                                             128)}
    g = torch.Generator(device=dev).manual_seed(17)
    for i, (label, (heads, ctx, pps)) in enumerate(cases.items()):
        b = len(ctx)
        tbl = np.zeros((b, pps), np.int32)
        perm = np.random.RandomState(20 + i).permutation(b * pps) + 1
        for r, c in enumerate(ctx):
            n = -(-c // PAGE)
            tbl[r, :n] = perm[r * pps:r * pps + n]
        if b > 3:
            tbl[-1, :3] = tbl[1, :3]
        shape = (N_KV, b * pps + 1, PAGE, HEAD_DIM)
        kp = torch.randn(shape, generator=g, device=dev)
        vp = torch.randn(shape, generator=g, device=dev)
        q = torch.randn((b, heads, HEAD_DIM), generator=g, device=dev)
        yield label, (q, kp, vp, torch.from_numpy(tbl).to(dev),
                      torch.from_numpy(np.asarray(ctx, np.int32)).to(dev))


#: B4/B5's output dtypes on the card, by the short name of the errors
PAGED_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}


def compare_paged(torch, pa, q, kp, vp, tbl, ctx, label, ks=None, vs=None):
    """B4 (native pages) or B5 (int8 codes with row scales ``ks``/``vs``),
    both variants, the rule's ``"cluster"`` and the forced ``"block"``:
    in fp32 (TF32 off) against the plain version (1e-5) and the dense
    reference (the reference's 2e-5; on the dequantised pages for int8),
    in bf16 and fp16 against the fp32 plain version on the rounded inputs,
    rounded (``ulp_err`` <= 1); the cluster kernel twice in bf16 gives the
    same bits. Returns the largest errors as ``{variant}_{dtype}``."""
    from paddle_tpu_torch.models.generation import dequantize_kv_rows
    quant = ks is not None
    kernel = "B5" if quant else "B4"
    scale = HEAD_DIM ** -0.5
    kw = dict(k_scales=ks, v_scales=vs) if quant else {}
    plain_scales = (ks, vs) if quant else ()

    def pools(dt):
        return (kp, vp) if quant else (kp.to(dt), vp.to(dt))

    q32 = q.float()
    dense = pa.paged_attention_reference(
        q32, *((dequantize_kv_rows(kp, ks), dequantize_kv_rows(vp, vs))
               if quant else pools(torch.float32)), tbl, ctx)
    errs = {}
    for variant in pa.VARIANTS:
        for short, name in PAGED_DTYPES.items():
            dt = getattr(torch, name)
            qd, pd = q.to(dt), pools(dt)
            out = pa.paged_attention(qd, *pd, tbl, ctx, variant=variant,
                                     **kw)
            ref = pa.paged_decode_plain(
                qd.float(), *(pd if quant else (p.float() for p in pd)),
                tbl, ctx, scale, *plain_scales)
            if out.dtype != dt:
                raise AssertionError(f"{label} {kernel}: {out.dtype} out")
            what = f"{label} {kernel} {variant} {short}"
            if short == "fp32":
                e = float((out - ref).abs().max())
                check(f"{what} kernel vs plain", e, FP32_TOL)
                check(f"{what} kernel vs dense reference",
                      float((out - dense).abs().max()), 2e-5)
            else:
                e, ratio = ulp_err(torch, out, ref)
                check(f"{what} kernel vs {short}(fp32 plain)", ratio, 1.0,
                      "max error / (1 ulp + fp32 tol)")
            errs[f"{variant}_{short}"] = e
            if variant == "cluster" and short == "bf16":
                again = pa.paged_attention(qd, *pd, tbl, ctx,
                                           variant=variant, **kw)
                if not torch.equal(out.view(torch.int16),
                                   again.view(torch.int16)):
                    raise AssertionError(f"{what}: two launches differ")
                log(f"  {what} twice: bit-identical")
    torch.cuda.synchronize()
    return errs


def compare_kernels_q8(torch, rpa, q, kq, vq, ks, vs, tbl, desc, label):
    """B7 and B9 (int8 pages with fp32 row scales) against their plain
    versions, in fp32 (1e-5) and in bf16 (one ulp of the fp32 plain
    version rounded, plus the fp32 tolerance), and against each other in
    fp32 (1e-5). Returns the errors by kernel and the plans."""
    rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=q.device)
    scale = HEAD_DIM ** -0.5
    plans = {impl: rpa.make_plan(q.shape[0], *desc, tbl, PAGE, impl=impl,
                                 device=q.device) for impl in rpa.IMPLS}
    kern = {"qblock": rpa.qblock_attention_q8,
            "token": rpa.token_attention_q8}
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    errs, out32 = {}, {}
    for impl in rpa.IMPLS:
        q32 = q.float()
        out32[impl] = kern[impl](q32, kq, vq, ks, vs, plans[impl], scale)
        ref32 = plain[impl](q32, kq, vq, plans[impl], scale, ks, vs)
        e32 = max_err(out32[impl], ref32, rows)
        check(f"{label} {impl}_q8 fp32 kernel vs plain", e32, FP32_TOL)
        qb = q.bfloat16()
        ob = kern[impl](qb, kq, vq, ks, vs, plans[impl], scale)
        rb = plain[impl](qb.float(), kq, vq, plans[impl], scale, ks, vs)
        assert ob.dtype == torch.bfloat16
        eb, ulps = ulp_err(torch, ob[rows], rb[rows])
        check(f"{label} {impl}_q8 bf16 kernel vs bf16(fp32 plain)", ulps,
              1.0, "max error / (1 bf16 ulp + fp32 tol)")
        errs[impl] = {"fp32": e32, "bf16": eb}
    torch.cuda.synchronize()
    check(f"{label} qblock_q8 vs token_q8 kernel fp32",
          max_err(out32["qblock"], out32["token"], rows), FP32_TOL)
    check_c21(torch, rpa, q, (kq, vq, ks, vs), plans, rows, label)
    errs["token_variants"] = compare_token_variants(
        torch, rpa, q, (kq, vq, ks, vs), plans["token"], rows, label)
    return errs, plans


#: the query dtypes C21 is held in
C21_DTYPES = ("float32", "bfloat16", "float16")


def check_c21(torch, rpa, q, pages, plans, rows, label, verbose=True,
              token_variant="cluster", prep=None, mixed=False):
    """ROADMAP C21: kernel 6 returns the same bits as kernel 8 (its
    ``token_variant``, forced: ``"cluster"``, or ``"block"`` at the shapes
    the cluster kernel does not take) on every real token's row, and B7 as
    B9, for fp32, bf16 and fp16 queries. ``pages`` is (k, v) of native
    pages in q's dtype family (cast with q) or (k_codes, v_codes,
    k_scales, v_scales) of int8 pages; ``prep`` (e.g. ``misalign``) is
    applied to each page array after the cast; with ``mixed`` native
    pages stay fp32 under every q (a 16-bit model's pools under O2, C29:
    the ``<16-bit, float>`` variants). Compares the bit patterns of the
    span rows; returns the number of cases held."""
    quant = len(pages) == 4
    kern = ((rpa.qblock_attention_q8, rpa.token_attention_q8) if quant
            else (rpa.qblock_attention, rpa.token_attention))
    scale = q.shape[-1] ** -0.5
    for name in C21_DTYPES:
        dt = getattr(torch, name)
        pg = pages if quant or mixed else tuple(x.to(dt) for x in pages)
        if prep is not None:
            pg = tuple(prep(torch, x) for x in pg)
        qd = q.to(dt)
        a = kern[0](qd, *pg, plans["qblock"], scale)[rows]
        b = kern[1](qd, *pg, plans["token"], scale,
                    variant=token_variant)[rows]
        bits = torch.int32 if dt == torch.float32 else torch.int16
        differ = int((a.view(bits) != b.view(bits)).sum())
        if differ:
            raise AssertionError(
                f"C21 {label} {name}{' int8' if quant else ''}"
                f"{' over fp32 pages' if mixed else ''}: {differ} "
                f"elements differ, max {float((a.float() - b.float()).abs().max())}")
    torch.cuda.synchronize()
    if verbose:
        log(f"  C21 {label}: q-block == per-token ({token_variant}) bit for "
            f"bit on {len(rows)} span rows in {', '.join(C21_DTYPES)}"
            + (" q over fp32 pages" if mixed else ""))
    return len(C21_DTYPES)


#: B10's (K, N) at Llama-3-8B: q/o, k/v, gate/up, down, lm_head
MATMUL_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256)]
#: B10's parity M: both tensor-core regimes, their crossover and every
#: token-tile edge
MATMUL_MS = (1, 8, 9, 16, 17, 32, 33, 63, 64, 65, 128, 200, 256, 300)
#: significant bits of the tensor-core dtypes (one ulp of v is
#: 2^(exponent(v) - bits), frexp's exponent) and fp16's subnormal spacing
ULP_BITS = {"bfloat16": 8, "float16": 11}
FP16_TINY = 2.0 ** -24
#: B10's tensor-core variants, and the ``STREAM_MAX_M`` that sends every
#: tensor-core call to each (``forced_variant``)
TENSOR_CORE_VARIANTS = {"wgmma_stream": 1 << 30, "wgmma_gemm": -1}
#: B10's fp32 variants, and the ``FP32_STREAM_MAX_M`` that sends every
#: fp32 call with K % 16 == 0 to each (``forced_variant``)
FP32_VARIANTS = {"fp32_stream": 1 << 30, "fp32_gemm": -1}


@contextlib.contextmanager
def forced_variant(qm, variant):
    """Inside the block, every B10 call that ``matmul_variant`` sends to
    the tensor cores (for a tensor-core ``variant``) or to the fp32 FMA
    kernels (for an fp32 one) takes ``variant`` (None: the rule's): the
    wrapper's ``STREAM_MAX_M`` or ``FP32_STREAM_MAX_M`` is moved past or
    below every M, and put back after. Calls of the other kind and K % 16
    != 0 (the scalar kernel) keep their variant."""
    name = "FP32_STREAM_MAX_M" if variant in FP32_VARIANTS \
        else "STREAM_MAX_M"
    rule = getattr(qm, name)
    if variant is not None:
        setattr(qm, name, {**TENSOR_CORE_VARIANTS, **FP32_VARIANTS}[variant])
    try:
        yield
    finally:
        setattr(qm, name, rule)


def c20_error(torch, out, ref32):
    """ROADMAP C20: a bf16 or fp16 B10 output against its fp32 plain
    version on the same inputs, rounded to the dtype. The products are
    exact and only the order of the fp32 sum differs (k-steps inside
    wgmma, split-K partials in a fixed order), so before its one rounding
    the kernel's sum lies within 1e-5 of the largest output of the plain
    one; both roundings together add at most one ulp of the reference.
    Allowance per element: ``ulp(ref) + 1e-5 max|ref32|`` (fp16's ulp no
    less than its subnormal spacing). Returns (max abs error, max error /
    allowance); the rule holds at a ratio <= 1."""
    name = str(out.dtype).split(".")[-1]
    ref = ref32.to(out.dtype).float()
    ulp = torch.ldexp(torch.ones_like(ref),
                      torch.frexp(ref).exponent - ULP_BITS[name])
    if name == "float16":
        ulp = ulp.clamp_min(FP16_TINY)
    diff = (out.float() - ref).abs()
    return (float(diff.max()),
            float((diff / (ulp + FP32_TOL * ref32.abs().max())).max()))


def compare_int8_matmul_case(torch, qm, x, wq, ws, label, variant=None):
    """B10 against its plain version: fp32 x on the fp32 variant
    ``matmul_variant`` names within 1e-5 of the output's largest
    magnitude (sums of up to 14336 products in another order); bf16 and
    fp16 x on the tensor-core variant it names under C20 (``c20_error``);
    ``variant`` (``forced_variant``) forces a tensor-core variant and the
    fp32 one of the other regime (the stream where the GEMM's M is
    forced, and the other way round); each variant's own count must rise
    by one. Returns ``{"fp32": error / max, "fp32_abs": ...,
    "fp32_variant": ..., "<dt>": max abs error, "<dt>_ratio": C20 ratio,
    "<dt>_variant": ...}``."""
    x32 = x.float()
    (m, k), n = x.shape, wq.shape[0]
    res = {}
    forced32 = None if variant is None else "fp32_" + variant.split("_")[1]
    with forced_variant(qm, forced32):
        took = qm.matmul_variant(torch.float32, m, n, k)
        count = f"{took}_launches"
        before = getattr(qm.int8_matmul, count, None)
        out = qm.int8_matmul(x32, wq, ws)
    if took not in FP32_VARIANTS or forced32 not in (None, took) or \
            getattr(qm.int8_matmul, count) != before + 1:
        raise AssertionError(f"{label} fp32: not launched on "
                             f"{forced32 or took}")
    ref = qm.int8_matmul_plain(x32, wq, ws)
    res["fp32_variant"] = took
    res["fp32_abs"] = float((out - ref).abs().max())
    res["fp32"] = res["fp32_abs"] / float(ref.abs().max())
    check(f"{label} fp32 ({took}) vs plain", res["fp32"], FP32_TOL,
          "max err / max")
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        xd = x.to(dt)
        with forced_variant(qm, variant):
            took = qm.matmul_variant(dt, m, n, k)
            count = f"{took}_launches"
            before = getattr(qm.int8_matmul, count)
            got = qm.int8_matmul(xd, wq, ws)
        assert got.dtype == dt
        if getattr(qm.int8_matmul, count) != before + 1 or \
                variant not in (None, took):
            raise AssertionError(f"{label} {name}: not launched on "
                                 f"{variant or took}")
        res[f"{name}_variant"] = took
        res[name], res[f"{name}_ratio"] = c20_error(
            torch, got, qm.int8_matmul_plain(xd.float(), wq, ws))
        check(f"{label} {name} ({res[f'{name}_variant']}) vs "
              f"{name}(fp32 plain)", res[f"{name}_ratio"], 1.0,
              "C20 ratio (max error / (1 ulp + 1e-5 max))")
    torch.cuda.synchronize()
    return res


def merge_mm_errs(errs, res, key):
    """Keeps the worst of each B10 parity figure (fp32 also by variant),
    and the worst C20 ratio per weight shape ``key``."""
    v = res["fp32_variant"]
    for f, g in (("fp32", "fp32"), ("fp32_abs", "fp32_abs"), ("bf16", "bf16"),
                 ("fp16", "fp16"), ("bf16_ratio", "bf16_ratio"),
                 ("fp16_ratio", "fp16_ratio"), (v, "fp32"),
                 (f"{v}_abs", "fp32_abs")):
        errs[f] = max(errs.get(f, 0.0), res[g])
    ratios = errs.setdefault("ratio_by_shape", {})
    ratios[key] = max(ratios.get(key, 0.0), res["bf16_ratio"],
                      res["fp16_ratio"])
    return errs


def compare_int8_matmul(torch, qm, dev):
    """B10 at every M of MATMUL_MS for the five (K, N) of Llama-3-8B, on
    seeded N(0, 0.02) bf16 weights quantised as the model's are; then a K
    that is not a whole number of k-tiles (a split-K part ends inside the
    weight's last tile), a K % 16 != 0 that takes the scalar kernel by
    rule in every dtype, each tensor-core variant and each fp32 variant
    forced at the other's M, and determinism: a split-K case of the
    tensor-core stream, the fp32 stream and the fp32 GEMM twice gives the
    same bits."""
    g = torch.Generator(device=dev).manual_seed(10)
    errs = {}

    def weight(n, k):
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02).bfloat16()
        return qm.quantize_weight(w)

    for k, n in MATMUL_SHAPES:
        wq, ws = weight(n, k)
        for m in MATMUL_MS:
            x = torch.randn((m, k), generator=g, device=dev)
            merge_mm_errs(errs, compare_int8_matmul_case(
                torch, qm, x, wq, ws, f"B10 M={m} K={k} N={n}"),
                f"{k}x{n}")
        for m, variant in ((8, "wgmma_gemm"), (256, "wgmma_stream")):
            x = torch.randn((m, k), generator=g, device=dev)
            merge_mm_errs(errs, compare_int8_matmul_case(
                torch, qm, x, wq, ws, f"B10 M={m} K={k} N={n} forced "
                f"{variant}", variant), f"{k}x{n}")
        del wq, ws
    k, n = 4096 + 48, 1000                      # 33 k-tiles, ragged N
    wq, ws = weight(n, k)
    for m in (8, 256):
        parts = qm.split_parts(qm.matmul_variant(torch.bfloat16, m, n, k),
                               m, n, k)
        log(f"  B10 K={k} N={n} M={m}: split-K parts {parts}")
        merge_mm_errs(errs, compare_int8_matmul_case(
            torch, qm, torch.randn((m, k), generator=g, device=dev), wq, ws,
            f"B10 M={m} K={k} N={n}"), f"{k}x{n}")
    k = 4104                                    # K % 16 == 8
    wq, ws = weight(n, k)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        if qm.matmul_variant(dt, 8, n, k) != "simt":
            raise AssertionError(f"K={k} {dt} does not take the scalar "
                                 f"kernel")
        x = torch.randn((8, k), generator=g, device=dev).to(dt)

        def others():
            return sum(getattr(qm.int8_matmul, f"{v}_launches")
                       for v in (*TENSOR_CORE_VARIANTS, *FP32_VARIANTS))
        before = others()
        got = qm.int8_matmul(x, wq, ws)
        ref = qm.int8_matmul_plain(x.float(), wq, ws)
        if dt == torch.float32:
            errs["simt_abs"] = float((got - ref).abs().max())
            errs["simt"] = e = errs["simt_abs"] / float(ref.abs().max())
            check(f"B10 M=8 K={k} N={n} fp32 (simt) vs plain", e, FP32_TOL,
                  "max err / max")
        else:
            _, e = c20_error(torch, got, ref)
            check(f"B10 M=8 K={k} N={n} {dt} (simt) vs plain", e, 1.0,
                  "C20 ratio")
        if others() != before:
            raise AssertionError(f"K={k} took a kernel other than simt")
    k, n = 4096, 1024
    wq, ws = weight(n, k)
    for variant, m, dt in (("wgmma_stream", 8, torch.bfloat16),
                           ("fp32_stream", 8, torch.float32),
                           ("fp32_gemm", 256, torch.float32)):
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        if qm.matmul_variant(dt, m, n, k) != variant \
                or qm.split_plan(variant, m, n, k)[2] < 2:
            raise AssertionError(f"the {variant} determinism case does not "
                                 f"split K")
        a, b = qm.int8_matmul(x, wq, ws), qm.int8_matmul(x, wq, ws)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        same = bool(torch.equal(a.view(bits), b.view(bits)))
        log(f"  B10 {variant} M={m} K={k} N={n} split-K "
            f"({qm.split_plan(variant, m, n, k)[2]} parts) twice: "
            f"bit-identical {same}")
        if not same:
            raise AssertionError(f"two split-K {variant} launches differ")
    torch.cuda.synchronize()
    log(f"  B10 worst C20 ratio by (K, N): {errs['ratio_by_shape']}")
    return errs


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
    """Instruments one eager serving run, tick by tick: the model forward
    on the host clock up to a device sync, the schedule build
    (``plan_arrays`` in the step's ``begin_ragged``, host clock, before
    the forward) and every layer's attention call between two CUDA
    events. Keeps each tick's descriptors and block tables, and layer 0's
    inputs of the largest tick that mixes decode and prefill spans
    (``best``) and of the pure-decode tick with the most tokens, then the
    longest contexts (``decode``)."""

    def __init__(self, torch, gen_module, model, n_layers):
        self.torch, self.mod, self.model = torch, gen_module, model
        self.n_layers = n_layers
        self.orig_attn = gen_module.ragged_paged_attention
        self.orig_plan = gen_module.plan_arrays
        self.calls, self.best, self.score = 0, None, -1
        self.decode, self.decode_score = None, (-1, -1)
        self.ticks = []          # dict per forward
        self.plan_ms = 0.0       # the next forward's schedule build

    def attention(self, q, kp, vp, tables, slots, starts, lens, ctx, **kw):
        if self.calls % self.n_layers == 0:
            self.ticks[-1].update(tbl=tables.copy(), pool=(kp, vp),
                                  tokens=q.shape[0],
                                  desc=(slots, starts, lens, ctx))
            mixed = (lens == 1).any() and (lens > 1).any()
            score = int(lens.sum()) + (10 ** 6 if mixed else 0)
            decode = (len(lens), int(ctx.sum())) if (lens == 1).all() \
                else (-1, -1)
            if score > self.score or decode > self.decode_score:
                ks, vs = kw.get("k_scales"), kw.get("v_scales")
                keep = dict(q=q.clone(), kp=kp.clone(), vp=vp.clone(),
                            tbl=tables.copy(),
                            desc=(slots, starts, lens, ctx),
                            ks=None if ks is None else ks.clone(),
                            vs=None if vs is None else vs.clone())
                if score > self.score:
                    self.score, self.best = score, keep
                if decode > self.decode_score:
                    self.decode_score, self.decode = decode, keep
        self.calls += 1
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.orig_attn(q, kp, vp, tables, slots, starts, lens, ctx,
                             **kw)
        b.record()
        self.ticks[-1]["events"].append((a, b))
        return out

    def plan_arrays(self, *args, **kw):
        t0 = time.perf_counter()
        plan = self.orig_plan(*args, **kw)
        self.plan_ms += (time.perf_counter() - t0) * 1e3
        return plan

    def forward(self, *args, **kw):
        self.ticks.append(dict(events=[], plan_ms=self.plan_ms))
        self.plan_ms = 0.0
        t0 = time.perf_counter()
        out = self.orig_forward(*args, **kw)
        self.torch.cuda.synchronize()
        self.ticks[-1]["fwd_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def summary(self):
        """Per tick: tokens, forward ms, attention ms (sum over layers of
        the event pairs), schedule build ms."""
        return [dict(tokens=int(np.asarray(t["desc"][2]).sum()),
                     fwd_ms=t["fwd_ms"], plan_ms=t["plan_ms"],
                     attn_ms=sum(a.elapsed_time(b) for a, b in t["events"]))
                for t in self.ticks]

    def __enter__(self):
        self.mod.ragged_paged_attention = self.attention
        self.mod.plan_arrays = self.plan_arrays
        self.orig_forward = self.model.forward
        self.model.forward = self.forward
        return self

    def __exit__(self, *exc):
        self.mod.ragged_paged_attention = self.orig_attn
        self.mod.plan_arrays = self.orig_plan
        del self.model.forward
        # the serving model must not outlive its phase (a bound method
        # holds it too)
        self.model = self.orig_forward = None
        self.torch.cuda.synchronize()


class Count:
    """One more counter of a kernel wrapper, read and zeroed as
    ``launches`` like the wrappers' own (``flash_attention``,
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` count every B1, B2 and B3
    launch in ``launches``, the tensor-core ones also in
    ``wgmma_launches``)."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def kernel_counters(rpa, fa, pa, qm, ost):
    """Every counted kernel launch by name: the wrappers' ``launches`` and
    their variants' counters (``Count``)."""
    return {"qblock": rpa.qblock_attention, "token": rpa.token_attention,
            "token_cluster": Count(rpa.token_attention, "cluster_launches"),
            "token_block": Count(rpa.token_attention, "block_launches"),
            "flash": fa.flash_attention,
            "flash_wgmma": Count(fa.flash_attention, "wgmma_launches"),
            "paged": pa.paged_attention,
            "paged_cluster": Count(pa.paged_attention, "cluster_launches"),
            "paged_block": Count(pa.paged_attention, "block_launches"),
            # 16-bit q over fp32 pages: the <T, float> instantiations of
            # kernels 4, 6 and 8 (a 16-bit model under AMP's O2, C29)
            "paged_mixed": Count(pa.paged_attention, "mixed_launches"),
            "qblock_mixed": Count(rpa.qblock_attention, "mixed_launches"),
            "token_mixed": Count(rpa.token_attention, "mixed_launches"),
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dq_wgmma": Count(fa.flash_bwd_dq, "wgmma_launches"),
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_bwd_dkv_wgmma": Count(fa.flash_bwd_dkv, "wgmma_launches"),
            "qblock_unit": Count(rpa.qblock_attention, "unit_launches"),
            "qblock_runtime": Count(rpa.qblock_attention, "runtime_launches"),
            "qblock_q8": rpa.qblock_attention_q8,
            "qblock_q8_unit": Count(rpa.qblock_attention_q8, "unit_launches"),
            "qblock_q8_runtime": Count(rpa.qblock_attention_q8,
                                       "runtime_launches"),
            "token_q8": rpa.token_attention_q8,
            "token_q8_cluster": Count(rpa.token_attention_q8,
                                      "cluster_launches"),
            "token_q8_block": Count(rpa.token_attention_q8, "block_launches"),
            "paged_q8": pa.paged_attention_q8,
            "paged_q8_cluster": Count(pa.paged_attention_q8,
                                      "cluster_launches"),
            "paged_q8_block": Count(pa.paged_attention_q8, "block_launches"),
            "int8_matmul": qm.int8_matmul,
            "int8_matmul_stream": Count(qm.int8_matmul,
                                        "wgmma_stream_launches"),
            "int8_matmul_gemm": Count(qm.int8_matmul, "wgmma_gemm_launches"),
            "int8_matmul_fp32_stream": Count(qm.int8_matmul,
                                             "fp32_stream_launches"),
            "int8_matmul_fp32_gemm": Count(qm.int8_matmul,
                                           "fp32_gemm_launches"),
            "adam_step": ost.adam_step_multi_tensor,
            "sum_squares": ost.sum_squares_multi_tensor}


def zero_counts(kern):
    for fn in kern.values():
        fn.launches = 0
        # the wrappers' counts by shape or dtype (a ``Count`` has none)
        for name in ("launches_by_m", "launches_by_shape",
                     "launches_by_dtype"):
            by = getattr(fn, name, None)
            if isinstance(by, dict):
                by.clear()


def b10_by_m(kern):
    """B10's launches by M since the counts were zeroed, as its wrapper
    counts them (a replay credits what its graph recorded)."""
    return dict(sorted(kern["int8_matmul"].launches_by_m.items()))


def read_counts(kern):
    return {name: fn.launches for name, fn in kern.items()}


def run_concurrently(eng, prompts, **kw):
    """One client thread per prompt, all at once; returns the outputs."""
    results = [None] * len(prompts)
    errors = []

    def run(i, p):
        try:
            results[i] = eng.generate(p, max_new_tokens=NEW_TOKENS,
                                      timeout=600, **kw).numpy()
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors!r}")
    return results


def serve(torch, pt, kern, model, prompts, warm, impl="qblock",
          enable_ragged=True, probes=(), tick_ms=None, **engine_kw):
    """Warm the engine (one request fills cuBLAS workspaces and registers
    the shared prefix, then ``warmup_programs`` captures the graph of
    every declared tick shape), then zero the launch counts and serve all
    prompts concurrently under
    ``probes``. A run with probes is eager (``cuda_graphs=False``: the
    probes wrap Python that a replayed graph does not run); the others
    run the engine's default, CUDA graphs, whose replays credit their
    recorded launches, so the counts stay exact. ``steps`` counts the
    ticks that ran a forward (ragged ticks, or legacy ticks that ran a
    chunk or a decode step: an integer sum, no sync), ``forwards`` the
    model forwards (a legacy tick may run a chunk and a decode step),
    ``forwards_by_m`` the forwards by token count, ``b10_by_m`` B10's
    launches by M. With
    ``tick_ms`` (a list) every such legacy tick also appends its time, to
    a device sync. ``engine_kw`` (``kv_dtype``, ``weight_dtype``) goes to
    the engine. Returns outputs, counts and timings."""
    eng = pt.ContinuousServingEngine(model, max_batch_size=8, max_len=2048,
                                     page_size=PAGE, token_budget=256,
                                     prefill_chunk_tokens=256,
                                     ragged_impl=impl,
                                     enable_ragged=enable_ragged,
                                     cuda_graphs=not probes, **engine_kw)
    legacy_ticks = [0]
    if not enable_ragged:
        legacy_tick = eng._legacy_tick

        def counted_tick(*args):
            work = eng.prefill_chunks + eng.decode_steps
            t0 = time.perf_counter()
            legacy_tick(*args)
            if tick_ms is not None:
                torch.cuda.synchronize()
            if eng.prefill_chunks + eng.decode_steps > work:
                legacy_ticks[0] += 1
                if tick_ms is not None:
                    tick_ms.append((time.perf_counter() - t0) * 1e3)
        eng._legacy_tick = counted_tick
    with eng:
        eng.generate(warm, max_new_tokens=NEW_TOKENS, timeout=600)
        # every declared shape captured before the timed run (no capture
        # falls in it; eager engines just run each shape once)
        eng.run_on_loop(lambda e: e.warmup_programs(), 600)
        if tick_ms is not None:
            tick_ms.clear()
        steps0 = eng.ragged_steps + legacy_ticks[0]
        rag0 = eng.ragged_steps
        hits0 = eng.prefix_hits
        dec0, buckets0 = eng.decode_steps, Counter(eng.prefill_chunk_buckets)
        graphs0 = (eng.graph_captures, eng.graph_replays)
        by_m = count_tick_shapes(eng)
        zero_counts(kern)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for probe in probes:
                stack.enter_context(probe)
            results = run_concurrently(eng, prompts)
        wall = time.perf_counter() - t0
        launches = read_counts(kern)
        buckets = eng.prefill_chunk_buckets - buckets0
        decode_steps = eng.decode_steps - dec0
        stats = dict(steps=eng.ragged_steps + legacy_ticks[0] - steps0,
                     hits=eng.prefix_hits - hits0, wall=wall,
                     launches=launches, b10_by_m=b10_by_m(kern),
                     decode_steps=decode_steps,
                     chunk_buckets=buckets,
                     # a ragged tick counts a decode step too (as the
                     # reference's does) but runs one forward
                     forwards=(eng.ragged_steps - rag0
                               + sum(buckets.values())
                               + (0 if enable_ragged else decode_steps)),
                     forwards_by_m=by_m + buckets,
                     captures=eng.graph_captures - graphs0[0],
                     replays=eng.graph_replays - graphs0[1],
                     useful=eng.useful_tokens_total,
                     padded=eng.padded_tokens_total,
                     quantized=eng.quantized_linears,
                     page_nbytes=eng._cache.page_nbytes,
                     pool_dtypes=pool_dtypes(eng._cache),
                     logits_dtypes=sorted(by_m.logits_dtypes))
    if eng.cuda_graphs:
        ticks = stats["steps"] if enable_ragged else decode_steps
        if stats["captures"] or stats["replays"] != ticks:
            raise AssertionError(f"{stats['captures']} captures and "
                                 f"{stats['replays']} replays in a counted "
                                 f"run of {ticks} tick forwards")
    # the wrappers close over the engine: no cycle keeps its pools alive
    for name in ("_forward", "_legacy_tick"):
        vars(eng).pop(name, None)
    return results, stats


def count_tick_shapes(eng):
    """From now on, count the engine's tick forwards (ragged ticks and
    legacy decode steps, graph replays included) by token count: the
    ``Counter`` returned fills as the engine runs. With the legacy
    chunks' bucket counts these are the forwards by M, which B10's
    launches by M must be 225 times. The counter's ``logits_dtypes``
    collects the dtypes of those forwards' logits."""
    by_m = Counter()
    run = eng._forward

    def counted(key, ids, pos, cache):
        by_m[int(np.asarray(ids).size)] += 1
        logits = run(key, ids, pos, cache)
        by_m.logits_dtypes.add(str(logits.dtype))
        return logits
    by_m.logits_dtypes = set()
    eng._forward = counted
    return by_m


def pool_dtypes(cache):
    """The dtypes of a cache's KV pools and, for int8 pages, their row
    scales."""
    arrays = [a for kv in list(cache._pools.values())
              + list(getattr(cache, "_scales", {}).values()) for a in kv]
    return sorted({str(a.dtype) for a in arrays})


def check_c25(label, pools, logits, quant=False, logits_dtype="float32"):
    """ROADMAP C25: a bf16 model's caches hold their pages in k's dtype,
    fp32 after the rope (int8 codes with fp32 scales under int8 KV), and
    its cached forwards return fp32 logits, as the reference's do. Under
    ``amp.auto_cast`` the pools stay fp32 and the logits take the
    lm_head's cast dtype (``logits_dtype``: bf16 under O1 and O2, C29)."""
    want = (["torch.float32", "torch.int8"] if quant
            else ["torch.float32"])
    if sorted(pools) != want or sorted(logits) != [f"torch.{logits_dtype}"]:
        raise AssertionError(f"{label}: pools {sorted(pools)} (expected "
                             f"{want}), logits {sorted(logits)} (expected "
                             f"{logits_dtype}): C25")
    log(f"  {label}: pools {'int8 codes + fp32 scales' if quant else 'fp32'}"
        f", logits {logits_dtype} (C25)")


def check_outputs(prompts, outs, vocab, label):
    for p, o in zip(prompts, outs):
        if o.shape != (1, p.shape[0] + NEW_TOKENS) or \
                not np.array_equal(o[0, :p.shape[0]], p) or \
                not ((o >= 0) & (o < vocab)).all():
            raise AssertionError(f"{label}: bad output shape/content "
                                 f"{o.shape}")


def check_launches(label, got, want):
    """``want`` maps every counted kernel to its expected launches."""
    log(f"  {label}: launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


class LayerZeroCapture:
    """For one run, wraps ``mod.<name>`` (the name the model's layers
    call) and keeps layer 0's inputs of the call that scores highest,
    later calls winning ties: ``score(*args, **kw)`` orders the calls,
    ``keep(*args, **kw)`` copies what is kept."""

    def __init__(self, mod, name, n_layers, score, keep):
        self.mod, self.name, self.n_layers = mod, name, n_layers
        self.score_of, self.keep = score, keep
        self.orig = getattr(mod, name)
        self.calls, self.best, self.score = 0, None, None

    def call(self, *args, **kw):
        if self.calls % self.n_layers == 0:
            score = self.score_of(*args, **kw)
            if self.score is None or score >= self.score:
                self.score, self.best = score, self.keep(*args, **kw)
        self.calls += 1
        return self.orig(*args, **kw)

    def __enter__(self):
        setattr(self.mod, self.name, self.call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def decode_capture(gen_module, n_layers):
    """Layer 0's paged-decode inputs of the decode step with the most
    context (live rows first, then their total context): q, tables and
    context lengths cloned, the pools (and int8 scales) by reference."""
    def score(q, kp, vp, tables, ctx, **kw):
        c = ctx.cpu().numpy()
        return int((c > 1).sum()), int(c.sum())

    def keep(q, kp, vp, tables, ctx, k_scales=None, v_scales=None, **kw):
        return dict(q=q.clone(), kp=kp, vp=vp, tables=tables.clone(),
                    ctx=ctx.clone(), ks=k_scales, vs=v_scales)
    return LayerZeroCapture(gen_module, "paged_attention", n_layers, score,
                            keep)


def flash_capture(functional, n_layers):
    """Layer 0's flash-attention inputs, as SDPA passes them (``[b, s,
    h, d]``, cloned with their strides), of the call with the largest
    (q_offset > 0, seq_q, seq_k): a chunk that reads back a prefix
    first."""
    def score(q, k, v, causal=True, q_offset=0, **kw):
        return q_offset > 0, q.shape[1], k.shape[1]

    def keep(q, k, v, causal=True, q_offset=0, **kw):
        return dict(q=q.clone(), k=k.clone(), v=v.clone(), causal=causal,
                    q_offset=q_offset)
    return LayerZeroCapture(functional, "flash_attention", n_layers, score,
                            keep)


class MatmulCapture:
    """For one run, wraps the ``int8_matmul`` that ``int8_linear`` calls
    and keeps, for each weight shape (K, N) and each M in ``ms``, the
    first call's inputs: x cloned, the codes and scales by reference, and
    the quantised layer's ``.weight`` (the dequantised bf16 weight, for
    the library comparator). The first call of a shape in a forward is
    layer 0's."""

    def __init__(self, quant_mod, model, ms=(8, 256)):
        self.mod, self.ms, self.best = quant_mod, ms, {}
        self.orig = quant_mod.int8_matmul
        self.layers = {id(m.w_int8): m for m in model.modules()
                       if hasattr(m, "w_int8")}

    def call(self, x, w, scale):
        key = (w.shape[1], w.shape[0], x.shape[0])
        if x.shape[0] in self.ms and key not in self.best:
            self.best[key] = dict(x=x.clone(), wq=w, ws=scale,
                                  weight=self.layers[id(w)].weight)
        return self.orig(x, w, scale)

    def __enter__(self):
        self.mod.int8_matmul = self.call
        return self

    def __exit__(self, *exc):
        self.mod.int8_matmul = self.orig
        self.layers = None          # hold no other layer past the run


class ForwardTimer:
    """Times every model forward to a device sync: (seq_len, ms); keeps
    the logits' dtypes."""

    def __init__(self, torch, model):
        self.torch, self.model, self.times = torch, model, []
        self.dtypes = set()

    def forward(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.orig(*args, **kw)
        self.torch.cuda.synchronize()
        self.times.append((int(out.shape[1]),
                           (time.perf_counter() - t0) * 1e3))
        self.dtypes.add(str(out.dtype))
        return out

    def __enter__(self):
        self.orig = self.model.forward
        self.model.forward = self.forward
        return self

    def __exit__(self, *exc):
        del self.model.forward
        # the serving model must not outlive its phase (a bound method
        # holds it too)
        self.model = self.orig = None


def serve_static(torch, pt, kern, model, prompts, probes=()):
    """Serve the prompts concurrently through one static engine whose
    window closes when all 8 rows are in; counts zeroed just before."""
    eng = pt.ServingEngine(model, max_batch_size=len(prompts),
                           batch_window_s=60.0, page_size=PAGE)
    with eng:
        zero_counts(kern)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for probe in probes:
                stack.enter_context(probe)
            results = run_concurrently(eng, prompts)
        wall = time.perf_counter() - t0
        launches = read_counts(kern)
        stats = dict(batches=eng.batches_run, wall=wall, launches=launches)
    return results, stats


# ---------------------------------------------------------------------------
# phases 3f and 3g: CUDA graphs against eager
# ---------------------------------------------------------------------------

#: the engines the graph phases hold replay against eager on
GRAPH_PATHS = {"qblock": dict(impl="qblock"), "token": dict(impl="token"),
               "legacy": dict(enable_ragged=False)}
#: the options of the seeded sampled streams
SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.95, seed=1234)


def run_in_order(eng, prompts, **gen_kw):
    """Submit the prompts one at a time, in order, while the serve loop is
    held at a tick boundary, then release it: every engine this runs on
    admits the same rows on the same ticks, so two runs are comparable
    tick for tick. ``gen_kw`` goes to every ``generate``. Returns the
    outputs."""
    results, errors = [None] * len(prompts), []
    entered, release = threading.Event(), threading.Event()

    def hold(_):
        entered.set()
        release.wait(600)

    holder = threading.Thread(target=lambda: eng.run_on_loop(hold, 600))
    holder.start()
    if not entered.wait(600):
        raise RuntimeError("the serve loop was not held")
    threads = []
    for i, p in enumerate(prompts):
        def run(i=i, p=p):
            try:
                results[i] = eng.generate(p, max_new_tokens=NEW_TOKENS,
                                          timeout=600, **gen_kw).numpy()
            except Exception as e:      # noqa: BLE001 — reported below
                errors.append(e)
        n = eng._q.qsize()
        threads.append(threading.Thread(target=run))
        threads[-1].start()
        deadline = time.monotonic() + 60
        while eng._q.qsize() == n and time.monotonic() < deadline:
            time.sleep(0.001)
    release.set()
    for t in threads + [holder]:
        t.join(900)
    if errors or any(t.is_alive() for t in threads + [holder]):
        raise RuntimeError(f"serving failed: {errors!r}")
    return results


class Patches:
    """Attribute swaps undone in reverse order: an instance attribute set
    by an earlier swap is put back, not deleted."""

    def __init__(self):
        self.undo = []

    def swap(self, obj, name, value):
        own = name in vars(obj)
        self.undo.append((obj, name, own, vars(obj).get(name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, own, old in reversed(self.undo):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self.undo = []


class HostBreakdown:
    """The host's time in the tick's modules, exclusive: each wrapped
    callable adds the time spent in it, less the time of the wrapped
    callables it calls, to its category, so the categories add up to the
    time spent inside any of them. Eager runs only (a replayed graph runs
    no Python). Categories: the model forward's own Python (residual
    adds, reshapes), the embedding, rope, the norms, the Linears' own
    forward (cuBLAS launches for native weights), B10's wrapper (int8
    weights), SwiGLU, the cache's attention (layer Python), the ragged or
    paged kernel's wrapper (plan checks, launch), the KV scatter (int8:
    quantise + scatter), and the step's staging before the forward
    (``begin_ragged`` / ``begin_decode``: schedule build and copies)."""

    def __init__(self, torch, model, gen, fused, quant_mod):
        self.totals, self.stack, self.t = Counter(), [], 0.0
        self.torch, self.model = torch, model
        self.gen, self.fused, self.quant = gen, fused, quant_mod
        self.patches = Patches()

    def wrap(self, category, fn):
        def inner(*args, **kw):
            now = time.perf_counter()
            if self.stack:
                self.totals[self.stack[-1]] += now - self.t
            self.stack.append(category)
            self.t = now
            try:
                return fn(*args, **kw)
            finally:
                now = time.perf_counter()
                self.totals[self.stack.pop()] += now - self.t
                self.t = now
        return inner

    def __enter__(self):
        nn, m, sw = self.torch.nn, self.model, self.patches.swap
        sw(m, "forward", self.wrap("forward (rest)", m.forward))
        emb = m.llama.embed_tokens
        sw(emb, "forward", self.wrap("embedding", emb.forward))
        for mod in m.modules():
            if isinstance(mod, nn.Linear):
                sw(mod, "forward", self.wrap("Linears", mod.forward))
            elif type(mod).__name__ == "RMSNorm":
                sw(mod, "forward", self.wrap("norms", mod.forward))
        for obj, name, cat in (
                (self.fused, "fused_rotary_position_embedding", "rope"),
                (self.fused, "fused_swiglu", "swiglu"),
                (self.quant, "int8_matmul", "B10 wrapper"),
                (self.gen, "ragged_paged_attention", "attention kernel "
                                                     "wrapper"),
                (self.gen, "paged_attention", "attention kernel wrapper"),
                (self.gen.SlotPagedKVCache, "attend", "attention (cache)"),
                (self.gen.SlotPagedKVCache, "_scatter", "KV scatter"),
                (self.gen.SlotPagedKVCache, "begin_ragged", "step staging"),
                (self.gen.SlotPagedKVCache, "begin_decode", "step staging")):
            sw(obj, name, self.wrap(cat, getattr(obj, name)))
        return self

    def __exit__(self, *exc):
        self.patches.restore()
        self.model = None        # hold no model past the run


class TickTimeline:
    """Per call of one engine's tick method: the host's wall, the host's
    time in the tick's forward (``_forward``: the eager launches, or the
    graph's enqueue), whether it ran a forward and whether a prefill
    span or chunk (``"mixed"``) or decode rows alone (``"decode"``), the
    device's window (CUDA events at the tick's start and end), and a
    marker kernel
    (``torch.cuda._sleep(0)``) launched first, so that a CUDA trace of
    the run splits into ticks on the device's own clock. Entered before
    the engine starts (its serve loop takes its tick method then); it
    records only while :meth:`arm` is on, which the serve loop sets at a
    tick boundary, from the tick after that boundary's own (an idle one,
    which would launch its marker as a trace starts), so the loop's
    ticks and the recorded ones match one for one."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.ticks = torch, eng, []
        self.patches = Patches()
        self.armed = self.skip = False

    def arm(self, on):
        """On the serve loop (``run_on_loop``): record from the tick after
        this boundary's, or stop."""
        self.armed = self.skip = on

    def __enter__(self):
        eng, torch = self.eng, self.torch
        name = "_tick" if eng.enable_ragged else "_legacy_tick"
        tick, fwd = getattr(eng, name), eng._forward

        def work():
            return eng.ragged_steps + eng.decode_steps + eng.prefill_chunks

        def timed_tick(*args):
            if not self.armed or self.skip:
                self.skip = False
                return tick(*args)
            rec = dict(fwd_ms=0.0, work=False,
                       events=[torch.cuda.Event(enable_timing=True)
                               for _ in "ab"])
            self.ticks.append(rec)
            w0, p0 = work(), eng.prefill_chunks
            torch.cuda._sleep(0)
            rec["events"][0].record()
            t0 = time.perf_counter()
            tick(*args)
            rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
            rec["events"][1].record()
            rec["work"] = work() > w0
            rec["kind"] = "mixed" if eng.prefill_chunks > p0 else "decode"

        def timed_forward(*args):
            if not self.armed:
                return fwd(*args)
            t0 = time.perf_counter()
            out = fwd(*args)
            self.ticks[-1]["fwd_ms"] += (time.perf_counter() - t0) * 1e3
            return out

        self.patches.swap(eng, name, timed_tick)
        self.patches.swap(eng, "_forward", timed_forward)
        return self

    def __exit__(self, *exc):
        self.patches.restore()
        self.eng = None


def device_intervals(torch, prof):
    """The CUDA activities (kernels, copies) of a profiler trace as
    ``(start_ns, end_ns, name)``, sorted."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1e3)
        out.append((float(start), float(start + dur), e.name()))
    return sorted(out)


def union_ns(intervals, lo=float("-inf"), hi=float("inf")):
    """Length of the union of ``(start, end, name)`` intervals clipped to
    [lo, hi)."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b, _ in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    return busy + (cur_hi - cur_lo if cur_hi is not None else 0.0)


def split_ticks(timeline, intervals):
    """The device's busy ms in each working tick: the union of the trace's
    activities other than the markers between the tick's marker kernel
    and the next one's (the last tick's to the trace's end). When the
    markers do not match the ticks one for one, every working tick gets
    the run's busy time over their count (``"busy_by"`` says which)."""
    marks = [iv for iv in intervals if "spin_kernel" in iv[2]]
    rest = [iv for iv in intervals if "spin_kernel" not in iv[2]]
    work = [rec["work"] for rec in timeline.ticks]
    # the loop's idle pass after the last delivery may start as the
    # trace stops: idle ticks at the end may lack their marker
    while len(work) > len(marks) and work and not work[-1]:
        work.pop()
    if len(marks) != len(work) or not marks:
        log(f"    trace: {len(marks)} markers for {len(work)} ticks, "
            f"{len(rest)} other activities: the run's busy time is spread "
            f"over its working ticks")
        busy = union_ns(rest) / 1e6
        return {"busy_by": "run", "busy_ms": [busy / max(sum(work), 1)]
                * sum(work)}
    end = max(iv[1] for iv in intervals)
    edges = [(marks[i][0], marks[i + 1][0] if i + 1 < len(marks) else end)
             for i in range(len(marks))]
    busy = [union_ns(rest, lo, hi) / 1e6 for lo, hi in edges]
    # device ms by kernel name over the decode ticks (a tick's activities
    # lie inside its window)
    by_name, n_decode = Counter(), 0
    for (lo, hi), w, rec in zip(edges, work, timeline.ticks):
        if w and rec["kind"] == "decode":
            n_decode += 1
            for a, b, name in rest:
                if lo <= a < hi:
                    by_name[short_name(name)] += (b - a) / 1e6
    top = {k: v / max(n_decode, 1) for k, v in by_name.most_common(10)}
    return {"busy_by": "tick", "busy_ms": [b for b, w in zip(busy, work)
                                           if w],
            "decode_ms_by_kernel": top}


def short_name(name):
    """A kernel's trace name without its return type, template arguments
    and parameters, at most 60 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop)[0]
    return name[:60]


class TickRecorder:
    """Keeps every ragged step's schedule input (tokens, descriptors,
    block table), as ``begin_ragged`` hands it to ``plan_arrays``; the
    host arrays only, so it works under graphs."""

    def __init__(self, gen_module):
        self.mod, self.orig, self.ticks = gen_module, gen_module.plan_arrays, []

    def call(self, num_tokens, *desc_and_tables, **kw):
        self.ticks.append((int(num_tokens),
                           tuple(np.array(a) for a in desc_and_tables[:4]),
                           np.array(desc_and_tables[4])))
        return self.orig(num_tokens, *desc_and_tables, **kw)

    def __enter__(self):
        self.mod.plan_arrays = self.call
        return self

    def __exit__(self, *exc):
        self.mod.plan_arrays = self.orig


#: the speculating engine's counters a graph run reports, over its
#: counted run
SPEC_STATS = ("spec_drafted_tokens", "spec_accepted_tokens", "spec_rounds",
              "spec_draft_forwards", "spec_draft_ticks")


def graph_run(torch, pt, kern, model, prompts, warm, graphs, path_kw,
              gen_kw=None, probes=(), profile=False, page=PAGE):
    """One engine run of the prompts in order (``run_in_order``), eager or
    with graphs: the warm request, then ``warmup_programs`` (with graphs it
    captures every declared shape, so no capture falls in the run), then
    the counted run under ``probes``, a ``TickTimeline`` and, with
    ``profile``, a CUDA-only ``torch.profiler`` trace (its callbacks slow
    the host's launches: the busy times come from it, the walls from an
    untraced run). ``path_kw`` goes to the engine (``spec_decode=True``
    and its options too; the speculation counters of the counted run are
    in ``stats["spec"]``), ``page`` is its page size. Returns the outputs,
    the stats and the engine's cache (its pools)."""
    kw = dict(path_kw)
    impl = kw.pop("impl", "qblock")
    eng = pt.ContinuousServingEngine(model, max_batch_size=ENGINE_SLOTS,
                                     max_len=2048, page_size=page,
                                     token_budget=256,
                                     prefill_chunk_tokens=256,
                                     ragged_impl=impl, cuda_graphs=graphs,
                                     **kw)
    timeline = TickTimeline(torch, eng)
    # the serve loop takes its tick method at start(): the timeline goes
    # on first
    with timeline, eng:
        eng.generate(warm, max_new_tokens=NEW_TOKENS, timeout=600)
        warm_s = eng.run_on_loop(lambda e: e.warmup_programs(), 600)
        g0 = (eng.graph_captures, eng.graph_replays)
        work0 = (eng.ragged_steps, eng.decode_steps,
                 Counter(eng.prefill_chunk_buckets))
        spec0 = {k: getattr(eng, k) for k in SPEC_STATS}
        rolled0 = eng._cache.tokens_rolled_back
        by_m = count_tick_shapes(eng)
        zero_counts(kern)
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            for probe in probes:
                stack.enter_context(probe)
            prof = (stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]))
                if profile else None)
            if prof is not None:
                # a trace may drop the activities of its first moments:
                # let them be these, not a tick's marker
                for _ in range(8):
                    torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                time.sleep(0.05)
            eng.run_on_loop(lambda e: timeline.arm(True), 600)
            t0 = time.perf_counter()
            outs = run_in_order(eng, prompts, **(gen_kw or {}))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the last request is delivered inside the last tick: the
            # timeline stops at the next boundary, before the probes come
            # off
            eng.run_on_loop(lambda e: timeline.arm(False), 600)
        launches = read_counts(kern)
        chunks = eng.prefill_chunk_buckets - work0[2]
        ticks = [t for t in timeline.ticks if t["work"]]
        for t in ticks:
            a, b = t.pop("events")
            t["window_ms"] = a.elapsed_time(b)
        stats = dict(launches=launches, b10_by_m=b10_by_m(kern),
                     wall=wall, warmup_s=warm_s,
                     captures=eng.graph_captures - g0[0],
                     replays=eng.graph_replays - g0[1],
                     ragged_steps=eng.ragged_steps - work0[0],
                     decode_steps=eng.decode_steps - work0[1],
                     chunk_buckets=chunks, forwards_by_m=by_m + chunks,
                     ticks=ticks,
                     spec=dict({k: getattr(eng, k) - spec0[k]
                                for k in SPEC_STATS},
                               tokens_rolled_back=eng._cache
                               .tokens_rolled_back - rolled0))
        if prof is not None:
            intervals = device_intervals(torch, prof)
            stats["device"] = split_ticks(timeline, intervals)
            stats["traced_kernels"] = Counter(short_name(n)
                                              for _, _, n in intervals)
        cache = eng._cache
    vars(eng).pop("_forward", None)      # no cycle through the wrapper
    return outs, stats, cache


def traced_launches(c):
    """The launches a trace must show of each kernel that the serving
    paths launch, by its name in the trace, from the counters ``c``
    (``read_counts``)."""
    b10_tc = c["int8_matmul_stream"] + c["int8_matmul_gemm"]
    b10_fp32 = c["int8_matmul_fp32_stream"] + c["int8_matmul_fp32_gemm"]
    return {"qblock_unit_kernel": c["qblock_unit"] + c["qblock_q8_unit"],
            "qblock_runtime_kernel": c["qblock_runtime"]
            + c["qblock_q8_runtime"],
            "token_split_kernel": c["token_cluster"] + c["token_q8_cluster"],
            "token_kernel": c["token_block"] + c["token_q8_block"],
            "paged_decode_split_kernel": c["paged_cluster"]
            + c["paged_q8_cluster"],
            "paged_decode_kernel": c["paged_block"] + c["paged_q8_block"],
            "flash_fwd_wgmma_kernel": c["flash_wgmma"],
            "flash_fwd_kernel": c["flash"] - c["flash_wgmma"],
            "int8_matmul_wgmma_kernel": b10_tc,
            "int8_matmul_fp32_stream_kernel": c["int8_matmul_fp32_stream"],
            "int8_matmul_fp32_gemm_kernel": c["int8_matmul_fp32_gemm"],
            "int8_matmul_kernel": c["int8_matmul"] - b10_tc - b10_fp32}


def check_traced_launches(label, st):
    """The kernels a traced run's trace shows, by name, against what its
    counters say they launched. A CUDA trace may drop records (eager or
    replayed; up to 53 of a kernel's 768 in one run), so a kernel may
    show fewer launches, but never more, and at least ``TRACE_KEEPS`` of
    them; the shortfall is printed."""
    want = traced_launches(st["launches"])
    got = {name: st["traced_kernels"].get(name, 0) for name in want}
    if any(got[k] > n or got[k] < TRACE_KEEPS * n for k, n in want.items()):
        raise AssertionError(f"{label}: the trace shows {got}, the launch "
                             f"counters say {want}")
    short = {k: n - got[k] for k, n in want.items() if got[k] != n}
    log(f"    {label}: the trace shows the counted launches "
        f"{ {k: v for k, v in got.items() if v} }"
        + (f", short by {short} (records the trace dropped)" if short
           else ""))


def tick_summary(clean, traced, host=None, host_stats=None):
    """Per working tick, from an untraced run (``clean``): the host's wall
    (mean and median), the host's time in the forward and the device's
    window (CUDA events); from a traced run of the same ticks
    (``traced``): the device's busy time; the idle share, 1 - busy /
    window summed over the ticks; and with ``host`` (a ``HostBreakdown``
    of the run ``host_stats``) the host's ms a tick in each module
    category."""
    ticks = clean["ticks"]
    n = len(ticks)
    walls = [t["wall_ms"] for t in ticks]
    window = sum(t["window_ms"] for t in ticks)
    dev = traced["device"]
    if len(dev["busy_ms"]) != n:
        raise AssertionError(f"the traced run has {len(dev['busy_ms'])} "
                             f"working ticks, the untraced {n}")
    busy = sum(dev["busy_ms"])
    out = {"ticks": n, "wall_ms": float(np.mean(walls)),
           "wall_ms_median": float(np.median(walls)),
           "fwd_host_ms": float(np.mean([t["fwd_ms"] for t in ticks])),
           "window_ms": window / n, "busy_ms": busy / n,
           "busy_by": dev["busy_by"], "idle_share": 1.0 - busy / window,
           "traced_wall_ms": float(np.mean([t["wall_ms"]
                                            for t in traced["ticks"]])),
           "decode_ms_by_kernel": dev.get("decode_ms_by_kernel")}
    for kind in ("decode", "mixed"):
        idx = [i for i, t in enumerate(ticks) if t["kind"] == kind]
        if not idx:
            continue
        w = sum(ticks[i]["window_ms"] for i in idx)
        b = (sum(dev["busy_ms"][i] for i in idx)
             if dev["busy_by"] == "tick" else None)
        out[f"{kind}_ticks"] = {
            "ticks": len(idx),
            "wall_ms": float(np.mean([ticks[i]["wall_ms"] for i in idx])),
            "wall_ms_median": float(np.median([ticks[i]["wall_ms"]
                                               for i in idx])),
            "window_ms": w / len(idx),
            "busy_ms": None if b is None else b / len(idx),
            "idle_share": None if b is None else 1.0 - b / w}
    if host is not None:
        m = len(host_stats["ticks"])
        out["host_ms_by_module"] = {k: v * 1e3 / m for k, v in
                                    sorted(host.totals.items())}
        out["instrumented_wall_ms"] = float(np.mean(
            [t["wall_ms"] for t in host_stats["ticks"]]))
    return out


def c21_at_ticks(torch, rpa, gen, cache, layer, ticks, quant, label):
    """C21 on the engines' fixed grid at every recorded ragged tick: the
    padded kernel-6 (B7) plan against kernel 8 (B9, cluster) over layer
    0's live pool (and scales), on a random q; returns the cases held."""
    kp, vp = cache._pools[id(layer)]
    pages = ((kp, vp, *cache._scales[id(layer)]) if quant else (kp, vp))
    cases, dev = 0, kp.device
    for i, (n, desc, tbl) in enumerate(ticks):
        plans = {impl: rpa.make_plan(n, *desc, tbl, PAGE, impl=impl,
                                     device=dev, max_slots=ENGINE_SLOTS)
                 for impl in rpa.IMPLS}
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn((n, N_HEADS, HEAD_DIM), generator=g, device=dev)
        rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=dev)
        cases += check_c21(torch, rpa, q, pages, plans, rows,
                           f"{label} tick {i}", verbose=False)
    log(f"  C21 {label}: the fixed q-block grid == per-token (cluster) bit "
        f"for bit at all {len(ticks)} ticks of the graph run, {cases} cases "
        f"({', '.join(C21_DTYPES)})")
    return cases


def graphs_against_eager(torch, pt, gen, rpa, fused, quant_mod, kern, model,
                         prompts, warm, int8, keep=None):
    """Phase 3f (native bf16) or 3g (``int8``: the fully-int8 engines, the
    model already quantised): for the q-block, per-token and legacy
    engines, the 8-request load in order, three times eagerly (plain; with
    ``HostBreakdown``; traced) and twice with graphs (plain; traced).
    Against the plain eager run, every other run's greedy streams must be
    bit-identical and its launch counts equal by kernel and variant (B10's
    by M too); in both traced runs the trace must show each kernel as
    many times as its counters say, less records the trace dropped
    (under graphs the counts are the replays' credits, so the trace
    observes the replayed kernels); each
    ragged kernel must
    launch 32 times a tick and each decode kernel 32 times a decode step;
    the graph runs must replay every tick and capture none
    (``warmup_programs`` captured every declared shape); C21 must hold on
    the fixed q-block grid at every tick of the plain graph run, over
    layer 0's live pool; B10's launches by M must be 225 x the forwards
    by token count.
    Walls, the host's time in the forward and the device's windows come
    from the plain runs, busy times from the traced ones (same ticks).
    Returns the per-tick summaries; ``keep`` (a dict) gets the q-block
    engine's plain graph run (outputs, stats, per-tick summary and its
    forwards' device ms by token bucket), spec off for 3h and 3i."""
    label = "int8" if int8 else "bf16"
    engine_kw = dict(kv_dtype="int8", weight_dtype="int8") if int8 else {}
    layer = model.llama.layers[0].self_attn
    out = {}
    for name, path_kw in GRAPH_PATHS.items():
        path_kw = dict(path_kw, **engine_kw)
        tag = f"{label} {name}"

        def run(graphs, probes=(), profile=False):
            return graph_run(torch, pt, kern, model, prompts, warm, graphs,
                             path_kw, probes=probes, profile=profile)

        e_outs, eager, _ = run(False)
        host = HostBreakdown(torch, model, gen, fused, quant_mod)
        runs = {"eager, module breakdown": run(False, [host]),
                "eager, traced": run(False, profile=True)}
        rec, fwd = TickRecorder(gen), ForwardEvents(torch, pt)
        with fwd:
            runs["graphs"] = run(True, [rec])
        runs["graphs, traced"] = run(True, profile=True)
        check_outputs(prompts, e_outs, model.config.vocab_size, tag)
        for what, (outs, st, _) in runs.items():
            for a, b in zip(e_outs, outs):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{tag}: the {what} run's greedy "
                                         f"stream differs from the eager "
                                         f"one")
            if st["launches"] != eager["launches"] or \
                    st["b10_by_m"] != eager["b10_by_m"]:
                raise AssertionError(f"{tag}: launches eager "
                                     f"{eager['launches']} (B10 by M "
                                     f"{eager['b10_by_m']}), {what} "
                                     f"{st['launches']} ({st['b10_by_m']})")
            if "traced_kernels" in st:
                check_traced_launches(f"{tag}, {what}", st)
        graph, cache = runs["graphs"][1], runs["graphs"][2]
        key = {"qblock": "qblock", "token": "token",
               "legacy": "paged"}[name] + ("_q8" if int8 else "")
        per = graph["decode_steps"] if name == "legacy" else \
            graph["ragged_steps"]
        if graph["launches"][key] != N_LAYERS * per or not per:
            raise AssertionError(f"{tag}: {key} launched "
                                 f"{graph['launches'][key]} times over "
                                 f"{per} ticks")
        for what in ("graphs", "graphs, traced"):
            st = runs[what][1]
            if st["captures"] != 0 or st["replays"] != per:
                raise AssertionError(f"{tag}, {what}: {st['captures']} "
                                     f"captures and {st['replays']} replays "
                                     f"in a run of {per} tick forwards")
        derived = {m: N_LINEARS * n for m, n in
                   sorted(graph["forwards_by_m"].items())} if int8 else {}
        if graph["b10_by_m"] != derived:
            raise AssertionError(f"{tag}: B10 launches by M "
                                 f"{graph['b10_by_m']}, 225 x the forwards "
                                 f"by M {derived}")
        c21 = 0
        if name != "legacy":
            c21 = c21_at_ticks(torch, rpa, gen, cache, layer, rec.ticks,
                               int8, f"graphs {tag}")
        del cache
        runs = {k: v[1] for k, v in runs.items()}
        e_sum = tick_summary(eager, runs["eager, traced"], host,
                             runs["eager, module breakdown"])
        g_sum = tick_summary(graph, runs["graphs, traced"])
        if name == "qblock" and keep is not None:
            keep.update(outs=e_outs, st=graph, sum=g_sum,
                        forward_ms=fwd.ms_by_bucket(len(fwd.events)
                                                    - graph["ragged_steps"]))
        out[name] = {"eager": e_sum, "graphs": g_sum, "c21_cases": c21,
                     "warmup_s": graph["warmup_s"],
                     "launches": {k: v for k, v in graph["launches"].items()
                                  if v}}
        log(f"  {tag}: greedy streams bit-identical and launches equal over "
            f"3 eager and 2 graph runs {out[name]['launches']}; "
            f"{graph['replays']} replays, 0 captures a graph run "
            f"(warmup_programs {graph['warmup_s']})")
        for mode, sm in (("eager", e_sum), ("graphs", g_sum)):
            log(f"    {mode}: {sm['ticks']} ticks, tick {sm['wall_ms']:.3f} "
                f"ms (median {sm['wall_ms_median']:.3f}), forward on the "
                f"host {sm['fwd_host_ms']:.3f} ms, device window "
                f"{sm['window_ms']:.3f} ms, busy {sm['busy_ms']:.3f} ms (by "
                f"{sm['busy_by']}), idle share {sm['idle_share']:.4f}; "
                f"traced tick {sm['traced_wall_ms']:.3f} ms")
            for kind in ("decode", "mixed"):
                k = sm.get(f"{kind}_ticks")
                if k is None:
                    continue
                log(f"      {kind} ticks: {k['ticks']}, tick "
                    f"{k['wall_ms']:.3f} ms (median "
                    f"{k['wall_ms_median']:.3f}), window "
                    f"{k['window_ms']:.3f} ms" + (
                        "" if k["busy_ms"] is None else
                        f", busy {k['busy_ms']:.3f} ms, idle share "
                        f"{k['idle_share']:.4f}"))
        top = g_sum["decode_ms_by_kernel"]
        if top:
            log("    graphs, device ms a decode tick by kernel (the ten "
                "largest): " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in top.items()))
        log(f"    eager host ms a tick by module (instrumented tick "
            f"{e_sum['instrumented_wall_ms']:.3f} ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in
                e_sum["host_ms_by_module"].items()))
    return out


def sampled_and_abort(torch, pt, kern, model, prompts, warm):
    """Seeded sampled streams (``SAMPLED``) of the q-block engine: two
    graph runs and one eager run of the load in order, all equal. Then
    ``abort`` under load: the 8 requests submitted at once to a graph
    engine, aborted after its first decode tick, must all fail with
    ``RuntimeError("ServingEngine aborted")`` with every slot freed; the
    engine then serves again on a new cache (whose graphs it captures
    anew), one request, as a fresh engine serves it."""
    path = GRAPH_PATHS["qblock"]
    runs = [graph_run(torch, pt, kern, model, prompts, warm, g, path,
                      gen_kw=SAMPLED, profile=False)[0]
            for g in (True, True, False)]
    for outs in runs[1:]:
        for a, b in zip(runs[0], outs):
            if not np.array_equal(a, b):
                raise AssertionError("seeded sampled streams differ between "
                                     "runs (graphs, graphs, eager)")
    check_outputs(prompts, runs[0], model.config.vocab_size, "sampled")
    log(f"  seeded sampled streams ({SAMPLED}) equal over two graph runs "
        f"and one eager run of the q-block engine")
    eng = pt.ContinuousServingEngine(model, max_batch_size=ENGINE_SLOTS,
                                     max_len=2048, page_size=PAGE,
                                     token_budget=256,
                                     prefill_chunk_tokens=256)
    errors = []

    def run(p):
        try:
            eng.generate(p, max_new_tokens=NEW_TOKENS, timeout=600)
        except RuntimeError as e:
            errors.append(str(e))

    with eng:
        threads = [threading.Thread(target=run, args=(p,)) for p in prompts]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while eng.decode_steps == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        eng.abort()
        for t in threads:
            t.join(300)
        cache = eng._cache
        if errors != ["ServingEngine aborted"] * len(prompts) or \
                any(t.is_alive() for t in threads):
            raise AssertionError(f"abort under load: {errors}")
        if cache.lens.any() or cache._n_blocks.any():
            raise AssertionError("abort left slots allocated")
        captured = eng.graph_captures
        eng.start()
        again = eng.generate(prompts[1], max_new_tokens=NEW_TOKENS,
                             timeout=600).numpy()
        if eng._cache is cache or eng.graph_captures <= captured:
            raise AssertionError("the restarted engine kept the old cache "
                                 "or captured no graph")
    with pt.ContinuousServingEngine(model, max_batch_size=ENGINE_SLOTS,
                                    max_len=2048, page_size=PAGE,
                                    token_budget=256,
                                    prefill_chunk_tokens=256) as fresh:
        want = fresh.generate(prompts[1], max_new_tokens=NEW_TOKENS,
                              timeout=600).numpy()
    if not np.array_equal(again, want):
        raise AssertionError("the engine restarted after abort serves "
                             "another stream than a fresh engine")
    log(f"  abort under load: {len(errors)} requests failed with "
        f"'ServingEngine aborted' after the first decode tick, slots freed; "
        f"start() served again on a new cache (graphs captured anew)")


# ---------------------------------------------------------------------------
# phases 3h and 3i: speculative decoding at full width
# ---------------------------------------------------------------------------

#: the drafted tokens a decode slot may take a tick, at full width
SPEC_K = 4


class LogitsProbe:
    """While on, keeps the fp32 logits row that each token of every
    engine came from, by (prompt, token index): the last draw of an index
    is the one emitted (a verify span's rejected positions are drawn
    again at the next tick). Patches the engine class's ``_token``."""

    def __init__(self, pt):
        self.cls, self.rows = pt.ContinuousServingEngine, {}
        self.patches = Patches()

    def __enter__(self):
        token = self.cls._token

        def kept(eng, row, logits, idx, greedy=None, offset=0):
            key = (row.prompt.tobytes(), len(row.generated) + offset)
            self.rows[key] = logits[idx].float().clone()
            return token(eng, row, logits, idx, greedy, offset)
        self.patches.swap(self.cls, "_token", kept)
        return self

    def __exit__(self, *exc):
        self.patches.restore()


def first_difference(prompts, on, off, rows_on, rows_off):
    """Where the spec-on streams first leave the spec-off ones: the
    prompt, the token index, both tokens, the logits gap between the
    verify position and the same position decoded alone (max |on - off|
    over the vocabulary) and each run's margin of its own token over the
    other's. None when the streams are equal."""
    for i, (p, a, b) in enumerate(zip(prompts, on, off)):
        diff = np.flatnonzero(a[0] != b[0])
        if not diff.size:
            continue
        t = int(diff[0]) - p.shape[0]
        key = (p.tobytes(), t)
        lo_on, lo_off = rows_on[key], rows_off[key]
        ta, tb = int(a[0, p.shape[0] + t]), int(b[0, p.shape[0] + t])
        return {"prompt": i, "token": t, "on": ta, "off": tb,
                "logits_max_abs_diff": float((lo_on - lo_off).abs().max()),
                "logits_scale": float(lo_off.abs().max()),
                "margin_on": float(lo_on[ta] - lo_on[tb]),
                "margin_off": float(lo_off[tb] - lo_off[ta])}
    return None


class DraftTimer:
    """Times every drafting prepass of a speculating engine's ticks
    (``_drafts``: the drafter's forwards, to a device sync), on the engine
    class while on."""

    def __init__(self, torch, pt):
        self.torch, self.cls, self.ms = torch, pt.ContinuousServingEngine, []
        self.patches = Patches()

    def __enter__(self):
        drafts, torch = self.cls._drafts, self.torch

        def timed(eng, *args):
            if eng._drafter is None:
                return drafts(eng, *args)
            t0 = time.perf_counter()
            out = drafts(eng, *args)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        self.patches.swap(self.cls, "_drafts", timed)
        return self

    def __exit__(self, *exc):
        self.patches.restore()


class ForwardEvents:
    """CUDA events around every tick forward (``_forward``: a graph's
    replay, after the warm-up captured it) of the engines made while on,
    by token bucket: the device's ms of the forward alone, without the
    tick's drafting and host work. Patches the engine class."""

    def __init__(self, torch, pt):
        self.torch, self.events = torch, []
        self.cls = pt.ContinuousServingEngine
        self.patches = Patches()

    def __enter__(self):
        forward, torch = self.cls._forward, self.torch

        def timed(eng, key, ids, pos, cache):
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            out = forward(eng, key, ids, pos, cache)
            ev[1].record()
            self.events.append((int(np.asarray(ids).size), ev))
            return out
        self.patches.swap(self.cls, "_forward", timed)
        return self

    def __exit__(self, *exc):
        self.patches.restore()

    def ms_by_bucket(self, skip=0):
        """Mean device ms of the forwards after the first ``skip``, by
        token bucket."""
        self.torch.cuda.synchronize()
        by = {}
        for n, (a, b) in self.events[skip:]:
            by.setdefault(n, []).append(a.elapsed_time(b))
        return {n: float(np.mean(v)) for n, v in sorted(by.items())}


def spec_runs(torch, pt, kern, model, prompts, warm, kw, n_layers, key,
              label):
    """One setting of the 8-request load in order through the q-block
    engine with CUDA graphs, plainly (drafting timed) and traced: no
    capture in a counted run, a replay a tick, kernel 6 (B7, ``key``)
    ``n_layers`` times a tick, the trace's launches within the counted
    ones. Returns the outputs, the plain run's stats, the per-tick
    summary, the drafting ms of each drafting tick and the replayed
    forwards' device ms by token bucket (the counted run's: its ticks
    are the last forwards)."""
    timer, fwd = DraftTimer(torch, pt), ForwardEvents(torch, pt)
    with timer, fwd:
        outs, st, _ = graph_run(torch, pt, kern, model, prompts, warm, True,
                                kw)
    traced = graph_run(torch, pt, kern, model, prompts, warm, True, kw,
                       profile=True)[1]
    if st["captures"] or st["replays"] != st["ragged_steps"]:
        raise AssertionError(f"{label}: {st['captures']} captures, "
                             f"{st['replays']} replays over "
                             f"{st['ragged_steps']} ticks")
    if st["launches"][key] != n_layers * st["ragged_steps"]:
        raise AssertionError(f"{label}: {key} launched "
                             f"{st['launches'][key]} times over "
                             f"{st['ragged_steps']} ticks")
    check_outputs(prompts, outs, model.config.vocab_size, label)
    check_traced_launches(f"{label}, traced", traced)
    return dict(outs=outs, st=st, sum=tick_summary(st, traced),
                draft_ms=timer.ms,
                forward_ms=fwd.ms_by_bucket(len(fwd.events)
                                            - st["ragged_steps"]))


def spec_full_width(torch, pt, kern, model, prompts, warm, int8, n_layers,
                    draft_model, off):
    """Phase 3h (native bf16) and 3i (fully int8): the 8-request load in order
    through the q-block engine with CUDA graphs (``spec_runs``), speculative
    decoding on (``spec_k=SPEC_K``) with the n-gram drafter and with
    ``draft_model``, a two-layer model at the target's widths, against spec
    off (``off``: the same engine's plain graph run of 3f or 3g,
    ``graphs_against_eager``'s ``keep``). Verify ticks pad to the declared
    token buckets, so they replay the same graphs as every other tick.
    Random prompts over 128,256 tokens give the n-gram drafter little to
    find; the draft model drafts every tick it has room. For each drafter:
    drafted and accepted tokens, target forwards per generated token, the
    replayed verify tick against the plain decode tick, the device's busy
    time and idle share, generated tokens/s, and whether the streams equal
    spec off's (bf16 GEMMs may reduce in another order at another M, ROADMAP
    C23: reported, not held) with the logits gap at the first difference.
    Every drafted token that was not accepted must have rolled back, and the
    draft model must have drafted."""
    label = "int8" if int8 else "bf16"
    engine_kw = dict(kv_dtype="int8", weight_dtype="int8") if int8 else {}
    key = "qblock_q8" if int8 else "qblock"
    tiers = {"off": engine_kw,
             "ngram": dict(engine_kw, spec_decode=True, spec_k=SPEC_K),
             "draft model": dict(engine_kw, spec_decode=True, spec_k=SPEC_K,
                                 draft_model=draft_model)}
    runs = {name: spec_runs(torch, pt, kern, model, prompts, warm, kw,
                            n_layers, key, f"{label} spec {name}")
            for name, kw in tiers.items() if name != "off"}
    tokens = NEW_TOKENS * len(prompts)
    dec_off = off["sum"].get("decode_ticks")
    log(f"  {label} spec off: {off['st']['ragged_steps']} target forwards "
        f"({off['st']['ragged_steps'] / tokens:.4f} a generated token), "
        f"{tokens / off['st']['wall']:.1f} generated tokens/s; "
        f"{off['sum']['ticks']} replayed ticks, tick "
        f"{off['sum']['wall_ms']:.3f} ms, busy {off['sum']['busy_ms']:.3f} "
        f"ms, idle share {off['sum']['idle_share']:.4f}" + (
            "" if dec_off is None else
            f"; decode ticks {dec_off['ticks']}: {dec_off['wall_ms']:.3f} "
            f"ms" + ("" if dec_off["busy_ms"] is None else
                     f", busy {dec_off['busy_ms']:.3f} ms, idle share "
                     f"{dec_off['idle_share']:.4f}")))
    log(f"    spec off: replayed forwards' device ms by token bucket "
        f"{ {n: round(v, 4) for n, v in off['forward_ms'].items()} }")
    out = {"off": {"target_forwards": off["st"]["ragged_steps"],
                   "forwards_per_token": off["st"]["ragged_steps"] / tokens,
                   "tokens_per_s": tokens / off["st"]["wall"],
                   "forward_ms_by_bucket": off["forward_ms"],
                   "ticks": off["sum"]}}
    for name, run in runs.items():
        st, sp = run["st"], run["st"]["spec"]
        if sp["tokens_rolled_back"] != (sp["spec_drafted_tokens"]
                                        - sp["spec_accepted_tokens"]):
            raise AssertionError(f"{label} {name}: rolled back "
                                 f"{sp['tokens_rolled_back']} of {sp}")
        if name == "draft model" and not sp["spec_drafted_tokens"]:
            raise AssertionError(f"{label} {name}: nothing drafted {sp}")
        equal = all(np.array_equal(a, b) for a, b in zip(run["outs"],
                                                          off["outs"]))
        gap = None
        if not equal:
            rows = {}
            for which in ("off", name):
                with LogitsProbe(pt) as probe:
                    got = graph_run(torch, pt, kern, model, prompts, warm,
                                    True, tiers[which])[0]
                rows[which] = (got, probe.rows)
            gap = first_difference(prompts, rows[name][0],
                                   rows["off"][0], rows[name][1],
                                   rows["off"][1])
        drafted = sp["spec_drafted_tokens"]
        r = {"drafted": drafted, "accepted": sp["spec_accepted_tokens"],
             "acceptance": (sp["spec_accepted_tokens"] / drafted
                            if drafted else None),
             "rounds": sp["spec_rounds"],
             "draft_forwards": sp["spec_draft_forwards"],
             "draft_ticks": sp["spec_draft_ticks"],
             "tokens_rolled_back": sp["tokens_rolled_back"],
             "target_forwards": st["ragged_steps"],
             "forwards_per_token": st["ragged_steps"] / tokens,
             "tokens_per_s": tokens / st["wall"],
             "streams_equal": equal, "first_difference": gap,
             "buckets": sorted(st["forwards_by_m"]),
             "draft_ms_per_tick": (float(np.mean(run["draft_ms"]))
                                   if run["draft_ms"] else 0.0),
             "forward_ms_by_bucket": run["forward_ms"],
             "ticks": run["sum"],
             "launches": {k: v for k, v in st["launches"].items() if v}}
        out[name] = r
        dec = run["sum"].get("decode_ticks")
        acc = "none drafted" if r["acceptance"] is None \
            else f"{r['acceptance']:.4f}"
        log(f"  {label} spec on, {name} (k={SPEC_K}): drafted "
            f"{r['drafted']}, accepted {r['accepted']} ({acc}), "
            f"{r['rounds']} verify spans, {r['tokens_rolled_back']} tokens "
            f"rolled back; target forwards {r['target_forwards']} "
            f"({r['forwards_per_token']:.4f} a generated token); "
            f"{r['tokens_per_s']:.1f} generated tokens/s; draft forwards "
            f"{r['draft_forwards']} over {r['draft_ticks']} drafting ticks, "
            f"{r['draft_ms_per_tick']:.3f} ms of drafting a tick; token "
            f"buckets {r['buckets']}")
        sm = run["sum"]
        log(f"    replayed forwards' device ms by token bucket "
            f"{ {n: round(v, 4) for n, v in run['forward_ms'].items()} } "
            f"(spec off's decode tick: bucket {ENGINE_SLOTS})")
        log(f"    {sm['ticks']} replayed ticks, tick {sm['wall_ms']:.3f} ms, "
            f"busy {sm['busy_ms']:.3f} ms, idle share "
            f"{sm['idle_share']:.4f}" + (
                "" if dec is None else
                f"; verify (decode-only) ticks {dec['ticks']}: "
                f"{dec['wall_ms']:.3f} ms, window {dec['window_ms']:.3f} ms"
                + ("" if dec["busy_ms"] is None else
                   f", busy {dec['busy_ms']:.3f} ms, idle share "
                   f"{dec['idle_share']:.4f}")))
        log(f"    streams {'equal to' if equal else 'differ from'} spec "
            f"off's" + ("" if gap is None else
                        f": first at prompt {gap['prompt']} token "
                        f"{gap['token']} (spec on {gap['on']}, off "
                        f"{gap['off']}); logits at the verify position "
                        f"against the same position decoded alone: max abs "
                        f"diff {gap['logits_max_abs_diff']:.4e} of "
                        f"{gap['logits_scale']:.3f}, margins on "
                        f"{gap['margin_on']:.4e}, off "
                        f"{gap['margin_off']:.4e}"))
    return out


# ---------------------------------------------------------------------------
# phase 3k: serving under amp.auto_cast (ROADMAP C29)
# ---------------------------------------------------------------------------

#: the state 3k serves under: the reference's recipe for 16-bit serving, a
#: bf16 model inside ``amp.auto_cast(level="O2", dtype="bfloat16")``
AMP_O2 = dict(level="O2", dtype="bfloat16")
#: the one engine 3k runs under O1: the cached attention ops are on
#: neither list, so q stays fp32 there (the fp32 variants)
AMP_O1 = dict(level="O1", dtype="bfloat16")
#: the kernels with a ``<16-bit, float>`` variant (kernels 6, 8 and 4), by
#: counter name: the variant the main path takes, the forced other one,
#: the TPU kernel's line and the C template's name
MIXED_KERNELS = {
    "qblock": ("unit", "runtime", f"{REF}:215",
               "qblock_unit_kernel<T, float, 16>",
               "qblock_runtime_kernel<T, float>"),
    "token": ("cluster", "block", f"{REF}:389",
              "token_split_kernel<T, float, 16>", "token_kernel<T, float>"),
    "paged": ("cluster", "block",
              "paddle_tpu/ops/pallas/paged_attention.py:55",
              "paged_decode_split_kernel<T, float>",
              "paged_decode_kernel<T, float>")}
#: the 16-bit q dtypes of the new variants
MIXED_DTYPES = ("bfloat16", "float16")


class PromoteCounter:
    """While entered, counts the calls of ``amp.promote`` (the op sites'
    jnp-style promotion) and the weight copies they make: parameters of
    ``model`` returned in another dtype, a fresh fp32 copy of a bf16
    weight each call (C25's cost when a bf16 model serves without
    AMP)."""

    def __init__(self, amp, model):
        self.amp, self.params = amp, {id(p) for p in model.parameters()}
        self.calls = self.copies = 0

    def promote(self, *tensors):
        out = self.orig(*tensors)
        self.calls += 1
        self.copies += sum(id(a) in self.params and b is not a
                           for a, b in zip(tensors, out))
        return out

    def __enter__(self):
        self.orig = self.amp.promote
        self.amp.promote = self.promote
        return self

    def __exit__(self, *exc):
        self.amp.promote = self.orig
        self.params = set()


def amp_want(none, name, st):
    """The launches a native engine's run under O2 must count: the rule's
    variant of its attention kernel, every launch a ``<bf16, float>`` one
    (``*_mixed``); the legacy engine's flash-sized chunks on the
    tensor-core B1 (SDPA casts q, k and v to bf16 under O2)."""
    if name == "legacy":
        big = sum(n for size, n in st["chunk_buckets"].items() if size >= 128)
        n = N_LAYERS * st["decode_steps"]
        if not big or not n:
            raise AssertionError("O2 legacy: no flash-sized chunks or no "
                                 "decode steps")
        return dict(none, paged=n, paged_cluster=n, paged_mixed=n,
                    flash=N_LAYERS * big, flash_wgmma=N_LAYERS * big)
    n = N_LAYERS * st["steps"]
    variant = MIXED_KERNELS[name][0]
    return dict(none, **{name: n, f"{name}_{variant}": n,
                         f"{name}_mixed": n})


def serving_rate(st, prompts):
    """Generated tokens/s of a counted run of ``prompts``."""
    return NEW_TOKENS * len(prompts) / st["wall"]


def amp_graph_keys(torch, pt, amp, model, prompt):
    """One graph engine serves ``prompt`` outside and then inside O2 (four
    new tokens each): its one-token decode bucket is captured twice, one
    program a state (``amp.state_key``), the graph outside returning fp32
    logits (a bf16 model without AMP, C25) and the one inside bf16."""
    eng = pt.ContinuousServingEngine(model, max_batch_size=ENGINE_SLOTS,
                                     max_len=2048, page_size=PAGE,
                                     token_budget=256,
                                     prefill_chunk_tokens=256)
    keys = {}
    with eng:
        for state in ("outside", "inside"):
            with (amp.auto_cast(**AMP_O2) if state == "inside"
                  else contextlib.nullcontext()):
                keys[state] = amp.state_key()
                eng.generate(prompt, max_new_tokens=4, timeout=600)
    progs = {state: eng._programs.get((("ragged", 1), key))
             for state, key in keys.items()}
    if any(p is None or p.graph is None for p in progs.values()):
        raise AssertionError(f"graph keys: the decode bucket's programs by "
                             f"state {progs}")
    dtypes = {state: str(p.logits.dtype) for state, p in progs.items()}
    if dtypes != {"outside": "torch.float32", "inside": "torch.bfloat16"}:
        raise AssertionError(f"graph keys: logits by state {dtypes}")
    by_shape = Counter(shape for shape, _ in eng._programs)
    out = {"captures": eng.graph_captures, "replays": eng.graph_replays,
           "decode_bucket_programs": by_shape[("ragged", 1)],
           "logits_dtypes": dtypes}
    log(f"  graph keys: the one-token bucket captured under both states "
        f"({out['decode_bucket_programs']} programs), logits {dtypes}; "
        f"{out['captures']} captures, {out['replays']} replays in all")
    return out


def hold_mixed(torch, label, fn, q, rows, plain, variants):
    """The ``<16-bit, float>`` variants of one kernel on captured inputs
    (``fn(q, variant=)``, pages fp32): for bf16 and fp16 q and each
    variant (the rule's, then the other forced), the output bit-equal to
    the fp32 variant on the upcast q rounded to q's dtype; the fp32
    variant within 1e-5 of the plain version's largest magnitude; the
    16-bit output within one ulp plus 1e-5 of the max of the plain
    version (``ulp_err``).
    Returns the largest errors."""
    errs = {}
    for name in MIXED_DTYPES:
        dt = getattr(torch, name)
        qd = q.to(dt)
        ref32 = plain(qd.float())[rows]
        for variant in variants:
            out = fn(qd, variant)
            up = fn(qd.float(), variant)
            if out.dtype != dt:
                raise AssertionError(f"{label} {variant} {name}: "
                                     f"{out.dtype} out")
            same = torch.equal(out[rows].view(torch.int16),
                               up[rows].to(dt).view(torch.int16))
            if not same:
                raise AssertionError(f"{label} {variant} {name}: not the "
                                     f"fp32 variant's bits on the upcast q")
            e32 = float((up[rows] - ref32).abs().max())
            check(f"{label} {variant} fp32 variant vs plain", e32,
                  FP32_TOL * float(ref32.abs().max()))
            e, ratio = ulp_err(torch, out[rows], ref32,
                               FP32_TOL * float(ref32.abs().max()))
            check(f"{label} {variant} <{name}, float> vs {name}(fp32 plain)",
                  ratio, 1.0, "max error / (1 ulp + 1e-5 max)")
            errs[f"{variant}_{name}"] = e
    torch.cuda.synchronize()
    log(f"  {label}: the <bf16, float> and <fp16, float> variants "
        f"({', '.join(variants)}) bit-equal to the fp32 variant on the "
        f"upcast q")
    return errs


def mixed_ragged(torch, rpa, cap, label):
    """Kernels 6 and 8 on a captured O2 tick (bf16 q, fp32 pages): each
    ``<16-bit, float>`` variant held (``hold_mixed``; kernel 6 on the
    engines' fixed grid), C21 over the fp32 pages in fp32, bf16 and fp16,
    then the rule's variants timed beside the fp32 variant on the upcast
    q, the plain version and the bound (fp32 pages, fp32 arithmetic).
    Returns ``{impl: (errors, timing row)}``."""
    q, kp, vp, tbl, desc = (cap[k] for k in ("q", "kp", "vp", "tbl",
                                             "desc"))
    if q.dtype != torch.bfloat16 or kp.dtype != torch.float32:
        raise AssertionError(f"{label}: captured q {q.dtype}, pages "
                             f"{kp.dtype} (expected bf16 over fp32, C29)")
    scale = HEAD_DIM ** -0.5
    rows = torch.as_tensor(span_rows(desc[1], desc[2]), device=q.device)
    plans = {impl: rpa.make_plan(q.shape[0], *desc, tbl, PAGE, impl=impl,
                                 device=q.device, max_slots=ENGINE_SLOTS)
             for impl in rpa.IMPLS}
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    check_c21(torch, rpa, q, (kp, vp), plans, rows, f"{label} (O2)",
              mixed=True)
    bound = bound_ms(q, kp, tbl, desc, peak=FP32_FLOPS)
    out = {}
    for impl in rpa.IMPLS:
        rule, other = MIXED_KERNELS[impl][:2]
        errs = hold_mixed(
            torch, f"{label} {impl}",
            lambda qd, v, impl=impl: kern[impl](qd, kp, vp, plans[impl],
                                                scale, variant=v),
            q, rows, lambda q32, impl=impl: plain[impl](
                q32, kp, vp, plans[impl], scale), (rule, other))
        q32 = q.float()
        row = {"shape": f"{label}: q_lens {np.asarray(desc[2]).tolist()}, "
                        f"ctx {np.asarray(desc[3]).tolist()}, bf16 q over "
                        f"fp32 pages",
               "ms": time_ms(torch, lambda: kern[impl](q, kp, vp,
                                                       plans[impl], scale)),
               "fp32_variant_ms": time_ms(torch, lambda: kern[impl](
                   q32, kp, vp, plans[impl], scale)),
               "plain_ms": time_ms(torch, lambda: plain[impl](
                   q, kp, vp, plans[impl], scale), iters=10),
               **bound, "max_abs_err": errs[f"{rule}_bfloat16"],
               "max_abs_err_fp16": errs[f"{rule}_float16"],
               "other_variant_max_abs_err": errs[f"{other}_bfloat16"]}
        log(f"  {impl} <bf16, float> ({rule}) at the {label}: "
            f"{row['ms']:.4f} ms, the fp32 variant on the upcast q "
            f"{row['fp32_variant_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{row['bytes']} bytes, {row['flops']} FLOPs at fp32 peak), "
            f"library: none")
        out[impl] = row
    return out


def mixed_paged(torch, pa, cap, label):
    """Kernel 4 on a captured O2 decode step (bf16 q, fp32 pages): the
    ``<16-bit, float>`` cluster and block variants held
    (``hold_mixed``), the cluster one timed beside the fp32 variant on
    the upcast q, the plain version and the bound."""
    q, kp, vp, tables, ctx = (cap[k] for k in ("q", "kp", "vp", "tables",
                                               "ctx"))
    if q.dtype != torch.bfloat16 or kp.dtype != torch.float32:
        raise AssertionError(f"{label}: captured q {q.dtype}, pages "
                             f"{kp.dtype} (expected bf16 over fp32, C29)")
    scale = HEAD_DIM ** -0.5
    rows = torch.arange(q.shape[0], device=q.device)
    errs = hold_mixed(
        torch, f"{label} paged",
        lambda qd, v: pa.paged_attention(qd, kp, vp, tables, ctx,
                                         variant=v),
        q, rows, lambda q32: pa.paged_decode_plain(q32, kp, vp, tables, ctx,
                                                   scale),
        ("cluster", "block"))
    q32 = q.float()
    row = {"shape": f"{label}, bf16 q over fp32 pages, ctx "
                    f"{ctx.cpu().numpy().tolist()}",
           "ms": time_ms(torch, lambda: pa.paged_attention(
               q, kp, vp, tables, ctx)),
           "fp32_variant_ms": time_ms(torch, lambda: pa.paged_attention(
               q32, kp, vp, tables, ctx)),
           "plain_ms": time_ms(torch, lambda: pa.paged_decode_plain(
               q, kp, vp, tables, ctx, scale), iters=10),
           **paged_bound(q, kp, tables, ctx, peak=FP32_FLOPS),
           "max_abs_err": errs["cluster_bfloat16"],
           "max_abs_err_fp16": errs["cluster_float16"],
           "other_variant_max_abs_err": errs["block_bfloat16"]}
    log(f"  paged <bf16, float> (cluster) at the {label}: {row['ms']:.4f} "
        f"ms, the fp32 variant on the upcast q {row['fp32_variant_ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}: {row['bytes']} bytes, {row['flops']} FLOPs), "
        f"library: none")
    return row


def amp_serving(torch, pt, amp, gen, rpa, pa, kern, none, model, prompts,
                warm, static_prompts):
    """Phase 3k on the bf16 model (before 3e quantises it): under O2 bf16,
    the q-block, per-token and legacy engines and the static engine, each
    counted (``amp_want``: every attention launch a ``<bf16, float>``
    one), pools fp32 and logits bf16 (C25 under AMP, C29); the q-block
    engine under O1 bf16 (the fp32 variants); an eager instrumented
    q-block pass (layer 0's inputs of its mixed and pure-decode ticks,
    and ``PromoteCounter``: no weight copy) and legacy pass (a decode
    step's inputs); the q-block engine's replayed ticks, untraced and
    traced (``tick_summary``); the graph keys (``amp_graph_keys``); and
    the new variants held and timed on the captured inputs."""
    vocab = model.config.vocab_size
    out = {"runs": {}}
    with amp.auto_cast(**AMP_O2):
        for name, kw in GRAPH_PATHS.items():
            outs, st = serve(torch, pt, kern, model, prompts, warm, **kw)
            check_outputs(prompts, outs, vocab, f"O2 {name}")
            check_c25(f"O2 {name} engine", st["pool_dtypes"],
                      st["logits_dtypes"], logits_dtype="bfloat16")
            check_launches(f"O2 {name} engine", st["launches"],
                           amp_want(none, name, st))
            out["runs"][name] = (outs, st)
            log(f"  O2 {name}: {st['steps']} ticks, "
                f"{serving_rate(st, prompts):.1f} generated tokens/s, wall "
                f"{st['wall']:.3f} s")
        serve_static(torch, pt, kern, model, static_prompts)        # warm
        static_outs, static = serve_static(torch, pt, kern, model,
                                           static_prompts)
        check_outputs(static_prompts, static_outs, vocab, "O2 static")
        n = N_LAYERS * (NEW_TOKENS - 1)
        check_launches("O2 static engine", static["launches"],
                       dict(none, flash=N_LAYERS, flash_wgmma=N_LAYERS,
                            paged=n, paged_cluster=n, paged_mixed=n))
        out["static"] = static
        rate = NEW_TOKENS * len(static_prompts) / static["wall"]
        log(f"  O2 static: {rate:.1f} generated tokens/s "
            f"({static['wall']:.3f} s for the batch)")
    with amp.auto_cast(**AMP_O1):
        outs, st = serve(torch, pt, kern, model, prompts, warm)
        check_outputs(prompts, outs, vocab, "O1 qblock")
        check_c25("O1 qblock engine", st["pool_dtypes"], st["logits_dtypes"],
                  logits_dtype="bfloat16")
        n = N_LAYERS * st["steps"]
        check_launches("O1 qblock engine", st["launches"],
                       dict(none, qblock=n, qblock_unit=n))
        out["runs"]["O1 qblock"] = (outs, st)
        log(f"  O1 qblock: {serving_rate(st, prompts):.1f} generated tokens/s")
    probe = TickProbe(torch, gen, model, N_LAYERS)
    copies = PromoteCounter(amp, model)
    legacy_cap = decode_capture(gen, N_LAYERS)
    with amp.auto_cast(**AMP_O2):
        serve(torch, pt, kern, model, prompts, warm, probes=[probe, copies])
        serve(torch, pt, kern, model, prompts, warm, enable_ragged=False,
              probes=[legacy_cap])
        out["graphs"] = replayed_ticks(torch, pt, kern, model, prompts,
                                       warm, "O2 q-block",
                                       {"impl": "qblock"})
        static_fwd = ForwardTimer(torch, model)
        serve_static(torch, pt, kern, model, static_prompts,
                     probes=[static_fwd])
    out["static_forward_ms"] = static_fwd.times
    log(f"  O2 static, instrumented forwards (seq, ms): "
        + ", ".join(f"({n}, {ms:.2f})" for n, ms in static_fwd.times))
    if not copies.calls or copies.copies:
        raise AssertionError(f"O2: amp.promote made {copies.copies} weight "
                             f"copies in {copies.calls} calls")
    log(f"  O2 eager q-block pass: {copies.calls} promotions, "
        f"{copies.copies} weight copies")
    out["promote"] = {"calls": copies.calls, "copies": copies.copies}
    out["graph_keys"] = amp_graph_keys(torch, pt, amp, model, warm)
    out["rows"] = mixed_ragged(torch, rpa, probe.best, "captured O2 mixed "
                               "tick")
    decode = mixed_ragged(torch, rpa, probe.decode, "captured O2 "
                          "pure-decode tick")
    for impl, row in decode.items():
        out["rows"][impl]["other_shapes"] = [row]
    out["rows"]["paged"] = mixed_paged(torch, pa, legacy_cap.best,
                                       "captured O2 legacy decode step")
    return out


def amp_serving_int8(torch, pt, amp, qm, kern, none, model, prompts, warm):
    """Phase 3k on the fully-int8 model (after 3g and 3i): the q-block,
    per-token and legacy int8 engines under O2 bf16. The int8 Linear is
    the reference's op ``"int8_linear"``, so B10 takes bf16 x on all 225
    calls a forward: the tensor-core variants by M, none on the fp32
    ones; the attention kernels B7, B9, B5 take bf16 q over int8 pages;
    pools int8 with fp32 scales, logits bf16."""
    vocab = model.config.vocab_size
    out = {"runs": {}}
    with amp.auto_cast(**AMP_O2):
        for name, kw in INT8_PATHS.items():
            kw = dict(kw)
            kw["impl"] = kw.pop("ragged_impl", "qblock")
            outs, st = serve(torch, pt, kern, model, prompts, warm, **kw,
                             kv_dtype="int8", weight_dtype="int8")
            check_outputs(prompts, outs, vocab, f"O2 int8 {name}")
            check_c25(f"O2 int8 {name} engine", st["pool_dtypes"],
                      st["logits_dtypes"], quant=True,
                      logits_dtype="bfloat16")
            derived = {m: N_LINEARS * n for m, n in
                       sorted(st["forwards_by_m"].items())}
            if st["b10_by_m"] != derived:
                raise AssertionError(f"O2 int8 {name}: B10 by M "
                                     f"{st['b10_by_m']}, 225 x the forwards "
                                     f"by M {derived}")
            stream = N_LINEARS * sum(
                n for m, n in st["forwards_by_m"].items()
                if qm.matmul_variant(torch.bfloat16, m, 1, 4096)
                == "wgmma_stream")
            calls = N_LINEARS * st["forwards"]
            want = dict(none, int8_matmul=calls, int8_matmul_stream=stream,
                        int8_matmul_gemm=calls - stream)
            if name == "legacy":
                big = sum(n for size, n in st["chunk_buckets"].items()
                          if size >= 128)
                n = N_LAYERS * st["decode_steps"]
                want.update(paged_q8=n, paged_q8_cluster=n,
                            flash=N_LAYERS * big, flash_wgmma=N_LAYERS * big)
            else:
                n = N_LAYERS * st["steps"]
                variant = MIXED_KERNELS[name][0]
                want.update({f"{name}_q8": n, f"{name}_q8_{variant}": n})
            check_launches(f"O2 int8 {name} engine", st["launches"], want)
            out["runs"][name] = {"steps": st["steps"],
                                 "forwards": st["forwards"],
                                 "wall": st["wall"],
                                 "launches": st["launches"],
                                 "tokens_s": serving_rate(st, prompts),
                                 "b10": {"tensor_cores": calls,
                                         "stream": stream,
                                         "gemm": calls - stream, "fp32": 0}}
            log(f"  O2 int8 {name}: {st['steps']} ticks, "
                f"{serving_rate(st, prompts):.1f} generated tokens/s; B10 "
                f"{calls} calls, all on tensor cores ({stream} stream, "
                f"{calls - stream} GEMM), 0 fp32")
        out["graphs_qblock"] = replayed_ticks(
            torch, pt, kern, model, prompts, warm, "O2 int8 q-block",
            dict(impl="qblock", kv_dtype="int8", weight_dtype="int8"))
    return out


def replayed_ticks(torch, pt, kern, model, prompts, warm, label, path_kw):
    """Two graph runs of the load of (a) in order (``graph_run``), plain
    and traced: every tick a replay, the trace's kernels as counted, and
    the per-tick summary (``tick_summary``): tick ms, busy ms and idle
    share, by decode and mixed ticks, with the decode tick's device ms by
    kernel. Under the caller's AMP state."""
    clean = graph_run(torch, pt, kern, model, prompts, warm, True,
                      path_kw)[1]
    traced = graph_run(torch, pt, kern, model, prompts, warm, True,
                       path_kw, profile=True)[1]
    for st in (clean, traced):
        if st["captures"] or st["replays"] != st["ragged_steps"]:
            raise AssertionError(f"{label} graphs: {st['captures']} "
                                 f"captures, {st['replays']} replays, "
                                 f"{st['ragged_steps']} ticks")
    check_traced_launches(f"{label}, graphs, traced", traced)
    sm = tick_summary(clean, traced)
    log(f"  {label}, graphs: {sm['ticks']} ticks, tick "
        f"{sm['wall_ms']:.3f} ms, busy {sm['busy_ms']:.3f} ms, idle share "
        f"{sm['idle_share']:.4f}; " + "; ".join(
            f"{kind} ticks {k['ticks']}: tick {k['wall_ms']:.3f} ms "
            f"(median {k['wall_ms_median']:.3f}), window "
            f"{k['window_ms']:.3f} ms, busy "
            + ("n/a" if k["busy_ms"] is None else f"{k['busy_ms']:.3f}")
            + " ms, idle share "
            + ("n/a" if k["idle_share"] is None
               else f"{k['idle_share']:.4f}")
            for kind in ("decode", "mixed")
            if (k := sm.get(f"{kind}_ticks")) is not None))
    if sm["decode_ms_by_kernel"]:
        log(f"    device ms a replayed {label} decode tick by kernel (the "
            f"ten largest): " + ", ".join(
                f"{k} {v:.3f}" for k, v in sm["decode_ms_by_kernel"].items()))
    return sm


def amp_paths(srv):
    """3k's counted runs by path, for the kernels line's per-path counts
    (B1's tensor-core prefills, B5, B10): the ``<bf16, float>`` launches
    of kernel 4 are taken out of its cluster count (they have their own
    row)."""
    out = {}
    for name, c in (("amp_O2_legacy", srv["runs"]["legacy"][1]["launches"]),
                    ("amp_O2_static", srv["static"]["launches"]),
                    ("amp_O2_int8_legacy",
                     srv["int8"]["runs"]["legacy"]["launches"])):
        c = dict(c)
        for key in ("paged", "paged_cluster"):
            c[key] -= c["paged_mixed"]
        out[name] = c
    return out


def mixed_rows(srv):
    """The kernels line's entries of the ``<16-bit, float>`` variants of
    kernels 6, 8 and 4 (``amp_serving``'s timing rows): the rule's variant
    the O2 engines ran, with its launches on 3k's counted runs, the other
    variant (forced, held bit-equal too) under ``other_variant``."""
    runs = srv["runs"]
    launches = {
        "qblock": {"3k O2 q-block engine":
                   runs["qblock"][1]["launches"]["qblock_mixed"]},
        "token": {"3k O2 per-token engine":
                  runs["token"][1]["launches"]["token_mixed"]},
        "paged": {"3k O2 legacy engine":
                  runs["legacy"][1]["launches"]["paged_mixed"],
                  "3k O2 static engine":
                  srv["static"]["launches"]["paged_mixed"]}}
    names = {"qblock": ("ragged_qblock_mixed", QBLOCK_SOURCE,
                        RAGGED_LIBRARY),
             "token": ("ragged_token_mixed", SOURCE, RAGGED_LIBRARY),
             "paged": ("paged_decode_mixed", CSRC + "paged_attention.cu",
                       "none: no single PyTorch call reads a block-table "
                       "cache")}
    rows = []
    for key, row in srv["rows"].items():
        rule, other, ref_at, kernel, other_kernel = MIXED_KERNELS[key]
        name, source, library = names[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": ref_at, "variant": rule, "kernel": kernel,
                     "dtypes": "T = bf16 and fp16: q and out in T over "
                               "fp32 pages",
                     "launches": sum(launches[key].values()),
                     "launches_by_path": launches[key], **row,
                     "library_ms": None, "library": library,
                     "bit_equal_to_fp32_variant": True,
                     "other_variant": {
                         "variant": other, "kernel": other_kernel,
                         "launches": 0,
                         "max_abs_err": row["other_variant_max_abs_err"]}})
    return rows


def amp_serving_line(srv, runs, static, legacy, prompts, static_prompts):
    """Phase 3k's numbers beside the same loads without AMP (3a-3c):
    generated tokens/s per engine, the replayed O2 q-block ticks, the
    graph keys, the weight copies, and the int8 engines' B10 calls by
    variant."""
    new = NEW_TOKENS * len(prompts)
    return {
        "tokens_s": {
            "O2 bf16": {name: new / st["wall"]
                        for name, (_, st) in srv["runs"].items()
                        if name != "O1 qblock"},
            "O2 bf16 static": NEW_TOKENS * len(static_prompts)
            / srv["static"]["wall"],
            "O1 bf16 qblock": new / srv["runs"]["O1 qblock"][1]["wall"],
            "without AMP": {"qblock": new / runs["qblock"][1]["wall"],
                            "token": new / runs["token"][1]["wall"],
                            "legacy": new / legacy["wall"],
                            "static": NEW_TOKENS * len(static_prompts)
                            / static["wall"]},
            "O2 int8": {k: v["tokens_s"]
                        for k, v in srv["int8"]["runs"].items()}},
        "graphs_O2_qblock": srv["graphs"],
        "graphs_O2_int8_qblock": srv["int8"]["graphs_qblock"],
        "static_O2_forward_ms": srv["static_forward_ms"],
        "graph_keys": srv["graph_keys"],
        "weight_copies_O2": srv["promote"],
        "int8_b10": {k: v["b10"] for k, v in srv["int8"]["runs"].items()}}


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

#: device spin after each flush, in clock cycles (~0.2 ms at 1.98 GHz)
SPIN_CYCLES = 400_000


def time_ms(torch, fn, iters=50, warmup=5, spin=True):
    """Median ms of ``fn()`` over ``iters`` launches, CUDA events around
    each, with a 256 MiB write between launches to flush the 50 MB L2
    (in the engine the previous layer's weights and pools evict it). The
    device then spins for SPIN_CYCLES, so that the host has queued the
    launch before the start event runs: the time is the device's, not
    the host's enqueue (see ``host_us``). ``spin=False`` is the earlier
    timer, without the spin: B1's rows also report it (``ms_no_spin``),
    so that B1 times taken with it compare on one yardstick."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us(torch, fn, calls=50):
    """The host's time per call of ``fn()`` (microseconds, calls issued
    back to back, the device draining them behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def _bound(nbytes, flops, peak=BF16_FLOPS):
    """A timing row's bound: the larger of the two floors (bytes over
    3.35 TB/s, FLOPs over ``peak``: the 989 TFLOP/s bf16 tensor-core
    rate, or 67 TFLOP/s for fp32), which one it is, and the counts behind
    them."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops),
            "peak_tflops": peak / 1e12}


def peak_of(x):
    """The card's peak rate for ``x``'s type: fp32 outside the tensor
    cores, else the bf16 tensor-core rate."""
    return FP32_FLOPS if str(x.dtype) == "torch.float32" else BF16_FLOPS


def distinct_pages(tbl, rows, ctxs, page=PAGE):
    """Distinct pages that the contexts cover: the first ceil(ctx / page)
    table entries of each row, a page shared by rows counted once."""
    pages = set()
    for r, c in zip(rows, ctxs):
        pages.update(tbl[r, :-(-int(c) // page)].tolist())
    return len(pages)


def page_row_bytes(kp, quant):
    """Bytes of one K or V page row: the head_dim values in the pool's
    type, plus the fp32 scale of an int8 row."""
    return kp.shape[-1] * kp.element_size() + (4 if quant else 0)


def bound_ms(q, kp, tbl, desc, quant=False, peak=None):
    """Least time for this tick's ragged attention on an H100: the bytes
    it must move (q and out once, every K/V page the spans' contexts
    cover once with its scales when int8, the descriptors) against its
    flops (QK^T and PV for every visible key of every span token), at
    the shapes of ``q`` and the pages ``kp``; FLOPs at ``peak`` (None:
    ``peak_of(q)``)."""
    slots, starts, lens, ctxs = (np.asarray(a) for a in desc)
    el = q.element_size()
    heads, d = q.shape[1], q.shape[2]
    kv, page = kp.shape[0], kp.shape[2]
    flops = sum(4 * heads * d                          # keys each token sees
                * int(np.arange(c - ql + 1, c + 1).sum())
                for ql, c in zip(lens, ctxs))
    nbytes = (2 * q.numel() * el
              + 2 * distinct_pages(tbl, slots, ctxs, page) * kv * page
              * page_row_bytes(kp, quant) + tbl.nbytes + 4 * 4 * len(slots))
    return _bound(nbytes, flops, peak or peak_of(q))


def flash_bound(b, sq, sk, q_offset, el, flops_per_d=4, q_side=2,
                kv_side=2, row_floats=1, peak=BF16_FLOPS):
    """Least time for causal flash attention work on an H100: the larger
    of its bytes (``q_side`` query-shaped and ``kv_side`` kv-shaped
    tensors once in their dtype, ``row_floats`` fp32 per query row and
    head) over 3.35 TB/s and its FLOPs over 989 TFLOP/s. FLOPs count the
    visible (query, key) pairs only: query i sees min(sk, q_offset + i +
    1) keys, and each pair costs ``flops_per_d`` x d flops for each query
    head. The forward reads q, k, v and writes out and lse: 4 d a pair
    (a QK dot and a PV axpy). B2 reads q, k, v, dO, lse and delta and
    writes dq: 6 d (QK, dO V and dS K). B3 reads the same and writes dk
    and dv: 8 d (QK, dO V, P^T dO and dS^T Q)."""
    visible = np.clip(q_offset + np.arange(sq) + 1, 0, sk).sum()
    flops = flops_per_d * HEAD_DIM * N_HEADS * b * int(visible)
    nbytes = (el * (q_side * b * sq * N_HEADS + kv_side * b * sk * N_KV)
              * HEAD_DIM + 4 * row_floats * b * N_HEADS * sq)
    return _bound(nbytes, flops, peak)


#: the bounds of B2 and B3 (see ``flash_bound``)
BWD_BOUNDS = {"dq": dict(flops_per_d=6, q_side=3, kv_side=2, row_floats=2),
              "dkv": dict(flops_per_d=8, q_side=2, kv_side=4, row_floats=2)}


def paged_bound(q, kp, tables, ctx, quant=False, peak=None):
    """Least time for a paged decode step on an H100: bytes of q and out,
    of every distinct K/V page the contexts cover (read once, with its
    scales when int8) and of the tables, against 4 d flops per (query
    head, visible key) at ``peak`` (None: ``peak_of(q)``)."""
    tbl, c = tables.cpu().numpy(), ctx.cpu().numpy()
    el = q.element_size()
    nbytes = (2 * q.numel() * el
              + 2 * distinct_pages(tbl, range(len(c)), c) * N_KV * PAGE
              * page_row_bytes(kp, quant) + tbl.nbytes + c.nbytes)
    flops = 4 * HEAD_DIM * N_HEADS * int(c.sum())
    return _bound(nbytes, flops, peak or peak_of(q))


def time_flash(torch, fa, cap, label):
    """B1 on layer 0's captured inputs of a main-path call (as SDPA passed
    them to the kernel: the public ``[b, s, h, d]`` layout and strides,
    fp32 on the serving paths since C25), its plain
    version, and PyTorch's SDPA computing the same function on the same
    data in ``[b, h, s, d]``: ``is_causal`` where its top-left mask means
    the same thing (sq == sk), else an explicit bottom-right mask, built
    outside the timed call."""
    q, k, v, qo = cap["q"], cap["k"], cap["v"], cap["q_offset"]
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    if not cap["causal"]:
        raise AssertionError(f"{label}: the model's SDPA call is causal")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row = {"shape": f"{label}: b={b} sq={sq} sk={sk} q_offset={qo} causal "
                    f"GQA 32/8 d=128 {str(q.dtype).removeprefix('torch.')}"}
    out = fa.flash_attention(q, k, v, True, None, qo)
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(
        q, k, v, True, None, qo))
    row["ms_no_spin"] = time_ms(torch, lambda: fa.flash_attention(
        q, k, v, True, None, qo), spin=False)
    row["host_us"] = host_us(torch, lambda: fa.flash_attention(
        q, k, v, True, None, qo))
    row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(
        qt, kt, vt, True, None, qo), iters=10)
    row.update(flash_bound(b, sq, sk, qo, q.element_size(),
                           peak=FP32_FLOPS if q.dtype == torch.float32
                           else BF16_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] * 1e-9
    if sq == sk and qo == 0:
        kw = {"is_causal": True}
        row["library"] = "sdpa(is_causal=True, enable_gqa=True)"
    else:
        # query i sees keys 0 .. qo + i: the path's bottom-right alignment
        kw = {"attn_mask": torch.ones(sq, sk, dtype=torch.bool,
                                      device=q.device).tril(qo)}
        row["library"] = ("sdpa(attn_mask=bottom-right bool [sq, sk], "
                          "enable_gqa=True)")

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)
    row["library_vs_kernel_max_abs_diff"] = float(
        (lib().transpose(1, 2).float() - out.float()).abs().max())
    row["library_ms"] = time_ms(torch, lib)
    return row


RAGGED_LIBRARY = "none: no single PyTorch call computes ragged paged attention"


def time_ragged(torch, rpa, kern, plain, ticks, scale, quant=False):
    """Kernels 6 and 8 (or B7 and B9 over int8 pages) and their plain
    versions on each captured tick's layer-0 inputs, beside the tick's
    bound. ``ticks``: (label, capture, plans, errors by kernel). Returns
    one row per tick for each kernel; a q-block row is the fixed grid the
    engines launch (``max_slots=ENGINE_SLOTS``, the live unit count read
    on the device; its output held bit-equal to the live-units grid's),
    with the live-units grid's time on the same inputs beside it
    (``ms_live_grid``), and carries the per-token kernel's time on the
    same inputs (``per_token_ms``). The
    per-token row is the rule's kernel (the cluster variant, with its
    splits), beside the block variant, the parent's kernel, forced on the
    same inputs (``block_ms``), and at a pure-decode tick the cluster
    kernel at every split count of TOKEN_SPLITS (``ms_by_splits``)."""
    out = {impl: [] for impl in kern}
    for label, cap, plans, errs in ticks:
        scales = (cap["ks"], cap["vs"]) if quant else ()
        bound = bound_ms(cap["q"], cap["kp"], cap["tbl"], cap["desc"],
                         quant=quant)
        shape = (f"{label}: q_lens {np.asarray(cap['desc'][2]).tolist()}, "
                 f"ctx {np.asarray(cap['desc'][3]).tolist()}, "
                 f"{str(cap['q'].dtype).removeprefix('torch.')} q")
        for impl in kern:
            args = (cap["q"], cap["kp"], cap["vp"], *scales, plans[impl],
                    scale)
            pargs = (cap["q"], cap["kp"], cap["vp"], plans[impl], scale,
                     *scales)
            ms = time_ms(torch, lambda: kern[impl](*args))
            pms = time_ms(torch, lambda: plain[impl](*pargs), iters=10)
            out[impl].append({"shape": shape, "ms": ms, "plain_ms": pms,
                              **bound, "max_abs_err": errs[impl]["bf16"],
                              "max_abs_err_fp32": errs[impl]["fp32"]})
        fixed = rpa.make_plan(cap["q"].shape[0], *cap["desc"], cap["tbl"],
                              PAGE, impl="qblock", device="cuda",
                              max_slots=ENGINE_SLOTS)
        live = (cap["q"], cap["kp"], cap["vp"], *scales, plans["qblock"],
                scale)
        fargs = live[:-2] + (fixed, scale)
        if not torch.equal(kern["qblock"](*live), kern["qblock"](*fargs)):
            raise AssertionError(f"{label}: the fixed q-block grid's output "
                                 f"differs from the live-units grid's")
        row = out["qblock"][-1]
        row["ms_live_grid"] = row["ms"]
        row["ms"] = time_ms(torch, lambda: kern["qblock"](*fargs))
        row["grid_units"] = [int(fixed.dev["units"].shape[0]),
                             int(plans["qblock"].dev["units"].shape[0])]
        row = out["token"][-1]
        targs = (cap["q"], cap["kp"], cap["vp"], *scales, plans["token"],
                 scale)
        row["variant"], row["splits"] = rpa.token_variant(
            cap["q"], cap["kp"], cap["vp"], cap["tbl"].shape[1],
            rpa._sm_count(0), *scales)
        row["round_pages"] = rpa.token_round_pages(row["splits"])
        row["block_ms"] = time_ms(torch, lambda: kern["token"](
            *targs, variant="block"))
        row["speedup_over_block"] = row["block_ms"] / row["ms"]
        if np.all(np.asarray(cap["desc"][2]) == 1):
            row["ms_by_splits"] = {}
            for splits in TOKEN_SPLITS:
                with forced_token_splits(rpa, splits):
                    row["ms_by_splits"][splits] = time_ms(
                        torch, lambda: kern["token"](*targs,
                                                     variant="cluster"))
        out["qblock"][-1]["per_token_ms"] = row["ms"]
        for impl in kern:
            r = out[impl][-1]
            log(f"  {impl}{'_q8' if quant else ''} at the {label}: "
                f"{r['ms']:.4f} ms"
                + (f" (the fixed grid, {r['grid_units'][0]} units of which "
                   f"{r['grid_units'][1]} live; the live-units grid "
                   f"{r['ms_live_grid']:.4f} ms)" if impl == "qblock"
                   else "")
                + (f" ({r['variant']}, {r['splits']} splits; block, the "
                   f"parent's kernel, forced on the same inputs "
                   f"{r['block_ms']:.4f} ms, {r['speedup_over_block']:.2f}x"
                   + ("; cluster by splits " + ", ".join(
                       f"S={k} {v:.4f}" for k, v in
                       r["ms_by_splits"].items()) if "ms_by_splits" in r
                      else "") + ")" if impl == "token" else "")
                + f", plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']}: {r['bytes']} "
                f"bytes, {r['flops']} FLOPs), library: none")
    return out


def token_row(name, line, timed, launches, errs):
    """Kernel 8's or B9's entry of the kernels line: the cluster kernel,
    which the per-token paths run, timed on the captured ticks (``timed``,
    first the mixed one), with the block kernel (the parent's design, kept
    for the shapes the cluster kernel does not take; forced on the same
    inputs) under ``block_variant``. ``launches``: the per-token path's
    counts by variant; ``errs``: the forced variants' worst errors."""
    first, *other = timed
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{REF}:{line}", "variant": "cluster",
            "kernel": "token_split_kernel",
            "launches": launches["cluster"],
            "launches_by_variant": launches,
            **{k: v for k, v in first.items() if k != "block_ms"},
            "max_abs_err_fp16": errs["cluster_fp16"],
            "library_ms": None, "library": RAGGED_LIBRARY,
            "other_shapes": other,
            "block_variant": {
                "kernel": "token_kernel", "launches": launches["block"],
                "max_abs_err": errs["block_bf16"],
                "max_abs_err_fp32": errs["block_fp32"],
                "max_abs_err_fp16": errs["block_fp16"],
                "ms": first["block_ms"],
                "ms_other_shapes": [t["block_ms"] for t in other]}}


#: ``pa.SPLIT_BLOCKS_PER_SM`` values timed beside the rule's
SPLIT_TARGETS = (0, 1, 2, 3, 4)


def time_paged(torch, pa, cap, label):
    """B4 (native pages) or B5 (int8 pages, ``cap["ks"]`` set) on a
    captured decode step: the rule's kernel (``ms``, the cluster variant
    on the main path), the block variant forced on the same inputs
    (``block_ms``, the parent's kernel), the cluster kernel under the
    splits of SPLIT_TARGETS blocks an SM (``ms_by_splits``), its plain
    version and its bound."""
    row = {"shape": label}
    args = (cap["q"], cap["kp"], cap["vp"], cap["tables"], cap["ctx"])
    scales = (cap["ks"], cap["vs"]) if cap.get("ks") is not None else ()
    kw = dict(zip(("k_scales", "v_scales"), scales))
    row["variant"], row["splits"], row["stages"] = pa.decode_variant(
        cap["q"], cap["kp"], cap["vp"], cap["tables"].shape[1],
        pa._sm_count(0), *scales)
    row["ms"] = time_ms(torch, lambda: pa.paged_attention(*args, **kw))
    row["block_ms"] = time_ms(torch, lambda: pa.paged_attention(
        *args, variant="block", **kw))
    row["speedup_over_block"] = row["block_ms"] / row["ms"]
    rule, by_splits = pa.SPLIT_BLOCKS_PER_SM, {}
    try:
        for target in SPLIT_TARGETS:
            pa.SPLIT_BLOCKS_PER_SM = target
            splits = pa.paged_decode_splits(
                cap["q"].shape[0], cap["kp"].shape[0],
                cap["tables"].shape[1], pa._sm_count(0))
            if splits not in by_splits:
                by_splits[splits] = time_ms(torch, lambda: pa.paged_attention(
                    *args, variant="cluster", **kw))
    finally:
        pa.SPLIT_BLOCKS_PER_SM = rule
    row["ms_by_splits"] = by_splits
    row["plain_ms"] = time_ms(torch, lambda: pa.paged_decode_plain(
        *args, HEAD_DIM ** -0.5, *scales), iters=10)
    row.update(paged_bound(cap["q"], cap["kp"], cap["tables"], cap["ctx"],
                           quant=bool(scales)))
    row["library"] = "none: no single PyTorch call reads a block-table cache"
    row["library_ms"] = None
    return row


def log_paged(r):
    log(f"  {r['shape']}: {r['variant']} ({r['splits']} splits, "
        f"{r['stages']} stages) {r['ms']:.4f} ms; block, the parent's "
        f"kernel, forced on the same inputs {r['block_ms']:.4f} ms "
        f"({r['speedup_over_block']:.2f}x); cluster kernel by splits "
        + ", ".join(f"S={k} {v:.4f}" for k, v in r["ms_by_splits"].items())
        + f" ms; plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}: {r['bytes']} bytes at 3.35 TB/s, {r['flops']} "
        f"FLOPs), library: none")


def paged_row(name, line, errs, timed, key, by_path):
    """B4's or B5's entry of the kernels line: the cluster kernel, which
    every main path runs, timed on ``timed``'s captured steps, with the
    block kernel (the parent's design, kept for the shapes the cluster
    kernel does not take; forced on the same inputs) under
    ``block_variant``. ``key`` names the launch counts in ``by_path``."""
    first = timed[0]

    def launches(variant):
        return {path: c[f"{key}_{variant}"] for path, c in by_path.items()}

    return {"name": name, "route": "cuda",
            "source": CSRC + "paged_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/paged_attention.py:{line}",
            "variant": "cluster", "kernel": "paged_decode_split_kernel",
            "launches": sum(launches("cluster").values()),
            "launches_by_path": launches("cluster"),
            "max_abs_err": errs["cluster_bf16"],
            "max_abs_err_fp32": errs["cluster_fp32"],
            "max_abs_err_fp16": errs["cluster_fp16"],
            **{k: first[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library", "shape", "bytes", "flops", "splits", "stages",
                "ms_by_splits", "speedup_over_block")},
            "other_shapes": timed[1:],
            "block_variant": {
                "kernel": "paged_decode_kernel",
                "launches": sum(launches("block").values()),
                "launches_by_path": launches("block"),
                "max_abs_err": errs["block_bf16"],
                "max_abs_err_fp32": errs["block_fp32"],
                "max_abs_err_fp16": errs["block_fp16"],
                "ms": first["block_ms"],
                "ms_other_shapes": [t["block_ms"] for t in timed[1:]]}}


def simt_int8_matmul(torch, x, wq, ws):
    """B10's scalar kernel (``int8_matmul_kernel``) on any operands,
    launched directly and counted nowhere: the kernel every fp32 call
    took before the fp32 variants, timed beside them for the record."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    out = torch.empty((x.shape[0], wq.shape[0]), dtype=x.dtype,
                      device=x.device)
    _build.launch("ptt_int8_matmul", x.device,
                  [ctypes.c_int(_build.dtype_code(x.dtype))]
                  + [ctypes.c_void_p(t.data_ptr()) for t in (x, wq, ws, out)]
                  + [ctypes.c_int(v)
                     for v in (x.shape[0], wq.shape[0], x.shape[1])])
    return out


def time_int8_matmul(torch, qm, cap, label):
    """B10 on captured main-path inputs (x as the path gave it: bf16 at
    layer 0's q, k and v projections, fp32 after them since C25; a
    layer's int8 codes and scales) on the variant the main path took, its
    plain version, ``torch.matmul`` of x by the layer's dequantised
    ``.weight`` in x's dtype (cast and transposed outside the timed
    call); the host's time per call of B10 and of ``torch.matmul``
    (``host_us``). Bound: x, the codes, the scales and the output once,
    against 2 M N K flops at x's peak (int8 codes are exact in bf16); the
    rate is GB/s over those bytes where bytes bound it, TFLOP/s where
    operations do. ``row["fp32"]``: the same on fp32 copies of x (the
    inputs of every Linear after layer 0's q, k and v): the fp32 variant
    the rule names, its plan, plain version and bound at the fp32 peak,
    ``torch.matmul`` by the weight dequantised in fp32 (``q * scale``),
    and the scalar kernel (``simt_ms``)."""
    x, wq, ws, weight = cap["x"], cap["wq"], cap["ws"], cap["weight"]
    (m, k), n = x.shape, wq.shape[0]
    variant = qm.matmul_variant(x.dtype, m, n, k)
    dt = str(x.dtype).removeprefix("torch.")
    row = {"shape": f"{label}: M={m} K={k} N={n}, {dt} x, int8 w",
           "variant": variant,
           "plan": None if variant == "simt" else qm.split_plan(variant, m,
                                                                n, k)}
    out = qm.int8_matmul(x, wq, ws)
    row["ms"] = time_ms(torch, lambda: qm.int8_matmul(x, wq, ws))
    row["plain_ms"] = time_ms(torch, lambda: qm.int8_matmul_plain(x, wq, ws),
                              iters=10)
    el = x.element_size()
    row.update(_bound(x.numel() * el + wq.numel() + 4 * n + m * n * el,
                      2 * m * n * k, peak_of(x)))
    if row["bound_by"] == "bytes":
        row["gb_per_s"] = row["bytes"] / row["ms"] * 1e-6
    else:
        row["tflops"] = row["flops"] / row["ms"] * 1e-9
    wt = weight.detach().t().to(x.dtype)
    row["library"] = (f"torch.matmul(x, w.T), w the layer's dequantised "
                      f".weight in {dt}")
    row["library_ms"] = time_ms(torch, lambda: torch.matmul(x, wt))
    row["library_vs_kernel_max_abs_diff"] = float(
        (torch.matmul(x, wt).float() - out.float()).abs().max())
    row["host_us"] = host_us(torch, lambda: qm.int8_matmul(x, wq, ws))
    row["library_host_us"] = host_us(torch, lambda: torch.matmul(x, wt))
    x32 = x.float()
    v32 = qm.matmul_variant(torch.float32, m, n, k)
    fp32 = {"variant": v32, "plan": qm.split_plan(v32, m, n, k)}
    fp32["ms"] = row["ms"] if x32 is x else time_ms(
        torch, lambda: qm.int8_matmul(x32, wq, ws))
    fp32["plain_ms"] = row["plain_ms"] if x32 is x else time_ms(
        torch, lambda: qm.int8_matmul_plain(x32, wq, ws), iters=10)
    fp32.update(_bound(x32.numel() * 4 + wq.numel() + 4 * n + m * n * 4,
                       2 * m * n * k, FP32_FLOPS))
    w32 = (wq.float() * ws[:, None]).t()
    fp32["library"] = "torch.matmul(x, w.T), w = q * scale in fp32"
    fp32["library_ms"] = time_ms(torch, lambda: torch.matmul(x32, w32))
    del w32
    fp32["simt_ms"] = time_ms(torch, lambda: simt_int8_matmul(
        torch, x32, wq, ws), iters=10 if n > 100_000 else 30)
    row["fp32"] = fp32
    return row


def time_crossover(torch, qm, caps, ms=(16, 32, 48, 64),
                   variants=TENSOR_CORE_VARIANTS):
    """Both tensor-core variants (bf16 x) or both fp32 ones (fp32 x) at
    the M around their crossover, on the captured weights of q/o and
    gate/up with seeded x: ``{(K, N): {M: {variant: ms}}}``."""
    dev = caps[(4096, 4096, 8)]["wq"].device
    g = torch.Generator(device=dev).manual_seed(11)
    dt = torch.float32 if variants is FP32_VARIANTS else torch.bfloat16
    res = {}
    for (k, n) in ((4096, 4096), (4096, 14336)):
        cap = caps[(k, n, 8)]
        res[(k, n)] = {}
        for m in ms:
            x = torch.randn((m, k), generator=g, device=dev).to(dt)
            res[(k, n)][m] = {}
            for v in variants:
                with forced_variant(qm, v):
                    res[(k, n)][m][v] = time_ms(torch, lambda: qm.int8_matmul(
                        x, cap["wq"], cap["ws"]), iters=20)
    return res


def time_split_plan(torch, qm, caps, sms=(66, 132, 264)):
    """The stream variant at M = 8 on the captured inputs (as bf16) of
    every weight shape whose plan splits K, under the plan's target of
    0.5, 1 and 2
    blocks an SM (``PLAN_SMS`` 66, 132 and 264; the plan's own is 132):
    ``{(K, N): {PLAN_SMS: (splits, ms)}}``."""
    res = {}
    rule = qm.PLAN_SMS
    try:
        for (k, n, m), cap in sorted(caps.items()):
            if m != 8 or qm.split_plan("wgmma_stream", m, n, k)[2] < 2:
                continue
            res[(k, n)] = {}
            xb = cap["x"].bfloat16()          # the stream variant's dtype
            for s in sms:
                qm.PLAN_SMS = s
                res[(k, n)][s] = (
                    qm.split_plan("wgmma_stream", m, n, k)[2],
                    time_ms(torch, lambda: qm.int8_matmul(
                        xb, cap["wq"], cap["ws"]), iters=20))
    finally:
        qm.PLAN_SMS = rule
    return res


def sdpa_backends(torch, fn):
    """What one call of ``fn`` ran, from a ``torch.profiler`` trace of
    it: the SDPA operators (their names carry the backend, e.g.
    ``aten::_scaled_dot_product_flash_attention_backward``) and the
    attention kernels, by name (None if the trace shows neither)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key.split("(")[0].removeprefix("void ")
                    for e in prof.key_averages()
                    if any(w in e.key.lower() for w in
                           ("flash", "fmha", "attention", "cudnn",
                            "efficient"))
                    and not e.key.startswith("autograd::")})
    return names or None


def time_flash_train(torch, fa, cap):
    """B1, B2 and B3 on layer 0's inputs captured from a training step
    (bf16, the ``[b, s, h, d]`` views SDPA passes, and the dO autograd
    hands back), their plain versions on the same data in ``[b, h, s,
    d]``, and PyTorch's SDPA forward and backward (``is_causal``,
    ``enable_gqa``) on it, with the attention kernels its backward ran.
    Returns one row per kernel."""
    q, k, v, dout, qo = (cap[x] for x in ("q", "k", "v", "dout",
                                            "q_offset"))
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    el = q.element_size()
    shape = (f"train step layer 0: b={b} sq={sq} sk={sk} q_offset={qo} "
             f"causal GQA 32/8 d=128 bf16")
    if qo != 0 or sq != sk:
        raise AssertionError(f"{shape}: a training step's attention is "
                             f"square, so SDPA's is_causal means the same")
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous()
                      for x in (q, k, v, dout))
    rows = {}
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(*(x.transpose(1, 2)
                                                 for x in (q, k, v)),
                                               True, None, qo)
        delta = fa.bwd_delta(out, dout.transpose(1, 2))
        args = (lse, delta, True, None, qo, 0)
        rows["fwd"] = dict(
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, True, None,
                                                         qo)),
            ms_no_spin=time_ms(torch, lambda: fa.flash_attention(
                q, k, v, True, None, qo), spin=False),
            host_us=host_us(torch, lambda: fa.flash_attention(
                q, k, v, True, None, qo)),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
                qt, kt, vt, True, None, qo), iters=10),
            **flash_bound(b, sq, sk, qo, el))
        # the scalar variants on fp32 copies of the same inputs (the
        # fp32 paths' kernels; bf16 at head_dim 128 takes tensor cores)
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
        qt32, kt32, vt32, dt32 = (x.float() for x in (qt, kt, vt, dt))
        for key, kern_fn, plain_fn in (
                ("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain),
                ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain)):
            n_tc = kern_fn.wgmma_launches
            rows[key] = dict(
                ms=time_ms(torch, lambda: kern_fn(
                    q, k, v, dout, *args, kernel_layout=False)),
                plain_ms=time_ms(torch, lambda: plain_fn(
                    qt, kt, vt, dt, *args), iters=10),
                **flash_bound(b, sq, sk, qo, el, **BWD_BOUNDS[key]))
            if kern_fn.wgmma_launches == n_tc:
                raise AssertionError(f"bf16 {key} did not take tensor cores")
            rows[key]["tflops"] = rows[key]["flops"] / rows[key]["ms"] * 1e-9
            n_tc = kern_fn.wgmma_launches
            rows[f"{key}_simt"] = dict(
                ms=time_ms(torch, lambda: kern_fn(
                    q32, k32, v32, do32, *args, kernel_layout=False),
                    iters=10),
                plain_ms=time_ms(torch, lambda: plain_fn(
                    qt32, kt32, vt32, dt32, *args), iters=10),
                **flash_bound(b, sq, sk, qo, 4, peak=FP32_FLOPS,
                              **BWD_BOUNDS[key]))
            if kern_fn.wgmma_launches != n_tc:
                raise AssertionError(f"fp32 {key} took tensor cores")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["fwd"]["tflops"] = rows["fwd"]["flops"] / rows["fwd"]["ms"] * 1e-9
        rows["fwd"]["library_ms"] = time_ms(torch, lambda: sdpa(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        rows["fwd"]["library"] = "sdpa(is_causal=True, enable_gqa=True)"
        rows["fwd"]["library_vs_kernel_max_abs_diff"] = float(
            (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).float()
             - out.float()).abs().max())
    for suffix, ins, grads in (
            ("", (qt, kt, vt, dt), (q, k, v, dout)),
            ("_simt", (qt32, kt32, vt32, dt32), (q32, k32, v32, do32))):
        ql, kl, vl = (x.detach().requires_grad_(True) for x in ins[:3])
        lib_out = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), ins[3],
                                       retain_graph=True)
        lib_ms = time_ms(torch, lib_bwd, iters=50 if not suffix else 10)
        try:
            ran = sdpa_backends(torch, lib_bwd)
        except RuntimeError as e:      # the profiler may not see the card
            ran = f"not recorded ({e})"
        with torch.no_grad():
            dq = fa.flash_bwd_dq(*grads, *args, kernel_layout=False)
            dk, dv = fa.flash_bwd_dkv(*grads, *args, kernel_layout=False)
        lq, lk, lv = lib_bwd()
        diff = {n: float((a.transpose(1, 2).float() - r.float()).abs().max())
                for n, a, r in (("dq", dq, lq), ("dk", dk, lk),
                                ("dv", dv, lv))}
        for key in ("dq", "dkv"):
            rows[key + suffix].update(
                library_ms=lib_ms,
                library=(f"sdpa backward ({'fp32, ' if suffix else ''}"
                         f"is_causal=True, enable_gqa=True): dq, dk and dv "
                         f"in one call, the B2 + B3 pair"),
                library_kernels=ran, library_vs_kernel_max_abs_diff=diff)
        del lib_out, ql, kl, vl, dq, dk, dv, lq, lk, lv
    for r in rows.values():
        r["shape"] = shape
    return rows


class BackwardCapture:
    """Keeps the inputs of the last flash backward of a run (layer 0's,
    as backward walks the layers in reverse): q, k, v and dO cloned with
    their strides, and the call's offsets; every call must have the
    model's mask (``causal``)."""

    def __init__(self, fa, causal=True):
        self.fa, self.orig, self.best = fa, fa.flash_attention_bwd, None
        self.causal = causal

    def call(self, q, k, v, out, lse, dout, g_lse=None, causal=True,
             sm_scale=None, q_offset=0, kv_offset=0, kernel_layout=True):
        if kernel_layout or causal != self.causal or kv_offset:
            raise AssertionError(f"the model's SDPA calls flash attention "
                                 f"causal={self.causal}, in the public "
                                 f"layout, kv_offset 0")
        self.best = dict(q=q.clone(), k=k.clone(), v=v.clone(),
                         dout=dout.clone(), q_offset=q_offset,
                         causal=causal)
        return self.orig(q, k, v, out, lse, dout, g_lse, causal, sm_scale,
                         q_offset, kv_offset, kernel_layout)

    def __enter__(self):
        self.fa.flash_attention_bwd = self.call
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_bwd = self.orig


def train_step(torch, model, opt, sched, ids, labels,
               cast=contextlib.nullcontext, scaler=None,
               after_backward=None):
    """One Paddle-style eager step, each phase timed on the host clock up
    to a device sync: (loss, {phase: ms}, {phase: peak bytes}). The
    forward runs under ``cast()`` (an ``amp.auto_cast`` block, the
    PaddleNLP recipe); with a ``GradScaler`` the backward starts from the
    scaled loss and ``scaler.step`` steps the optimizer, or skips it on
    an inf/nan grad. ``after_backward(model)`` runs after the backward
    (to plant an inf or nan in a grad, or to check the unscale)."""
    ms, peak = {}, {}

    def phase(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        peak[name] = torch.cuda.max_memory_allocated()
        return out

    def forward():
        with cast():
            return model(ids, labels=labels)

    def backward():
        (loss if scaler is None else scaler.scale(loss)).backward()
        if after_backward is not None:
            after_backward(model)

    def optimize():
        if scaler is None:
            opt.step()
        else:
            scaler.step(opt)
        opt.clear_grad()
        sched.step()

    loss, _ = phase("forward", forward)
    phase("backward", backward)
    phase("optimizer", optimize)
    ms["step"] = ms["forward"] + ms["backward"] + ms["optimizer"]
    return float(loss.detach()), ms, peak


def trainer(torch, pt, fuse_step, level="O2", dtype="bfloat16",
            layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """A training phase's model (Llama-3-8B widths, ``layers`` layers,
    fp32 parameters from seed 0), its ``AdamW`` (global-norm clip, decay
    off for the norms, warmup into cosine decay; ``fuse_step`` as given),
    the repeated batch and the forward's AMP block. ``level="O2"``: the
    PaddleNLP recipe, ``amp.decorate(model, opt, level="O2", dtype=)``
    (parameters in ``dtype``, fp32 master weights) and each forward under
    ``amp.auto_cast(level="O2", dtype=)``; ``"O1"``: fp32 parameters,
    the forward under ``auto_cast(level="O1", dtype=)``; None: the model
    cast to ``dtype`` (``.to``) with master weights, no AMP."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lr_mod
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = layers
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0)
    if level is None and dtype != "float32":
        model.to(getattr(torch, dtype))
    model.train()
    # small rates, as at the start of a warmup: at 1e-4 the first step
    # already takes the repeated batch's loss from 12.6 to 2.2, and the
    # third to ~0, where it stops falling
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(2e-5, T_max=100), warmup_steps=2,
        start_lr=1e-5, end_lr=2e-5)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=level is None,
                apply_decay_param_fun=lambda n: "norm" not in n)
    opt.fuse_step = fuse_step
    if level == "O2":
        amp.decorate(model, opt, level="O2", dtype=dtype)

    def cast():
        if level is None:
            return contextlib.nullcontext()
        return amp.auto_cast(level=level, dtype=dtype)
    tokens = np.random.RandomState(21).randint(
        0, cfg.vocab_size, (batch, seq + 1))
    ids = torch.as_tensor(tokens[:, :-1], device="cuda")
    labels = torch.as_tensor(tokens[:, 1:], device="cuda")
    return cfg, model, opt, sched, ids, labels, cast


def counted_steps(torch, kern, model, opt, sched, ids, labels, label,
                  per_step, dispatch, cap=None, cast=contextlib.nullcontext):
    """TRAIN_STEPS steps, the launch counts zeroed before each and held to
    ``per_step`` after it, the engine's dispatches to ``dispatch`` a step;
    ``cap`` (a context) around the last. Returns the losses, times, peaks
    and summed launches."""
    losses, steps, peaks, total = [], [], [], None
    engine = opt._fused_engine
    for i in range(TRAIN_STEPS):
        zero_counts(kern)
        before = dict(engine.dispatches)
        with (cap if cap is not None and i == TRAIN_STEPS - 1
              else contextlib.nullcontext()):
            loss, ms, peak = train_step(torch, model, opt, sched, ids,
                                        labels, cast)
        counts = read_counts(kern)
        check_launches(f"{label} step {i}", counts, per_step)
        got = {k: engine.dispatches[k] - before[k] for k in before}
        if got != dispatch:
            raise AssertionError(f"{label} step {i}: dispatches {got}, "
                                 f"expected {dispatch}")
        total = counts if total is None else {n: total[n] + counts[n]
                                              for n in total}
        losses.append(loss)
        steps.append(ms)
        peaks.append(peak)
        log(f"  {label} step {i}: loss {loss:.6f}, " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in ms.items()) + ", peak GiB " + ", "
            .join(f"{k} {v / 2**30:.2f}" for k, v in peak.items()))
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: losses not finite and decreasing: "
                             f"{losses}")
    med = {k: float(np.median([s[k] for s in steps[1:]])) for k in steps[0]}
    return dict(losses=losses, steps=steps, peaks=peaks, median=med,
                launches=total)


def memory_by_category(model, peaks, base, label):
    """The step's peak (the largest phase peak) beside what lives then:
    what was allocated before the training phase began (``base``: the
    earlier phases' captured inputs), weights, grads, fp32 master
    weights and moments, the logits with the loss's fp32 copies (bf16
    logits, their fp32 upcast and log-softmax: 10 bytes a logit), and the
    rest (activations, temporaries)."""
    n = sum(p.numel() for p in model.parameters())
    cfg = model.config
    phase, peak = max(peaks.items(), key=lambda kv: kv[1])
    cats = {"before the phase": base, "weights": 2 * n, "grads": 2 * n,
            "masters": 4 * n, "moments": 8 * n,
            "logits": 10 * TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size}
    cats["rest"] = peak - sum(cats.values())
    log(f"  {label}: peak {peak / 2**30:.2f} GiB in the {phase}: " + ", "
        .join(f"{k} {v / 2**30:.2f}" for k, v in cats.items()) + " GiB")
    return dict(peak=peak, phase=phase, **cats)


def traced_step(torch, model, opt, sched, ids, labels,
                cast=contextlib.nullcontext):
    """One step whose forward, backward and optimizer each run under a
    CUDA-only ``torch.profiler`` trace of its own: per phase, the device's
    busy ms and ms by kernel name (the twelve largest)."""
    from torch.profiler import ProfilerActivity, profile
    out, state = {}, {}

    def forward():
        with cast():
            state["loss"], _ = model(ids, labels=labels)

    def optimize():
        opt.step()
        opt.clear_grad()
        sched.step()

    for name, fn in (("forward", forward),
                     ("backward", lambda: state["loss"].backward()),
                     ("optimizer", optimize)):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
        intervals = device_intervals(torch, prof)
        by_name = Counter()
        for a, b, kname in intervals:
            by_name[short_name(kname)] += (b - a) / 1e6
        window = ev[0].elapsed_time(ev[1])
        busy = union_ns(intervals) / 1e6
        # the trace drops records now and then; a phase whose traced
        # kernels cover under half its window is marked incomplete
        out[name] = dict(window_ms=window, busy_ms=busy,
                         complete=busy >= 0.5 * window,
                         kernels_ms=sum(by_name.values()),
                         by_kernel=dict(by_name.most_common(12)))
        log(f"  traced step, {name}: window {window:.2f} ms, device busy "
            f"{busy:.2f} ms" + ("" if out[name]["complete"] else
                                " (the trace lost records)")
            + "; by kernel: " + ", ".join(
                f"{k} {v:.2f}" for k, v in by_name.most_common(12)))
    return out


def optimizer_kernels(torch, ost, model, opt, ids, labels, cast):
    """On one more backward's grads (uncounted launches): K-B twice (the
    same bits) against an fp64 sum (1e-6 relative); K-A against its plain
    version on copies of a few parameters' state, bf16 with the master and
    fp32, with the clip's scale, and twice (the same bits); then K-A over
    the step's groups, K-B over every grad, their plain versions and K-B's
    library call, timed (the state drifts in place as they run)."""
    with cast():
        loss, _ = model(ids, labels=labels)
    loss.backward()
    del loss
    pg = [(p, p.grad) for p in opt._parameter_list]
    grads = [g for _, g in pg]
    kb = [ost.sum_squares_multi_tensor(grads) for _ in range(2)]
    if not torch.equal(kb[0], kb[1]):
        raise AssertionError("K-B: two runs differ")
    ref = sum(float(g.double().square().sum()) for g in grads)
    kb_err = abs(float(kb[0]) - ref) / ref
    check("K-B on the step's grads vs an fp64 sum (relative)", kb_err, 1e-6)
    scale = opt._grad_clip.global_scale(pg)
    params = dict(model.named_parameters())
    gen = torch.Generator(device=model.device)
    gen.manual_seed(12)
    # a tensor of no whole number of 8-element vectors: K-A's tail path
    odd = torch.randn(4099, device=model.device, generator=gen) * 0.02
    odd_state = {"master": odd.clone(), "moment1": odd * 0.01,
                 "moment2": (odd * 0.01).square()}
    picks = {0.1: ["llama.layers.0.self_attn.q_proj.weight",
                   "llama.layers.0.mlp.gate_proj.weight", "odd"],
             0.0: ["llama.layers.0.input_layernorm.weight",
                   "llama.norm.weight"]}
    ka_err, checked = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for wd, names in picks.items():
            p0, g0, st0 = [], [], []
            for n in names:
                if n == "odd":
                    st = odd_state
                    p, g = odd.bfloat16(), (odd * 3).bfloat16()
                else:
                    p, st = params[n], opt.state[params[n]]
                    g = p.grad
                if dtype == torch.float32:
                    p, g = st["master"], g.float()
                p0.append(p)
                g0.append(g)
                st0.append(st)
            t = opt.state[params[picks[0.0][0]]]["step"] + 1
            hp = ost.AdamHyper(opt.get_lr(), opt._beta1, opt._beta2,
                               opt._epsilon, wd, t, True)
            before = [(p.detach().clone(), st["master"].clone(),
                       st["moment1"].clone(), st["moment2"].clone())
                      for p, st in zip(p0, st0)]
            copies = []
            for _ in range(3):
                copies.append(ost.AdamGroup(
                    [p.detach().clone() for p in p0],
                    [st["master"].clone() if dtype != torch.float32 else None
                     for st in st0],
                    [st["moment1"].clone() for st in st0],
                    [st["moment2"].clone() for st in st0],
                    [True] * len(p0)))
            n0 = ost.adam_step_multi_tensor.launches
            ost.adam_step_multi_tensor(copies[0], g0, hp, scale)
            ost.adam_step_multi_tensor(copies[1], g0, hp, scale)
            ost.adam_step_multi_tensor_plain(copies[2], g0, hp, scale)
            if ost.adam_step_multi_tensor.launches != n0 + 2:
                raise AssertionError("K-A did not launch")
            bad = []
            for what in ("params", "masters", "moment1s", "moment2s"):
                for i, (a, b, c, name) in enumerate(zip(
                        getattr(copies[0], what), getattr(copies[1], what),
                        getattr(copies[2], what), names)):
                    if a is None:
                        continue
                    if not torch.equal(a, b):
                        raise AssertionError(f"K-A {dtype} {name} {what}: "
                                             f"two launches differ")
                    err = float((a.float() - c.float()).abs().max())
                    ka_err = max(ka_err, err)
                    checked += a.numel()
                    if not torch.equal(a, c):
                        bad.append((what, name, i, int((a != c).sum()), err,
                                    int((a != c).flatten().nonzero()[0])))
            if bad:
                # the first differing element, its inputs and both results
                what, name, i, _, _, e = bad[0]
                row = {"scale": float(scale), "g": float(
                    g0[i].flatten()[e].float())}
                for k, t in zip(("p", "master", "m", "v"), before[i]):
                    row[f"{k}_in"] = float(t.flatten()[e].float())
                for tag, grp in (("kernel", copies[0]), ("plain", copies[2])):
                    for k in ("params", "masters", "moment1s", "moment2s"):
                        t = getattr(grp, k)[i]
                        if t is not None:
                            row[f"{k}_{tag}"] = float(t.flatten()[e].float())
                log("  K-A mismatch at element " + json.dumps(
                    {k: v.hex() for k, v in row.items()}))
                raise AssertionError(f"K-A {dtype} wd {wd} {hp}: elements "
                                     f"differ from the eager loop's ops "
                                     f"(slot, tensor, index, count, max abs, "
                                     f"first): {bad}")
            del copies, before
    log(f"  K-A on copies of {checked} state elements (bf16 with masters "
        f"and fp32, wd 0.1 and 0): bit for bit equal to the plain version "
        f"(the eager loop's ops), two launches equal; K-B {float(kb[0])!r} "
        f"vs fp64 {ref!r}, {kb_err:.3e} relative, two runs equal")
    # timing over the whole step, on the engine's own groups and tables
    groups, _ = opt._fused_engine.plan(pg)
    jobs = []
    for key, members in groups.items():
        lr_mult, wd, _, _, _, t = key
        jobs.append((opt._fused_engine._tables[key[:5]],
                     [g for _, g in members],
                     ost.AdamHyper(opt.get_lr() * lr_mult, opt._beta1,
                                   opt._beta2, opt._epsilon, wd, t, True)))
    n_el = sum(p.numel() for p, _ in pg)

    def ka():
        for grp, gl, hp in jobs:
            ost.adam_step_multi_tensor(grp, gl, hp, scale)

    def ka_plain():
        for grp, gl, hp in jobs:
            ost.adam_step_multi_tensor_plain(grp, gl, hp, scale)

    rows = {}
    rows["adam"] = dict(
        ms=time_ms(torch, ka, iters=20, warmup=2),
        plain_ms=time_ms(torch, ka_plain, iters=3, warmup=1),
        # per element: read g, the master, m, v; write them and p
        **_bound(n_el * (2 + 12 + 12 + 2), 15 * n_el, FP32_FLOPS),
        library_ms=None,
        library="none: torch.optim.AdamW(fused=True) decays after its "
                "Adam step and has no bf16 master round trip",
        max_abs_err=ka_err, groups=len(jobs), elements=n_el)
    lib = getattr(torch.nn.utils, "get_total_norm", None)
    rows["sumsq"] = dict(
        ms=time_ms(torch, lambda: ost.sum_squares_multi_tensor(grads),
                   iters=20, warmup=2),
        plain_ms=time_ms(torch, lambda: ost.sum_squares_multi_tensor_plain(
            grads), iters=5, warmup=1),
        **_bound(n_el * 2 + 4, 2 * n_el, FP32_FLOPS),
        library_ms=None if lib is None else time_ms(
            torch, lambda: lib(grads, 2.0), iters=20, warmup=2),
        library="torch.nn.utils.get_total_norm(grads) (the norm, the root "
                "of the same sum)" if lib is not None else "none",
        max_abs_err=abs(float(kb[0]) - ref), max_rel_err_fp64=kb_err,
        elements=n_el)
    for name, r in rows.items():
        lib_ms = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"  {name} over the step ({n_el} elements): {r['ms']:.4f} ms "
            f"({r['bytes'] / r['ms'] * 1e-6:.1f} GB/s), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']} bytes), library {lib_ms}")
    opt.clear_grad()
    return rows


def train(torch, pt, kern, fa, none, ost):
    """The training phase. The main path: TRAIN_STEPS steps of the
    PaddleNLP recipe (``amp.decorate(level="O2", dtype="bfloat16")``, each
    forward under ``amp.auto_cast(level="O2")``) with the fused
    optimizer (``AdamW`` with fuse_step on auto), K-A once a group and
    K-B twice a step, no eager dispatch; then one step with recompute, a
    traced step, and the optimizer kernels' checks and times on one more
    backward's grads. Then the same TRAIN_STEPS steps from the same seed
    with ``fuse_step = False`` (the eager loop; its clip sums through
    K-B): the losses within 1e-5 relative of the fused run's and every
    master weight within 1e-5 of its max. Returns the runs' numbers and
    layer 0's captured attention inputs of the fused run's last step."""
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg, model, opt, sched, ids, labels, cast = trainer(torch, pt, None)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    if not opt._use_fused(n_tensors):
        raise AssertionError(f"{n_tensors} parameters do not engage the "
                             f"fused step")
    log(f"  model: {TRAIN_LAYERS} layers, {n_params / 1e9:.3f} B params in "
        f"{n_tensors} tensors, batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    cap = BackwardCapture(fa)
    per_step = dict(none, flash=TRAIN_LAYERS, flash_wgmma=TRAIN_LAYERS,
                    flash_bwd_dq=TRAIN_LAYERS, flash_bwd_dkv=TRAIN_LAYERS,
                    flash_bwd_dq_wgmma=TRAIN_LAYERS,
                    flash_bwd_dkv_wgmma=TRAIN_LAYERS,
                    adam_step=TRAIN_GROUPS, sum_squares=2)
    fused = counted_steps(torch, kern, model, opt, sched, ids, labels,
                          "fused", per_step,
                          {"eager": 0, "fused": TRAIN_GROUPS}, cap, cast)
    fused["memory"] = memory_by_category(
        model, {k: max(p[k] for p in fused["peaks"][1:])
                for k in fused["peaks"][0]}, base, "fused step")
    # on the host, so that the eager run's peak memory is its own
    masters = {n: opt.state[p]["master"].cpu()
               for n, p in model.named_parameters()}
    model.config.use_recompute = True
    zero_counts(kern)
    loss, ms, _ = train_step(torch, model, opt, sched, ids, labels, cast)
    recompute = read_counts(kern)
    check_launches("fused step with recompute", recompute,
                   dict(per_step, flash=2 * TRAIN_LAYERS,
                        flash_wgmma=2 * TRAIN_LAYERS))
    log(f"  recompute step: loss {loss:.6f}, " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in ms.items()))
    model.config.use_recompute = False
    try:
        trace = traced_step(torch, model, opt, sched, ids, labels, cast)
    except RuntimeError as e:          # the profiler may not see the card
        log(f"  traced step: no trace ({e})")
        trace = None
    opt_rows = optimizer_kernels(torch, ost, model, opt, ids, labels, cast)
    fused.update(recompute=recompute, recompute_ms=ms, trace=trace,
                 capture=cap.best, n_params=n_params)
    del model, opt, sched
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model, opt, sched, ids, labels, cast = trainer(torch, pt, False)
    eager = counted_steps(torch, kern, model, opt, sched, ids, labels,
                          "eager", dict(per_step, adam_step=0),
                          {"eager": n_tensors, "fused": 0}, cast=cast)
    eager["memory"] = memory_by_category(
        model, {k: max(p[k] for p in eager["peaks"][1:])
                for k in eager["peaks"][0]}, base, "eager step")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(fused["losses"],
                                                      eager["losses"]))
    check("fused vs eager run: losses (relative)", loss_err, 1e-5)
    worst = (0.0, "")
    for n, p in model.named_parameters():
        ref = opt.state[p]["master"]
        err = float((masters[n].to(ref.device) - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        worst = max(worst, (err, n))
    check(f"fused vs eager run: master weights after {TRAIN_STEPS} steps "
          f"(relative to each one's max; worst {worst[1]})", worst[0], 1e-5)
    del model, opt, sched, masters
    gc.collect()
    torch.cuda.empty_cache()
    for name, run in (("fused", fused), ("eager", eager)):
        med = run["median"]
        log(f"  {name} steady step (median of steps 1-{TRAIN_STEPS - 1}): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
            + f"; {TRAIN_BATCH * TRAIN_SEQ / med['step'] * 1e3:.1f} "
            f"tokens/s; peak {run['memory']['peak'] / 2**30:.2f} GiB")
    return dict(fused, eager=eager, optimizer_rows=opt_rows,
                fused_vs_eager=dict(loss_rel=loss_err,
                                    master_rel=worst[0]))


# phase 3j: paddle.amp on the training step

#: 3j(a) O2 fp16 steps, 3j(b) O1 fp16 steps, at the training phase's widths
AMP_O2_STEPS, AMP_O1_STEPS = 4, 2
#: 3j(c): the bf16 model without AMP, at this many layers
NO_AMP_LAYERS = 2
#: 3j(d): the two-layer checks' sequence (batch 1), steps, and the steps
#: whose grads are planted with inf or nan (one element of one grad)
CHECK_SEQ, CHECK_STEPS = 512, 4
PLANTED = {1: float("inf"), 2: float("nan")}
#: the tensors a skipped step must leave as they were
WATCHED = ("llama.layers.0.mlp.down_proj.weight", "llama.norm.weight")


def watched_state(torch, model, opt):
    """Copies of the WATCHED parameters and their optimizer state (master,
    moments, step), where they exist yet."""
    params = dict(model.named_parameters())
    out = {}
    for name in WATCHED:
        p = params[name]
        out[name] = (p.detach().clone(), {
            k: v.clone() if torch.is_tensor(v) else v
            for k, v in opt.state.get(p, {}).items()})
    return out


def same_state(torch, a, b):
    for name in a:
        (pa, sa), (pb, sb) = a[name], b[name]
        if not torch.equal(pa, pb) or sa.keys() != sb.keys():
            return False
        for k in sa:
            if not (torch.equal(sa[k], sb[k]) if torch.is_tensor(sa[k])
                    else sa[k] == sb[k]):
                return False
    return True


def plant(value):
    """A step hook planting ``value`` (inf or nan) in one element of one
    grad."""
    def hook(model, scaler, opt):
        model.llama.layers[0].mlp.down_proj.weight.grad.view(-1)[7] = value
    return hook


def scaled_steps(torch, kern, none, run, steps, label, flash_variant,
                 layers, hooks=None):
    """``steps`` steps of ``run`` (a ``trainer`` tuple) under its AMP block
    and a ``GradScaler`` at its defaults, the launch counts zeroed before
    each: B1, B2, B3 ``layers`` times a step on ``flash_variant``
    ("wgmma": the tensor-core kernels; "simt": the scalar fp32 ones), K-A
    once a group and K-B twice on a step the scaler takes, none on one it
    skips, which must leave the watched parameters, masters, moments and
    step counts as they were. ``hooks`` maps a step to a function of the
    model, the scaler and the optimizer run after its backward (a
    :func:`plant`, a check). Returns per step the loss, whether it was
    skipped, the scale after it, times and peaks, and the summed
    launches."""
    from paddle_tpu_torch import amp
    cfg, model, opt, sched, ids, labels, cast = run
    scaler = amp.GradScaler()
    wg = flash_variant == "wgmma"
    rows, total = [], None
    for i in range(steps):
        hook = (hooks or {}).get(i)
        before = watched_state(torch, model, opt)
        zero_counts(kern)
        loss, ms, peak = train_step(
            torch, model, opt, sched, ids, labels, cast, scaler,
            None if hook is None else lambda m: hook(m, scaler, opt))
        counts = read_counts(kern)
        skipped = scaler._found_inf
        want = dict(none, flash=layers, flash_bwd_dq=layers,
                    flash_bwd_dkv=layers)
        if wg:
            want.update(flash_wgmma=layers, flash_bwd_dq_wgmma=layers,
                        flash_bwd_dkv_wgmma=layers)
        if not skipped:
            fused = opt._use_fused(len(opt._parameter_list))
            want.update(adam_step=TRAIN_GROUPS if fused else 0,
                        sum_squares=2)
        check_launches(f"{label} step {i}", counts, want)
        after = watched_state(torch, model, opt)
        if skipped and not same_state(torch, before, after):
            raise AssertionError(f"{label} step {i}: a skipped step changed "
                                 f"the watched state")
        if not skipped and same_state(torch, before, after):
            raise AssertionError(f"{label} step {i}: a taken step left the "
                                 f"watched state as it was")
        total = counts if total is None else {n: total[n] + counts[n]
                                              for n in total}
        rows.append(dict(loss=loss, skipped=skipped,
                         scale=scaler.get_scale_ratio(), ms=ms, peak=peak))
        log(f"  {label} step {i}: loss {loss:.6f}, "
            + ("skipped" if skipped else "taken")
            + f", scale after {scaler.get_scale_ratio():g}, " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in ms.items()) + ", peak GiB "
            + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in peak.items()))
    if not all(np.isfinite([r["loss"] for r in rows])):
        raise AssertionError(f"{label}: a loss is not finite")
    return dict(steps=rows, launches=total, scaler=scaler.state_dict())


def amp_trace(model, ids, labels, level, dtype):
    """The port's dtype trace of one forward and loss
    (``debugging.collect_operator_stats``): (op, input dtypes, cast
    dtypes) a call."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging
    with debugging.collect_operator_stats() as stats:
        with amp.auto_cast(level=level, dtype=dtype):
            model(ids, labels=labels)
    return stats.records


def amp_traces(torch, pt):
    """3j(d): the dtype traces under O1 fp16 and O2 bf16 of a two-layer
    model on the card (full width, fp32 parameters) and on the CPU (the
    same structure at head_dim 64, where
    ``tests/test_torch_amp.py`` holds the trace to the reference's), at 16
    tokens (the dense route) and 128 (the flash route): equal, op by
    op."""
    from paddle_tpu_torch import amp
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = 2
    card = pt.LlamaForCausalLM(cfg, device="cuda", seed=2)
    cpu = pt.LlamaForCausalLM(pt.llama_tiny(
        num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
        num_key_value_heads=1, intermediate_size=256,
        max_position_embeddings=256), device="cpu", seed=2)
    rng = np.random.RandomState(23)
    out = {}
    for level, dtype in (("O1", "float16"), ("O2", "bfloat16")):
        if level == "O2":
            for m in (card, cpu):
                amp.decorate(m, level="O2", dtype=dtype)
        for seq in (16, 128):
            toks = rng.randint(0, 128, (1, seq + 1))
            ids, labels = toks[:, :-1], toks[:, 1:]
            got = amp_trace(card, ids, labels, level, dtype)
            want = amp_trace(cpu, ids, labels, level, dtype)
            if got != want:
                bad = next(i for i, (a, b) in enumerate(zip(got, want))
                           if a != b) if len(got) == len(want) else None
                where = ((got[bad], want[bad]) if bad is not None
                         else (len(got), len(want)))
                raise AssertionError(f"dtype trace {level} {dtype} seq {seq}"
                                     f": the card's differs from the CPU's "
                                     f"at {bad}: {where}")
            route = sorted({op for op, _, _ in got} & {"sdpa", "flash_attn"})
            out[f"{level} {dtype} seq {seq}"] = dict(ops=len(got),
                                                     route=route)
            log(f"  dtype trace {level} {dtype} at {seq} tokens: {len(got)} "
                f"ops, route {route}, the card's equal to the CPU's")
    del card, cpu
    torch.cuda.empty_cache()
    return out


def check_unscale(torch):
    """A step's hook: the grads unscaled by ``scaler.unscale_`` (PyTorch's
    multi-tensor pass on the card) against ``(g.float() * inv).to(
    g.dtype)`` on clones, bit for bit. Returns the hook and its result."""
    res = {}

    def hook(model, scaler, opt):
        grads = list({id(p.grad): p.grad for p in opt._parameter_list
                      if p.grad is not None}.values())
        inv = 1.0 / scaler.get_scale_ratio()
        want = [(g.float() * inv).to(g.dtype) for g in grads]
        scaler.unscale_(opt)
        bits = {torch.float32: torch.int32, torch.float16: torch.int16,
                torch.bfloat16: torch.int16}
        res["differing"] = sum(int((g.view(bits[g.dtype])
                                    != w.view(bits[w.dtype])).sum())
                               for g, w in zip(grads, want))
        res["elements"] = sum(g.numel() for g in grads)
    return hook, res


def amp_phase(torch, pt, kern, none):
    """Phase 3j: ``paddle.amp`` on the training step at the training
    phase's widths. (a) O2 fp16 (``decorate``, fp16 parameters and fp32
    masters, each forward under ``auto_cast(level="O2",
    dtype="float16")``) with a default ``GradScaler``; (b) O1 fp16 on fp32
    parameters with a ``GradScaler``: the rope's fp32 q and k beside fp16
    v take flash's scalar fp32 kernels, as the reference's Pallas kernel
    computes them; (c) a bf16 model without AMP (``.to``), NO_AMP_LAYERS
    layers: fp32 logits, fp32 activations after layer 0's rope (C24), the
    scalar flash kernels; (d) two layers, fp32 parameters: the dtype
    traces equal the CPU's; O2 fp16 steps under the scaler with inf and
    nan planted in grads, skipped exactly there, the unscale bit for bit
    ``(g.float() * inv).to(g.dtype)``; and the fused run equal to the
    eager one (C22). Returns each run's numbers and launches."""
    out = {}
    phase("  3j(a): O2 fp16, decorate + auto_cast + GradScaler, "
          f"{TRAIN_LAYERS} layers")
    run = trainer(torch, pt, None, "O2", "float16")
    torch.cuda.reset_peak_memory_stats()
    out["O2 fp16"] = scaled_steps(torch, kern, none, run, AMP_O2_STEPS,
                                  "O2 fp16", "wgmma", TRAIN_LAYERS)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"  3j(b): O1 fp16 on fp32 parameters + GradScaler, {TRAIN_LAYERS}"
          f" layers")
    run = trainer(torch, pt, None, "O1", "float16")
    out["O1 fp16"] = scaled_steps(torch, kern, none, run, AMP_O1_STEPS,
                                  "O1 fp16", "simt", TRAIN_LAYERS)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"  3j(c): a bf16 model without AMP (.to), {NO_AMP_LAYERS} layers")
    cfg, model, opt, sched, ids, labels, cast = trainer(
        torch, pt, None, None, "bfloat16", layers=NO_AMP_LAYERS)
    with torch.no_grad():
        logits = model(ids[:, :128])
    dts = sorted({str(p.dtype) for p in model.parameters()})
    if logits.dtype != torch.float32 or dts != ["torch.bfloat16"] or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bf16 without AMP: logits {logits.dtype}, "
                             f"parameters {dts}")
    del logits
    zero_counts(kern)
    loss, ms, peak = train_step(torch, model, opt, sched, ids, labels)
    counts = read_counts(kern)
    check_launches("bf16 without AMP", counts, dict(
        none, flash=NO_AMP_LAYERS, flash_bwd_dq=NO_AMP_LAYERS,
        flash_bwd_dkv=NO_AMP_LAYERS, adam_step=TRAIN_GROUPS, sum_squares=2))
    if not np.isfinite(loss):
        raise AssertionError(f"bf16 without AMP: loss {loss}")
    log(f"  bf16 without AMP: bf16 parameters, fp32 logits; one step: loss "
        f"{loss:.6f}, " + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + ", peak GiB " + ", ".join(f"{k} {v / 2**30:.2f}"
                                   for k, v in peak.items()))
    out["bf16 no AMP"] = dict(steps=[dict(loss=loss, ms=ms, peak=peak)],
                              launches=counts)
    del model, opt, sched, ids, labels
    gc.collect()
    torch.cuda.empty_cache()

    phase("  3j(d): two layers, fp32 parameters, TF32 off: dtype traces, "
          "planted inf/nan, fused against eager under the scaler")
    out["traces"] = amp_traces(torch, pt)
    runs, masters = {}, {}
    for fuse in (None, False):
        run = trainer(torch, pt, fuse, "O2", "float16", layers=2, batch=1,
                      seq=CHECK_SEQ)
        hook, unscale = check_unscale(torch)
        label = "fused" if fuse is None else "eager"
        runs[label] = scaled_steps(
            torch, kern, none, run, CHECK_STEPS, f"2-layer O2 fp16 {label}",
            "wgmma", 2, hooks={0: hook, **{i: plant(v)
                                           for i, v in PLANTED.items()}})
        opt = run[2]
        masters[label] = {n: opt.state[p]["master"].cpu()
                          for n, p in run[1].named_parameters()}
        if unscale.get("differing") != 0:
            raise AssertionError(f"unscale on the card: {unscale}")
        log(f"  {label}: the card's unscale equals (g.float() * inv).to("
            f"g.dtype) on all {unscale['elements']} grad elements")
        skipped = [i for i, r in enumerate(runs[label]["steps"])
                   if r["skipped"]]
        if skipped != sorted(PLANTED):
            raise AssertionError(f"{label}: skipped steps {skipped}, planted "
                                 f"{sorted(PLANTED)}")
        del run, opt
        gc.collect()
        torch.cuda.empty_cache()
    fl = [r["loss"] for r in runs["fused"]["steps"]]
    el = [r["loss"] for r in runs["eager"]["steps"]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fl, el))
    check("3j(d) fused vs eager under the scaler: losses (relative)",
          loss_rel, 1e-5)
    worst, equal = (0.0, ""), True
    for n, ref in masters["eager"].items():
        got = masters["fused"][n]
        equal = equal and torch.equal(got, ref)
        err = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)
        worst = max(worst, (err, n))
    check(f"3j(d) fused vs eager under the scaler: master weights after "
          f"{CHECK_STEPS} steps (relative; worst {worst[1]})", worst[0], 1e-5)
    log(f"  fused vs eager: master weights bit for bit equal: {equal}; "
        f"skipped steps {sorted(PLANTED)} in both")
    out["checks"] = dict(runs=runs, loss_rel=loss_rel, master_rel=worst[0],
                         masters_equal=equal, planted=sorted(PLANTED))
    return out


def train_cross_check(torch, pt, fa, kern, none):
    """One training step's loss and gradients of a two-layer full-width
    fp32 model (TF32 off) through the kernels, against the same step with
    SDPA swapped, for this check only, to dense attention in autograd
    (``mha_reference``) on the card. Returns the worst relative error."""
    from paddle_tpu_torch.models import llama as llama_mod
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = 2
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=1)
    model.train()
    tokens = np.random.RandomState(22).randint(0, cfg.vocab_size, (2, 513))
    ids = torch.as_tensor(tokens[:, :-1], device="cuda")
    labels = torch.as_tensor(tokens[:, 1:], device="cuda")

    def dense(query, key, value, attn_mask=None, dropout_p=0.0,
              is_causal=False, training=True):
        if attn_mask is not None or (dropout_p and training):
            raise AssertionError("the model's SDPA call has no mask or "
                                 "dropout")
        qt, kt, vt = (x.transpose(1, 2) for x in (query, key, value))
        return fa.mha_reference(qt, kt, vt, causal=is_causal,
                                q_offset=key.shape[1] - query.shape[1]
                                ).transpose(1, 2)

    results = []
    sdpa = llama_mod.scaled_dot_product_attention
    for attention in (None, dense):
        if attention is not None:
            llama_mod.scaled_dot_product_attention = attention
        zero_counts(kern)
        try:
            loss, _ = model(ids, labels=labels)
            loss.backward()
        finally:
            llama_mod.scaled_dot_product_attention = sdpa
        results.append((float(loss.detach()),
                        {n: p.grad for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
        if attention is None:
            check_launches("fp32 step through the kernels", read_counts(kern),
                           dict(none, flash=2, flash_bwd_dq=2,
                                flash_bwd_dkv=2))
    (kl, kg), (dl, dg) = results
    check("fp32 2-layer step: loss, kernels vs dense attention (relative)",
          abs(kl - dl) / abs(dl), 1e-6)
    worst = max((grad_err(kg[n], dg[n]), n) for n in kg)
    check(f"fp32 2-layer step: every gradient, kernels vs dense attention "
          f"(relative to each one's max; worst {worst[1]})", worst[0], 1e-4)
    del model, results, kg, dg
    torch.cuda.empty_cache()
    return worst[0]


# phase 4: paths against each other


def cross_paths(pt, model, prompts):
    """Greedy streams of ``generate`` over both caches and of the engine's
    legacy scheduler and ragged ticks on both grids (q-block, per-token),
    one prompt at a time; all must be identical."""
    streams = {
        "generate": [model.generate(p[None], max_new_tokens=8).cpu().numpy()
                     for p in prompts],
        "generate_paged": [model.generate(p[None], max_new_tokens=8,
                                          use_paged_cache=True,
                                          page_size=PAGE).cpu().numpy()
                           for p in prompts]}
    for name, ragged, impl in (("legacy", False, "qblock"),
                               ("ragged", True, "qblock"),
                               ("ragged_token", True, "token")):
        eng = pt.ContinuousServingEngine(model, max_batch_size=4,
                                         max_len=1024, page_size=PAGE,
                                         enable_ragged=ragged,
                                         ragged_impl=impl)
        with eng:
            streams[name] = [eng.generate(p, max_new_tokens=8,
                                          timeout=600).numpy()
                             for p in prompts]
    for name, outs in streams.items():
        for p, a, b in zip(prompts, outs, streams["generate"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name} stream differs from generate "
                                     f"on a {p.shape[0]}-token prompt")
    log(f"  greedy streams identical across {sorted(streams)} on prompts "
        f"of {[p.shape[0] for p in prompts]} tokens")
    return streams["generate"]


INT8_PATHS = {"qblock": dict(ragged_impl="qblock"),
              "token": dict(ragged_impl="token"),
              "legacy": dict(enable_ragged=False)}


def cross_paths_int8(pt, model, prompts):
    """Greedy streams of the fully-int8 engine on its three schedulers,
    one prompt at a time; all must be identical. The first engine
    quantises the model's Linears, the others find none left."""
    streams, quantized = {}, []
    for name, kw in INT8_PATHS.items():
        eng = pt.ContinuousServingEngine(model, max_batch_size=4,
                                         max_len=1024, page_size=PAGE,
                                         kv_dtype="int8", weight_dtype="int8",
                                         **kw)
        quantized.append(eng.quantized_linears)
        with eng:
            streams[name] = [eng.generate(p, max_new_tokens=8,
                                          timeout=600).numpy()
                             for p in prompts]
    n_linear = 7 * model.config.num_hidden_layers + 1
    if quantized != [n_linear, 0, 0]:
        raise AssertionError(f"int8 engines quantised {quantized} Linears, "
                             f"expected {[n_linear, 0, 0]}")
    for name, outs in streams.items():
        for p, a, b in zip(prompts, outs, streams["qblock"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"int8 {name} stream differs from the "
                                     f"int8 q-block engine's on a "
                                     f"{p.shape[0]}-token prompt")
    log(f"  int8 greedy streams identical across {sorted(streams)} on "
        f"prompts of {[p.shape[0] for p in prompts]} tokens "
        f"({n_linear} Linears quantised by the first engine)")


#: phase 4(b)'s page sizes beside the engines' 16, by KV page type, and
#: the variant of kernel 6 / B7 the rule takes for each on the two-layer
#: fp32 model (fp32 pages of 32 outgrow the unit kernel's shared memory)
SMALL_PAGES = {"native": {PAGE: "unit", 8: "unit", 32: "runtime"},
               "int8": {PAGE: "unit", 8: "unit", 64: "runtime"}}


def page_engines(torch, pt, kern, model, prompts, warm):
    """Phase 4(b): the 8-request load in order through the q-block engine
    with CUDA graphs on a two-layer fp32 model (TF32 off) at the page
    sizes of SMALL_PAGES, native and int8 KV pages: the greedy streams of
    every page size equal the page-16 engine's, and the native ones
    ``generate``'s; kernel 6 (B7) launches twice a tick, every launch the
    variant SMALL_PAGES names. Returns each run's launches by (page,
    pages)."""
    n_layers = model.config.num_hidden_layers
    want = [model.generate(p[None], max_new_tokens=NEW_TOKENS).cpu().numpy()
            for p in prompts[:3]]
    out, streams = {}, {}
    for pages in ("native", "int8"):
        kw = {} if pages == "native" else dict(kv_dtype="int8")
        key = "qblock" if pages == "native" else "qblock_q8"
        for page, variant in SMALL_PAGES[pages].items():
            outs, st, _ = graph_run(torch, pt, kern, model, prompts, warm,
                                    True, kw, page=page)
            check_outputs(prompts, outs, model.config.vocab_size,
                          f"page {page} {pages}")
            other = "runtime" if variant == "unit" else "unit"
            n = n_layers * st["ragged_steps"]
            got = st["launches"]
            if got[key] != n or got[f"{key}_{variant}"] != n \
                    or got[f"{key}_{other}"] or st["captures"] \
                    or st["replays"] != st["ragged_steps"]:
                raise AssertionError(f"page {page} {pages}: launches "
                                     f"{got}, {st['captures']} captures, "
                                     f"{st['replays']} replays over "
                                     f"{st['ragged_steps']} ticks")
            streams[page, pages] = outs
            out[page, pages] = {k: v for k, v in got.items() if v}
            log(f"  page {page}, {pages} KV pages: {st['ragged_steps']} "
                f"replayed ticks, launches {out[page, pages]}")
        for page in SMALL_PAGES[pages]:
            for a, b in zip(streams[page, pages], streams[PAGE, pages]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"page {page} {pages}: a greedy "
                                         f"stream differs from page 16's")
    for a, b in zip(streams[PAGE, "native"], want):
        if not np.array_equal(a, b):
            raise AssertionError("the page-16 engine's stream differs from "
                                 "generate's")
    log(f"  greedy streams equal across page sizes "
        f"{ {k: sorted(v) for k, v in SMALL_PAGES.items()} }, and the native "
        f"ones to generate's on the first three prompts")
    return out


def short_prompts():
    """Eight prompts of 21-41 tokens, four sharing a 16-token prefix: with
    16 new tokens a history stays inside the draft model's 64-token
    window, so self-speculation drafts what the target decodes."""
    rng = np.random.RandomState(17)
    prefix = rng.randint(0, 128256, 16)
    prompts = [rng.randint(0, 128256, n) for n in (21, 33, 41, 27)]
    prompts += [np.concatenate([prefix, rng.randint(0, 128256, n)])
                for n in (9, 17, 25, 5)]
    warm = np.concatenate([prefix, rng.randint(0, 128256, 8)])
    return [p.astype(np.int64) for p in prompts], warm.astype(np.int64)


class WrongDrafter:
    """Always wrong, for all practical purposes: proposes the token after
    the history's last one, k times."""

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, history, k):
        return [(int(history[-1]) + 1) % self.vocab] * int(k)


def spec_cross_paths(torch, pt, kern, model):
    """Phases 4(d) and 4(e) on the two-layer fp32 model: the short load in
    order with graphs, spec off, self-speculation (``draft_model=`` the
    target) and an always-wrong drafter. Every stream equals spec off's
    and ``generate``'s; self-speculation accepts more than 0.9 of its
    drafts with fewer target forwards than generated tokens; the wrong
    drafter rolls back every draft."""
    prompts, warm = short_prompts()
    vocab = model.config.vocab_size
    runs = {}
    for name, kw in (("off", {}),
                     ("self", dict(spec_decode=True, spec_k=SPEC_K,
                                   draft_model=model)),
                     ("wrong", dict(spec_decode=True, spec_k=SPEC_K,
                                    drafter=WrongDrafter(vocab)))):
        outs, st, _ = graph_run(torch, pt, kern, model, prompts, warm, True,
                                kw)
        check_outputs(prompts, outs, vocab, f"spec {name}")
        runs[name] = (outs, st)
    for p, a in zip(prompts, runs["off"][0]):
        want = model.generate(p[None], max_new_tokens=NEW_TOKENS)
        if not np.array_equal(a, want.cpu().numpy()):
            raise AssertionError("spec off differs from generate")
    for name in ("self", "wrong"):
        for a, b in zip(runs[name][0], runs["off"][0]):
            if not np.array_equal(a, b):
                raise AssertionError(f"spec ({name} drafter) stream differs "
                                     f"from spec off's (fp32)")
    tokens = NEW_TOKENS * len(prompts)
    sp, st = runs["self"][1]["spec"], runs["self"][1]
    ratio = sp["spec_accepted_tokens"] / max(sp["spec_drafted_tokens"], 1)
    if ratio <= 0.9 or st["ragged_steps"] >= tokens \
            or st["decode_steps"] >= runs["off"][1]["decode_steps"]:
        raise AssertionError(f"self-speculation: acceptance {ratio}, "
                             f"{st['ragged_steps']} target forwards for "
                             f"{tokens} tokens")
    wp = runs["wrong"][1]["spec"]
    if not wp["spec_drafted_tokens"] or \
            wp["tokens_rolled_back"] < wp["spec_drafted_tokens"]:
        raise AssertionError(f"always-wrong drafter: {wp}")
    log(f"  spec fp32, 2 layers: streams equal spec off's and generate's "
        f"for self-speculation (drafted {sp['spec_drafted_tokens']}, "
        f"accepted {sp['spec_accepted_tokens']}, {ratio:.4f}; "
        f"{st['ragged_steps']} target forwards for {tokens} tokens against "
        f"{runs['off'][1]['ragged_steps']} spec off; "
        f"{sp['spec_draft_forwards']} draft forwards) and for the "
        f"always-wrong drafter (drafted {wp['spec_drafted_tokens']}, "
        f"accepted {wp['spec_accepted_tokens']}, rolled back "
        f"{wp['tokens_rolled_back']})")
    return {name: dict(st["spec"], target_forwards=st["ragged_steps"],
                       launches={k: v for k, v in st["launches"].items()
                                 if v})
            for name, (_, st) in runs.items()}


# ---------------------------------------------------------------------------
# phase 7: the ops layer on the card
# ---------------------------------------------------------------------------

def ops_inputs(seed=23):
    """The seeded numpy inputs of phase 7's op sample."""
    rng = np.random.RandomState(seed)
    a = rng.randn(64, 96).astype(np.float32)
    m = rng.randn(32, 32).astype(np.float32)
    return dict(
        a=a, b=rng.randn(64, 96).astype(np.float32),
        pos=rng.uniform(0.5, 2.0, (64, 96)).astype(np.float32),
        ints=rng.randint(0, 10, (64, 96)).astype(np.int64),
        ints2=rng.randint(1, 5, (64, 96)).astype(np.int64),
        vec=rng.randn(96).astype(np.float32),
        idx=rng.randint(0, 64, 20).astype(np.int64),
        rows=rng.permutation(64)[:12].astype(np.int64),
        upd=rng.randn(12, 96).astype(np.float32),
        nd_idx=rng.randint(0, 64, (10, 2)).astype(np.int64) % [64, 96],
        col_idx=rng.randint(0, 96, (64, 4)).astype(np.int64),
        bm1=rng.randn(8, 16, 32).astype(np.float32),
        bm2=rng.randn(8, 32, 24).astype(np.float32),
        p1=rng.rand(50, 3).astype(np.float32),
        p2=rng.rand(40, 3).astype(np.float32),
        ss=np.sort(rng.randn(128)).astype(np.float32),
        spd=(m @ m.T + 32 * np.eye(32)).astype(np.float32),
        small=(rng.randn(8, 8) * 0.3).astype(np.float32),
        rhs=rng.randn(32, 4).astype(np.float32),
        vol=rng.randn(2, 3, 16, 16).astype(np.float32))


def _lu_rebuilt(P, x):
    p, l_, u = P.linalg.lu_unpack(*P.linalg.lu(x))
    return p @ l_ @ u


#: phase 7's sample: (registry module, name, the call on tensors ``t``
#: of ``ops_inputs``); factorisations whose signs are not unique are
#: held by what they reconstruct or by their values
OPS_SAMPLE = [
    ("logic", "equal", lambda P, t: P.equal(t["ints"], t["ints2"])),
    ("logic", "greater_than", lambda P, t: P.greater_than(t["a"], t["b"])),
    ("logic", "logical_xor",
     lambda P, t: P.logical_xor(t["a"] > 0, t["b"] > 0)),
    ("logic", "bitwise_and", lambda P, t: P.bitwise_and(t["ints"],
                                                        t["ints2"])),
    ("logic", "argmax", lambda P, t: P.argmax(t["a"], axis=1)),
    ("logic", "argsort", lambda P, t: P.argsort(t["a"], axis=1)),
    ("logic", "topk", lambda P, t: P.topk(t["a"], 5)),
    ("logic", "kthvalue", lambda P, t: P.kthvalue(t["a"], 3, axis=1)),
    ("logic", "mode", lambda P, t: P.mode(t["ints"], axis=1)),
    ("logic", "searchsorted", lambda P, t: P.searchsorted(t["ss"],
                                                          t["vec"])),
    ("creation", "arange", lambda P, t: P.arange(0, 100, 3)),
    ("creation", "linspace", lambda P, t: P.linspace(-1.0, 1.0, 257)),
    ("creation", "eye", lambda P, t: P.eye(33, 17)),
    ("creation", "full_like", lambda P, t: P.full_like(t["a"], 2.5)),
    ("creation", "tril", lambda P, t: P.tril(t["a"], -2)),
    ("creation", "diag_embed", lambda P, t: P.diag_embed(t["vec"])),
    ("creation", "meshgrid", lambda P, t: P.meshgrid(t["vec"][:10],
                                                     t["vec"][:7])),
    ("creation", "vander", lambda P, t: P.vander(t["vec"][:12], 5)),
    ("math", "add", lambda P, t: P.add(t["a"], t["b"])),
    ("math", "divide", lambda P, t: P.divide(t["a"], t["pos"])),
    ("math", "floor_divide", lambda P, t: P.floor_divide(t["ints"] - 5,
                                                         t["ints2"])),
    ("math", "mod", lambda P, t: P.mod(t["ints"] - 5, t["ints2"])),
    ("math", "pow", lambda P, t: P.pow(t["pos"], 1.7)),
    ("math", "exp", lambda P, t: P.exp(t["a"])),
    ("math", "log1p", lambda P, t: P.log1p(t["pos"])),
    ("math", "tanh", lambda P, t: P.tanh(t["a"])),
    ("math", "erf", lambda P, t: P.erf(t["a"])),
    ("math", "clip", lambda P, t: P.clip(t["a"], -0.5, 0.5)),
    ("math", "sum", lambda P, t: P.sum(t["a"], axis=1)),
    ("math", "mean", lambda P, t: P.mean(t["a"], axis=[0, 1])),
    ("math", "prod", lambda P, t: P.prod(t["pos"][:, :8], axis=1)),
    ("math", "max", lambda P, t: P.max(t["a"], axis=0)),
    ("math", "logsumexp", lambda P, t: P.logsumexp(t["a"], axis=1)),
    ("math", "std", lambda P, t: P.std(t["a"], axis=1)),
    ("math", "median", lambda P, t: P.median(t["a"], axis=1)),
    ("math", "quantile", lambda P, t: P.quantile(t["a"], 0.3, axis=1)),
    ("math", "cumsum", lambda P, t: P.cumsum(t["a"], axis=1)),
    ("math", "cummax", lambda P, t: P.cummax(t["a"], axis=1)),
    ("math", "logcumsumexp", lambda P, t: P.logcumsumexp(t["a"], axis=1)),
    ("math", "matmul", lambda P, t: P.matmul(t["a"], t["b"],
                                             transpose_y=True)),
    ("math", "bmm", lambda P, t: P.bmm(t["bm1"], t["bm2"])),
    ("math", "einsum", lambda P, t: P.einsum("ij,kj->ik", t["a"], t["b"])),
    ("math", "cross", lambda P, t: P.cross(t["p1"][:40], t["p2"])),
    ("math", "cdist", lambda P, t: P.cdist(t["p1"], t["p2"])),
    ("math", "histogram", lambda P, t: P.histogram(t["a"], bins=20, min=-2,
                                                   max=2)),
    ("math", "bincount", lambda P, t: P.bincount(t["ints"].reshape(-1))),
    ("math", "lerp", lambda P, t: P.lerp(t["a"], t["b"], 0.3)),
    ("math", "kron", lambda P, t: P.kron(t["small"], t["small"])),
    ("manipulation", "reshape", lambda P, t: P.reshape(t["a"], [96, 64])),
    ("manipulation", "transpose", lambda P, t: P.transpose(t["bm1"],
                                                           [2, 0, 1])),
    ("manipulation", "concat", lambda P, t: P.concat([t["a"], t["b"]], 1)),
    ("manipulation", "split", lambda P, t: P.split(t["a"], [10, -1, 20])),
    ("manipulation", "roll", lambda P, t: P.roll(t["a"], 3, 1)),
    ("manipulation", "pad", lambda P, t: P.pad(t["vol"], [1, 2, 3, 4],
                                               mode="reflect")),
    ("manipulation", "gather", lambda P, t: P.gather(t["a"], t["idx"])),
    ("manipulation", "gather_nd", lambda P, t: P.gather_nd(t["a"],
                                                           t["nd_idx"])),
    ("manipulation", "scatter", lambda P, t: P.scatter(
        P.zeros_like(t["a"]), t["rows"], t["upd"])),
    ("manipulation", "index_add", lambda P, t: P.index_add(
        t["a"], t["rows"], 0, t["upd"])),
    ("manipulation", "put_along_axis", lambda P, t: P.put_along_axis(
        t["a"], t["col_idx"][:, :1], 9.0, 1)),
    ("manipulation", "take_along_axis", lambda P, t: P.take_along_axis(
        t["a"], t["col_idx"], 1)),
    ("manipulation", "masked_select", lambda P, t: P.masked_select(
        t["a"], t["b"] > 0)),
    ("manipulation", "where", lambda P, t: P.where(t["a"] > 0, t["a"],
                                                   t["b"])),
    ("manipulation", "nonzero", lambda P, t: P.nonzero(t["ints"] > 7)),
    ("manipulation", "unique", lambda P, t: P.unique(
        t["ints"], return_counts=True)),
    ("manipulation", "one_hot", lambda P, t: P.one_hot(t["ints"][0], 10)),
    ("manipulation", "unfold", lambda P, t: P.unfold(t["a"], 1, 8, 4)),
    ("manipulation", "repeat_interleave", lambda P, t: P.repeat_interleave(
        t["a"][:4], 3, axis=0)),
    ("linalg", "norm", lambda P, t: P.linalg.norm(t["a"], p=1, axis=1)),
    ("linalg", "inv", lambda P, t: P.linalg.inv(t["spd"])),
    ("linalg", "det", lambda P, t: P.linalg.det(t["small"])),
    ("linalg", "slogdet", lambda P, t: P.linalg.slogdet(t["spd"])),
    ("linalg", "solve", lambda P, t: P.linalg.solve(t["spd"], t["rhs"])),
    ("linalg", "cholesky", lambda P, t: P.linalg.cholesky(t["spd"])),
    ("linalg", "triangular_solve", lambda P, t: P.linalg.triangular_solve(
        P.tril(t["spd"]), t["rhs"], upper=False)),
    ("linalg", "qr", lambda P, t: P.matmul(*P.linalg.qr(t["a"][:, :32]))),
    ("linalg", "svd", lambda P, t: P.linalg.svd(t["a"])[1]),
    ("linalg", "eigh", lambda P, t: P.linalg.eigh(t["spd"])[0]),
    ("linalg", "lu", lambda P, t: _lu_rebuilt(P, t["spd"])),
    ("linalg", "matrix_power", lambda P, t: P.linalg.matrix_power(
        t["small"], 3)),
    ("linalg", "matrix_exp", lambda P, t: P.linalg.matrix_exp(t["small"])),
    ("linalg", "multi_dot", lambda P, t: P.linalg.multi_dot(
        [t["a"], t["b"].T, t["a"]])),
    ("linalg", "pinv", lambda P, t: P.linalg.pinv(t["a"][:16, :8])),
    ("linalg", "cov", lambda P, t: P.linalg.cov(t["a"][:8])),
]


def _flat_outputs(out):
    """An op's outputs as a list of numpy arrays."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat_outputs(o)]
    return [out.detach().cpu().numpy()]


def ops_phase(torch, pt):
    """Phase 7: the ops layer (``paddle_tpu_torch.ops``) on the card.
    With the default device, ``"gpu:0"``, creation and random ops land on
    CUDA; the CUDA generator reproduces a stream after the same ``seed``
    and gives another after another, and torch's global CUDA RNG is left
    as it was. Then every op of ``OPS_SAMPLE`` (at least 40, all five
    modules) runs on CUDA tensors and on CPU tensors (the device set to
    ``"cpu"`` for the second call) of the same seeded inputs: the same
    dtypes and shapes, floats within 1e-5 of the CPU result's largest
    magnitude (TF32 off), everything else exact."""
    from paddle_tpu_torch.framework import random as prandom
    if pt.get_device() != "gpu:0":
        raise AssertionError(f"default device {pt.get_device()}")
    made = {"zeros": pt.zeros([3, 4]), "full": pt.full([2], 7),
            "arange": pt.arange(5), "eye": pt.eye(3),
            "to_tensor": pt.to_tensor([1.0, 2.0]), "randn": pt.randn([4]),
            "randint": pt.randint(0, 9, [4]), "randperm": pt.randperm(6)}
    off = {k: str(v.device) for k, v in made.items()
           if v.device.type != "cuda"}
    if off:
        raise AssertionError(f"creation ops off the card: {off}")
    global_state = torch.cuda.get_rng_state()

    def draws():
        return [pt.randn([4096]), pt.rand([4096]),
                pt.randint(0, 100, [4096]), pt.randperm(1000),
                pt.bernoulli(pt.full([4096], 0.3)),
                pt.multinomial(pt.full([64], 1.0 / 64), 16),
                pt.normal(0.0, 2.0, [4096])]
    pt.seed(11)
    first = draws()
    pt.seed(11)
    again = draws()
    pt.seed(12)
    other = draws()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("the CUDA generator did not reproduce")
    if any(torch.equal(x, y) for x, y in zip(first, other)):
        raise AssertionError("another seed drew the same stream")
    if not torch.equal(torch.cuda.get_rng_state(), global_state):
        raise AssertionError("a random op drew from torch's global RNG")
    gen_dev = prandom.generator("cuda").device
    log(f"  creation and random ops on {sorted({str(v.device) for v in made.values()})};"
        f" 7 random ops reproduce under seed(11) on the {gen_dev} "
        f"generator, differ under seed(12); torch's global CUDA RNG "
        f"untouched")
    inputs = ops_inputs()
    dev_in = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    cpu_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
    worst, by_module, t0 = {}, Counter(), time.perf_counter()
    for module, name, call in OPS_SAMPLE:
        got = _flat_outputs(call(pt, dev_in))
        pt.set_device("cpu")
        try:
            want = _flat_outputs(call(pt, cpu_in))
        finally:
            pt.set_device("gpu:0")
        if [(g.dtype, g.shape) for g in got] != [(w.dtype, w.shape)
                                                 for w in want]:
            raise AssertionError(f"ops {name}: card "
                                 f"{[(g.dtype, g.shape) for g in got]}, cpu "
                                 f"{[(w.dtype, w.shape) for w in want]}")
        err = 0.0
        for g, w in zip(got, want):
            if np.issubdtype(w.dtype, np.floating):
                scale = max(float(np.abs(w).max()) if w.size else 0.0,
                            1e-30)
                err = max(err, float(np.abs(g - w).max()) / scale
                          if w.size else 0.0)
            elif not np.array_equal(g, w):
                raise AssertionError(f"ops {name}: the card's integer or "
                                     f"bool result differs from the CPU's")
        check(f"ops {module}.{name} card vs cpu", err, FP32_TOL,
              "max err / max")
        worst[name], by_module[module] = err, by_module[module] + 1
    if len(OPS_SAMPLE) < 40 or len(by_module) != 5:
        raise AssertionError(f"ops sample {dict(by_module)}")
    ops_s = time.perf_counter() - t0
    log(f"  {len(OPS_SAMPLE)} ops ({dict(by_module)}) on the card equal to "
        f"the CPU's: worst float error {max(worst.values()):.3e} of the "
        f"largest magnitude ({max(worst, key=worst.get)}), {ops_s:.2f} s")
    return dict(ops=len(OPS_SAMPLE), by_module=dict(by_module),
                worst=max(worst.values()), worst_op=max(worst, key=worst.get),
                seconds=ops_s, creation_devices=sorted(
                    {str(v.device) for v in made.values()}))


# ---------------------------------------------------------------------------
# phase 8: the nn surface, and PaddleClas ResNet-50 on CIFAR-10
# ---------------------------------------------------------------------------

#: 8(a): the functional case table's float tolerances, card against CPU
#: (TF32 off), relative to the CPU result's largest magnitude (at least 1)
NN_FWD_TOL, NN_GRAD_TOL = 1e-5, 1e-4
#: 8(b): bench.py's configuration, ``resnet50(num_classes=10)`` at batch
#: 256 on 3 x 32 x 32 images, 20 steps of PaddleClas's recipe
RESNET_BATCH, RESNET_STEPS, RESNET_CHECK_BATCH = 256, 20, 8
#: the fp32 check's floor: the card's distance from an fp64 run of the
#: same step may be ``RESNET_FACTOR`` times the CPU fp32's, or this
#: (relative to the fp64 tensor's largest magnitude); see
#: ``resnet_fp32_check``
RESNET_FACTOR, RESNET_FLOOR = 8.0, 1e-4


def held_to_f64(label, card_d, cpu_d, worst=None):
    """Phase 8's rule: the card's fp32 result at most RESNET_FACTOR times
    as far from the fp64 result as the CPU's fp32 result is, or
    RESNET_FLOOR (distances relative to the fp64 result's largest
    magnitude): sums on the card run in another order (atomic adds,
    cuSPARSE, cuBLAS, cuDNN), so bits are not compared. Returns the
    bound."""
    tol = max(RESNET_FACTOR * cpu_d, RESNET_FLOOR)
    where = f"; worst {worst}" if worst is not None else ""
    check(f"{label}: card vs fp64 (cpu fp32 {cpu_d:.3e}{where})", card_d,
          tol, "max err / max")
    return tol


def rel64(torch, got, want):
    """max |got - want| / max |want| in float64 on the CPU (0 for empty)."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if not want.numel():
        return 0.0
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def f64_held(torch, label, card, cpu32, f64):
    """``held_to_f64`` on three tensors: the card's fp32 result, the CPU's
    and the fp64 one. The fp64 result is the port's in float64, on the
    CPU or, where the CPU would take tens of seconds, on the card (its
    rounding is 2^-53, so its order of summation does not matter at
    these bounds)."""
    card_d, cpu_d = rel64(torch, card, f64), rel64(torch, cpu32, f64)
    held_to_f64(label, card_d, cpu_d)
    return {"card": card_d, "cpu": cpu_d}


def _nn_cases():
    """The functional case table of the CPU tests
    (``tests/torch_nn_cases.py``, numpy only)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_nn_cases
    return torch_nn_cases


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _run_case(torch, case, arrays, device):
    """A functional case on ``device``: (outputs, float-input grads), all
    as numpy, the grads of ``sum(out * cot)`` with the case's seeded
    cotangents when the case checks gradients."""
    from paddle_tpu_torch.nn import functional as F
    cases = _nn_cases()
    diff = {k for k, a in arrays.items() if case.grad
            and np.issubdtype(a.dtype, np.floating) and k not in case.nograd}
    t = {k: torch.from_numpy(a.copy()).to(device).requires_grad_(k in diff)
         for k, a in arrays.items()}
    outs = cases.flat_outputs(case.fn(F, t))
    got = [o.detach().cpu().numpy() for o in outs]
    grads = {}
    if diff:
        rng = np.random.RandomState(7)
        loss = sum((o * torch.from_numpy(np.asarray(
            rng.randn(*o.shape), np.float32)).to(device)).sum()
                   for o in outs if o.is_floating_point())
        loss.backward()
        grads = {k: (np.zeros(a.shape, np.float32) if t[k].grad is None
                     else t[k].grad.cpu().numpy())
                 for k, a in arrays.items() if k in diff}
    return got, grads


def functional_phase(torch, pt):
    """8(a): every case of the CPU tests' functional table on CUDA
    tensors against the same case on CPU tensors: dtypes and shapes
    equal, floats within ``NN_FWD_TOL`` (gradients ``NN_GRAD_TOL``) of the
    CPU result's largest magnitude, the rest exact. Returns the worst
    error per op."""
    cases = _nn_cases()
    worst, t0 = {}, time.perf_counter()
    for case in cases.CASES:
        arrays = cases.case_arrays(case)
        got, got_g = _run_case(torch, case, arrays, "cuda")
        pt.set_device("cpu")
        try:
            want, want_g = _run_case(torch, case, arrays, "cpu")
        finally:
            pt.set_device("gpu:0")
        name = cases.case_id(case)
        if [(g.dtype, g.shape) for g in got] != [(w.dtype, w.shape)
                                                 for w in want]:
            raise AssertionError(f"nn {name}: card "
                                 f"{[(g.dtype, g.shape) for g in got]}, cpu "
                                 f"{[(w.dtype, w.shape) for w in want]}")
        err = 0.0
        for g, w in zip(got, want):
            if np.issubdtype(w.dtype, np.floating):
                err = max(err, _rel_err(g, w))
            elif not np.array_equal(g, w):
                raise AssertionError(f"nn {name}: the card's integer or "
                                     f"bool result differs from the CPU's")
        check(f"nn {name} card vs cpu", err, NN_FWD_TOL, "max err / max")
        gerr = max([_rel_err(got_g[k], want_g[k]) for k in want_g] or [0.0])
        check(f"nn {name} grads card vs cpu", gerr, NN_GRAD_TOL,
              "max err / max")
        worst[case.op] = max(worst.get(case.op, 0.0), err, gerr)
    seconds = time.perf_counter() - t0
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {len(cases.CASES)} cases over {len(worst)} functional ops on "
        f"the card equal to the CPU's (TF32 off) in {seconds:.2f} s; worst "
        f"float error per op (forward and gradients, of the largest "
        f"magnitude): " + ", ".join(f"{k} {v:.3e}" for k, v in top))
    log(json.dumps({"nn_functional_worst": worst}))
    return dict(cases=len(cases.CASES), ops=len(worst), seconds=seconds,
                worst=max(worst.values()), worst_op=top[0][0])


def _resnet_batch(torch, n, seed, device):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, n).astype(np.int64))
    return x.to(device), y.to(device)


def _resnet_stages(torch, m):
    """ResNet's stem, four layers and head as ``(name, fn, modules)``."""
    def stem(h):
        return m.maxpool(m.relu(m.bn1(m.conv1(h))))

    def head(h):
        return m.fc(torch.flatten(m.avgpool(h), 1))
    return [("stem", stem, [m.conv1, m.bn1]), ("layer1", m.layer1, [m.layer1]),
            ("layer2", m.layer2, [m.layer2]), ("layer3", m.layer3, [m.layer3]),
            ("layer4", m.layer4, [m.layer4]), ("head", head, [m.fc])]


def _resnet_staged_step(torch, pt, model, x, y, ins=None, cots=None):
    """A train-mode step stage by stage: each stage on ``ins[k]`` (its own
    previous output when None) as a leaf, backward from the loss (last
    stage) or from ``cots[k]`` (the next stage's input gradient when
    None). Returns the inputs, the cotangents and, per stage, the output,
    the input's gradient and the parameters' gradients and BN buffers
    (float64, on the CPU)."""
    dev = next(iter(model.parameters())).device
    dt = next(iter(model.parameters())).dtype
    stages = _resnet_stages(torch, model)
    leaves, outs = [], []
    h = x.to(dev, dt)
    for k, (_, fn, _) in enumerate(stages):
        src = ins[k] if ins is not None else h
        leaf = src.detach().to(dev, dt).requires_grad_(True)
        leaves.append(leaf)
        outs.append(fn(leaf))
        h = outs[-1].detach()
    used, loss = [None] * len(stages), None
    for k in reversed(range(len(stages))):
        if k == len(stages) - 1:
            loss = pt.nn.CrossEntropyLoss()(outs[k], y.to(dev))
            loss.backward()
        else:
            c = cots[k] if cots is not None else leaves[k + 1].grad
            used[k] = c.detach().cpu()
            (outs[k] * c.to(dev, dt)).sum().backward()
    res = []
    for k, (name, _, mods) in enumerate(stages):
        tensors = {"out": outs[k], "in_grad": leaves[k].grad}
        if k == len(stages) - 1:
            tensors["out loss"] = loss
        for mod in mods:
            for n, p in mod.named_parameters():
                tensors[f"grad {n}"] = p.grad
            for n, b in mod.named_buffers():
                tensors[f"buffer {n}"] = b
        res.append((name, {n: t.detach().double().cpu()
                           for n, t in tensors.items()}))
    return [leaf.detach().cpu() for leaf in leaves], used, res


def resnet_fp32_check(torch, pt):
    """8(b) correctness: ResNet-50 (10 classes) seeded on the CPU and
    copied to the card and to an fp64 copy on the CPU; one train-mode
    step on the same 8 images in fp32 (TF32 off), stage by stage (the
    stem, the four layers, the head), every stage fed the CPU fp32 run's
    input and, backward, its cotangent. Per stage, the card's output (the
    head's: the logits and the loss), input gradient, parameter gradients and updated BN statistics: each
    group at most ``RESNET_FACTOR`` times as far from the fp64 copy's as
    the CPU fp32's own, or ``RESNET_FLOOR``. At this init the backward
    amplifies roundoff: the CPU's fp32 gradients differ from fp64 ones by
    2 % end to end and by up to 6.8e-4 inside ``layer1`` (measured on
    the CPU), so a fixed tolerance end to end would say nothing."""
    pt.set_device("cpu")
    try:
        pt.seed(3)
        cpu = pt.vision.models.resnet50(num_classes=10)
        card = copy.deepcopy(cpu).to("cuda")
        f64 = copy.deepcopy(cpu).double()
        x, y = _resnet_batch(torch, RESNET_CHECK_BATCH, 5, "cpu")
        ins, cots, want = _resnet_staged_step(torch, pt, cpu, x, y)
        _, _, exact = _resnet_staged_step(torch, pt, f64, x, y, ins, cots)
    finally:
        pt.set_device("gpu:0")
    _, _, got = _resnet_staged_step(torch, pt, card, x, y, ins, cots)

    def dist(a, b):
        return max(float((a[n] - b[n]).abs().max()
                         / b[n].abs().max().clamp_min(1e-30)) for n in a)

    errs = {}
    for (name, g), (_, w), (_, e) in zip(got, want, exact):
        for group in ("out", "in_grad", "grad", "buffer"):
            keys = [n for n in g if n.split(" ")[0] == group]
            if not keys:
                continue
            card_d = dist({n: g[n] for n in keys}, {n: e[n] for n in keys})
            cpu_d = dist({n: w[n] for n in keys}, {n: e[n] for n in keys})
            held_to_f64(f"resnet50 fp32 {name} {group}", card_d, cpu_d)
            errs[f"{name} {group}"] = dict(card=card_d, cpu=cpu_d)
    worst = max(errs, key=lambda k: errs[k]["card"])
    log(f"  ResNet-50 fp32 step at batch {RESNET_CHECK_BATCH} (TF32 off), "
        f"stage by stage against an fp64 copy: worst card distance "
        f"{errs[worst]['card']:.3e} ({worst}; the CPU fp32's "
        f"{errs[worst]['cpu']:.3e})")
    return errs


def _resnet_trace(torch, pt, model, x, y):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging
    with debugging.collect_operator_stats() as stats:
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            pt.nn.CrossEntropyLoss()(model(x), y)
    return stats.records


def _resnet_model(pt, seed):
    """ResNet-50 and its optimizer, decorated for O2 bf16. The rate is
    0.01: at 0.1 the first steps on one fixed batch overshoot (on the
    CPU at batch 16, fp32: a loss of 3.35, then 28.9)."""
    from paddle_tpu_torch import amp
    pt.seed(seed)
    model = pt.vision.models.resnet50(num_classes=10)
    opt = pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                parameters=model.parameters(),
                                weight_decay=pt.optimizer.L2Decay(1e-4))
    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def resnet_train(torch, pt, kern, smi):
    """8(b) training: PaddleClas's recipe on ResNet-50 at batch 256,
    ``RESNET_STEPS`` steps on one fixed seeded batch: ``decorate(O2,
    bf16)`` (the BatchNorms stay fp32), the forward and the loss under
    ``auto_cast``, ``Momentum(0.9, L2Decay(1e-4))`` on fp32 masters. The
    loss must stay finite and fall; the dtype trace of the step's forward
    and loss must equal the CPU's (ResNet-50 at batch 2); the kernel
    counts, zeroed before the steps, stay 0 (the path runs none of the
    port's kernels). Prints images/s, the median forward, backward and
    optimizer ms (each to a device sync), the steps' peak memory (above
    what is allocated when they begin) and the device ms by kernel of
    one profiled step."""
    from paddle_tpu_torch import amp
    model, opt = _resnet_model(pt, 1)
    model.train()
    x, y = _resnet_batch(torch, RESNET_BATCH, 9, "cuda")
    loss_fn = pt.nn.CrossEntropyLoss()
    card_trace = _resnet_trace(torch, pt, model, x[:2], y[:2])
    pt.set_device("cpu")
    try:
        cpu_model, _ = _resnet_model(pt, 1)
        xc, yc = _resnet_batch(torch, 2, 9, "cpu")
        cpu_trace = _resnet_trace(torch, pt, cpu_model, xc, yc)
    finally:
        pt.set_device("gpu:0")
    if card_trace != cpu_trace:
        raise AssertionError("resnet50 O2 dtype trace: card and CPU differ")
    log(f"  ResNet-50 O2 bf16 dtype trace: {len(card_trace)} ops, card equal "
        f"to CPU op by op")

    def step():
        t0 = time.perf_counter()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = loss_fn(model(x), y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return float(loss), ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                             (t3 - t2) * 1e3)

    zero_counts(kern)
    torch.cuda.synchronize()
    # earlier phases leave tensors alive: the steps' own peak is counted
    # above what is allocated when they start (ResNet-50 and the batch
    # included)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        loss, ms = step()
        losses.append(loss)
        times.append(ms)
    launches = read_counts(kern)
    peak = torch.cuda.max_memory_allocated() - base
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet50 losses not finite: {losses}")
    if not min(losses[-5:]) < losses[0]:
        raise AssertionError(f"resnet50 loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"resnet50 launched a port kernel: {launches}")
    timed = np.array(times[2:])
    fwd, bwd, optm = (float(np.median(timed[:, i])) for i in range(3))
    step_ms = float(np.median(timed.sum(1)))
    by_kernel = _resnet_profile(torch, step)
    line = dict(batch=RESNET_BATCH, steps=RESNET_STEPS, losses=losses,
                images_per_s=RESNET_BATCH / step_ms * 1e3, step_ms=step_ms,
                forward_ms=fwd, backward_ms=bwd, optimizer_ms=optm,
                peak_gib=peak / 2**30, base_gib=base / 2**30,
                trace_ops=len(card_trace),
                port_kernel_launches=sum(launches.values()), card=smi,
                device_ms_by_kernel=by_kernel)
    log(f"  ResNet-50 O2 bf16 at batch {RESNET_BATCH} ({smi}): losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {line['images_per_s']:.1f} "
        f"images/s; median step {step_ms:.2f} ms (forward {fwd:.2f}, "
        f"backward {bwd:.2f}, optimizer {optm:.2f}, each to a device "
        f"sync); peak memory {line['peak_gib']:.2f} GiB above the "
        f"{line['base_gib']:.2f} GiB allocated when the steps began")
    return line


def _resnet_profile(torch, step):
    """Device ms by kernel of one step (a CUDA-only trace): the top 15,
    the total and the idle share of that step's wall time, or ``"not
    measured"`` when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ms = step()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            rows.append((ev.key, us / 1e3, ev.count))
    if not rows:
        return "not measured"
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    wall = sum(ms)
    log(f"  ResNet-50 one O2 step, device ms by kernel (total "
        f"{total:.2f} ms over {sum(r[2] for r in rows)} launches in a "
        f"{wall:.2f} ms step: idle share {1 - total / wall:.3f}):")
    for name, t, n in rows[:15]:
        log(f"    {t:9.3f} ms  {n:5d}x  {name[:110]}")
    return {"total_ms": total, "step_ms": wall,
            "idle_share": 1 - total / wall,
            "top": [dict(kernel=k[:160], ms=t, count=n)
                    for k, t, n in rows[:15]]}


def nn_phase(torch, pt, kern, smi):
    """Phase 8: 8(a) the functional surface, 8(b) ResNet-50."""
    t0 = time.perf_counter()
    functional = functional_phase(torch, pt)
    fp32 = resnet_fp32_check(torch, pt)
    train = resnet_train(torch, pt, kern, smi)
    return dict(functional=functional, resnet_fp32=fp32, resnet=train,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 9: the training-loop surface on the card: paddle.io, jit.to_static
# (B1-B3 as custom ops in a compiled step) and hapi.Model
# ---------------------------------------------------------------------------

#: 9(a): steps after the compile step, compiled and eager
LOOP_STEPS = 10
#: 9(a): the O2 loss curves, compiled against eager, relative, every step
LOOP_O2_RTOL = 1e-2
#: 9(a): the fp32 copy (TF32 off): layers, the loss (relative) and every
#: gradient (against the largest), compiled against eager
LOOP_FP32_LAYERS, LOOP_FP32_LOSS_RTOL, LOOP_FP32_GRAD_TOL = 2, 1e-5, 1e-4
#: 9(b): ResNet-50 through ``Model.fit``: batch, steps, the in-memory
#: CIFAR-shaped set (batches' worth), workers, the steps one profile spans
HAPI_BATCH, HAPI_ITERS, HAPI_BATCHES, HAPI_WORKERS = 256, 20, 40, 4
#: 9(b): the bottleneck blocks kept of each of ResNet-50's four stages (3,
#: 4, 6 and 3): the first projects, the second has the identity shortcut.
#: At all 16 the compiled fit's first step (inductor's compile, on the
#: host) took 121.9-161.7 s and the whole script up to 1066.9 s of 1200
#: (NVIDIA H100 80GB HBM3, 700.00 W)
HAPI_BLOCKS = 2
HAPI_TRACE = (12, 14)
#: 9(b): the first fit step against a hand-written eager step of the
#: same network, optimizer and batch: its loss (relative), eager fit and
#: compiled fit
HAPI_EAGER_TOL, HAPI_COMPILED_TOL = 1e-6, 1e-4
#: 9(b): compiled fit's first update of BatchNorm's running statistics and
#: of the classifier head against the hand-written step's, each tensor's
#: change against its largest (eager fit's whole update must equal the
#: hand-written step's bit for bit under cuDNN's deterministic algorithms)
HAPI_UPDATE_TOL = 1e-4
#: the port's flash kernels, in an anonymous namespace of
#: ``csrc/flash_attention{,_bwd}.cu``
PORT_FLASH_KERNELS = {"flash_fwd_kernel", "flash_fwd_wgmma_kernel",
                      "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                      "flash_bwd_dq_wgmma_kernel",
                      "flash_bwd_dkv_wgmma_kernel"}
ATTENTION_WORDS = ("flash", "fmha", "sdpa", "attention")
#: inductor's pointwise, reduction and persistent-reduction kernels, named
#: after the aten ops they fuse
INDUCTOR_FUSED = ("triton_poi_", "triton_red_", "triton_per_")


class TokenData:
    """Seeded synthetic tokens: row ``i`` is (ids, labels), ``seq`` int64
    tokens each, labels the ids shifted by one."""

    def __init__(self, n, seq, vocab, seed):
        self.tokens = np.random.RandomState(seed).randint(0, vocab,
                                                          (n, seq + 1))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        row = self.tokens[i]
        return row[:-1], row[1:]


class ImageData:
    """A seeded in-memory CIFAR-shaped set: fp32 3 x 32 x 32 images in
    [0, 1) and int labels of 10 classes."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.x = rng.rand(n, 3, 32, 32).astype(np.float32)
        self.y = rng.randint(0, 10, n)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], int(self.y[i])


def foreign_attention(names):
    """Attention kernels of a trace that are not the port's: PyTorch's
    flash or memory-efficient kernels, cuDNN's, or an inductor template."""
    out = set()
    for n in names:
        base = short_name(n)
        if not any(w in n.lower() for w in ATTENTION_WORDS):
            continue
        if base.startswith(INDUCTOR_FUSED):
            continue
        if "(anonymous namespace)::" in n and base in PORT_FLASH_KERNELS:
            continue
        out.add(base)
    return sorted(out)


def traced_window(torch, fn):
    """``fn()`` under a CUDA-only trace: the window between two events
    around it (ms), the device's busy ms in it, the idle share and the
    kernel names."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
    return window_of(ev, device_intervals(torch, prof))


def window_of(events, intervals):
    window = events[0].elapsed_time(events[1])
    busy = union_ns(intervals) / 1e6
    return dict(window_ms=window, busy_ms=busy,
                idle_share=1 - busy / window if window > 0 else None,
                launches=len(intervals),
                names=sorted({n for _, _, n in intervals}))


def token_loader(pt, ds):
    """9(a)'s loader: ``DistributedBatchSampler`` with one replica,
    shuffled, two workers."""
    sampler = pt.io.DistributedBatchSampler(ds, TRAIN_BATCH, num_replicas=1,
                                            rank=0, shuffle=True)
    return pt.io.DataLoader(ds, batch_sampler=sampler, num_workers=2)


def loop_run(torch, pt, kern, ds, compiled):
    """1 + LOOP_STEPS steps of the Llama recipe (``trainer``: O2 bf16,
    fused AdamW, global-norm clip) on batches of ``token_loader``, the
    forward compiled by ``jit.to_static`` or eager; then one traced step.
    Returns losses, per-step ms, the loader's waits, launch counts, peak
    memory and the trace."""
    from paddle_tpu_torch.jit import api as jit_api
    cfg, model, opt, sched, _, _, cast = trainer(torch, pt, None)
    if compiled:
        jit_api.reset_metrics()
        pt.jit.to_static(model)
    zero_counts(kern)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    it = iter(token_loader(pt, ds))
    losses, steps, waits = [], [], []
    for _ in range(LOOP_STEPS + 1):
        t0 = time.perf_counter()
        ids, labels = next(it)
        waits.append((time.perf_counter() - t0) * 1e3)
        loss, ms, _ = train_step(torch, model, opt, sched, ids, labels, cast)
        losses.append(loss)
        steps.append(ms)
    counts = read_counts(kern)
    peak = torch.cuda.max_memory_allocated() - base

    def one_step():
        ids, labels = next(it)
        with cast():
            loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()

    trace = traced_window(torch, one_step)
    it.close()
    metrics = dict(jit_api.METRICS) if compiled else None
    del model, opt, sched, it
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: float(np.median([s[k] for s in steps[1:]])) for k in steps[0]}
    return dict(losses=losses, steps=steps, median=med, waits_ms=waits,
                launches=counts, peak_gib=peak / 2**30, trace=trace,
                metrics=metrics, layers=cfg.num_hidden_layers)


def loop_fp32_check(torch, pt, kern, none):
    """A two-layer fp32 copy at full width (TF32 off): one eager step,
    then the same step compiled; the loss within LOOP_FP32_LOSS_RTOL
    (relative) and every gradient within LOOP_FP32_GRAD_TOL of the
    largest eager gradient; the compiled step launches the scalar B1-B3
    once a layer."""
    from paddle_tpu_torch.jit import api as jit_api
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = LOOP_FP32_LAYERS
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    tokens = np.random.RandomState(41).randint(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ + 1))
    ids = torch.as_tensor(tokens[:, :-1], device="cuda")
    labels = torch.as_tensor(tokens[:, 1:], device="cuda")

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    eager_loss, eager_grads = step()
    jit_api.reset_metrics()
    pt.jit.to_static(model)
    zero_counts(kern)
    t0 = time.perf_counter()
    loss, grads = step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = LOOP_FP32_LAYERS
    check_launches("9a fp32 compiled step", read_counts(kern),
                   dict(none, flash=n, flash_bwd_dq=n, flash_bwd_dkv=n))
    loss_rel = abs(loss - eager_loss) / abs(eager_loss)
    check("9a fp32 compiled vs eager: loss (relative)", loss_rel,
          LOOP_FP32_LOSS_RTOL)
    top = max(float(g.abs().max()) for g in eager_grads.values())
    worst = max((float((grads[k] - g).abs().max()) / top, k)
                for k, g in eager_grads.items())
    check(f"9a fp32 compiled vs eager: gradients (against the largest, "
          f"{top:.4g}; worst {worst[1]})", worst[0], LOOP_FP32_GRAD_TOL)
    del model, grads, eager_grads
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=n, loss=loss, eager_loss=eager_loss,
                loss_rel=loss_rel, grad_rel=worst[0], first_call_s=seconds,
                compile_s=jit_api.METRICS["compile_s"], flash_launches=n)


def loop_llama(torch, pt, kern, none):
    """9(a): the PaddleNLP Llama step compiled, against the same steps
    eager."""
    ds = TokenData(TRAIN_BATCH * (LOOP_STEPS + 2), TRAIN_SEQ,
                   pt.llama3_8b().vocab_size, 31)
    runs = {}
    for name, compiled in (("compiled", True), ("eager", False)):
        run = runs[name] = loop_run(torch, pt, kern, ds, compiled)
        n, steps = run["layers"], LOOP_STEPS + 1
        check_launches(f"9a {name} steps", run["launches"], dict(
            none, flash=n * steps, flash_wgmma=n * steps,
            flash_bwd_dq=n * steps, flash_bwd_dkv=n * steps,
            flash_bwd_dq_wgmma=n * steps, flash_bwd_dkv_wgmma=n * steps,
            adam_step=TRAIN_GROUPS * steps, sum_squares=2 * steps))
        # the trace is this check's only witness: a step the profiler did
        # not see fails here
        foreign = foreign_attention(run["trace"]["names"])
        if foreign:
            raise AssertionError(f"9a {name} step ran attention kernels "
                                 f"that are not the port's: {foreign}")
        ours = {short_name(k) for k in run["trace"]["names"]} & \
            PORT_FLASH_KERNELS
        if ours != {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                    "flash_bwd_dkv_wgmma_kernel"}:
            raise AssertionError(f"9a {name} traced step: flash kernels "
                                 f"{sorted(ours)}")
        med, tr = run["median"], run["trace"]
        log(f"  9a {name}: losses {run['losses'][0]:.6f} -> "
            f"{run['losses'][-1]:.6f}; median step {med['step']:.2f} ms "
            f"(forward {med['forward']:.2f}, backward {med['backward']:.2f}"
            f", optimizer {med['optimizer']:.2f}, each to a device sync); "
            f"loader wait {np.mean(run['waits_ms'][1:]):.3f} ms a step "
            f"(first batch {run['waits_ms'][0]:.1f}); peak "
            f"{run['peak_gib']:.2f} GiB; traced step idle share "
            f"{tr.get('idle_share')}")
    c, e = runs["compiled"], runs["eager"]
    if not all(np.isfinite(c["losses"] + e["losses"])):
        raise AssertionError(f"9a losses not finite: {c['losses']}, "
                             f"{e['losses']}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(c["losses"], e["losses"])]
    check("9a O2 compiled vs eager loss curves (relative, the largest gap "
          f"at step {int(np.argmax(gaps))})", max(gaps), LOOP_O2_RTOL)
    m = c["metrics"]
    if (m["hit"], m["miss"], m["breaks"]) != (LOOP_STEPS + 1, 1, 0):
        raise AssertionError(f"9a spec cache {m}: expected one miss, "
                             f"{LOOP_STEPS + 1} hits (the traced step's "
                             f"included), no graph break")
    log(f"  9a compile {m['compile_s'][0]:.1f} s (the first step's forward "
        f"call); compiled {c['median']['step']:.2f} ms a step against eager "
        f"{e['median']['step']:.2f} ms ({e['median']['step'] / c['median']['step']:.3f}x)")
    fp32 = loop_fp32_check(torch, pt, kern, none)
    log(f"  9a fp32 {fp32['layers']}-layer copy: loss {fp32['loss']:.7f} "
        f"(eager {fp32['eager_loss']:.7f}), compile "
        f"{fp32['compile_s'][0]:.1f} s")
    for r in runs.values():
        r["trace"] = {k: v for k, v in r["trace"].items()
                      if k != "names"} | {
            "flash_kernels": sorted({short_name(n) for n in
                                     r["trace"]["names"]}
                                    & PORT_FLASH_KERNELS)}
    return dict(runs={k: {kk: vv for kk, vv in v.items()
                          if kk not in ("launches",)}
                      for k, v in runs.items()},
                launches={k: v["launches"] for k, v in runs.items()},
                loss_gap_max=max(gaps), loss_gaps=gaps,
                compile_s=m["compile_s"][0], spec_cache=m, fp32=fp32,
                speedup=e["median"]["step"] / c["median"]["step"])


def hapi_recorder(torch, pt):
    """A callback keeping each step's loss, metrics and the host clock at
    its begin and end, with a CUDA-only trace over steps HAPI_TRACE."""
    from torch.profiler import ProfilerActivity, profile

    class Recorder(pt.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.begin, self.end, self.logs = [], [], []
            self.prof = self.events = self.trace = self.state = None

        def on_train_batch_begin(self, step, logs=None):
            self.begin.append(time.perf_counter())
            if step == HAPI_TRACE[0]:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.events = [torch.cuda.Event(enable_timing=True)
                               for _ in "ab"]
                self.events[0].record()

        def on_train_batch_end(self, step, logs=None):
            self.end.append(time.perf_counter())
            self.logs.append(dict(logs))
            if step == 0:               # after the first update
                self.state = state_copy(self.model.network)
            if step == HAPI_TRACE[1] and self.prof is not None:
                self.events[1].record()
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
                self.trace = window_of(self.events,
                                       device_intervals(torch, self.prof))
                self.prof = None

    return Recorder()


def hapi_net(pt):
    """ResNet-50 (10 classes, seed 2) cut to the first HAPI_BLOCKS
    bottleneck blocks of each stage."""
    pt.seed(2)
    net = pt.vision.models.resnet50(num_classes=10)
    for name in ("layer1", "layer2", "layer3", "layer4"):
        setattr(net, name, pt.nn.Sequential(
            *list(getattr(net, name))[:HAPI_BLOCKS]))
    return net


def hapi_model(pt, compiled):
    """PaddleClas's recipe as ``paddle.Model``: ``hapi_net`` (the network
    under ``jit.to_static`` when ``compiled``), ``Momentum(0.1, 0.9,
    L2Decay(1e-4))``, cross entropy, top-1 and top-5 accuracy; fp32, as
    ``hapi`` applies no AMP."""
    net = hapi_net(pt)
    if compiled:
        pt.jit.to_static(net)
    model = pt.Model(net)
    model.prepare(pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=net.parameters(),
        weight_decay=pt.optimizer.L2Decay(1e-4)), pt.nn.CrossEntropyLoss(),
        pt.metric.Accuracy(topk=(1, 5)))
    return model


def hapi_fit(torch, pt, kern, ds, compiled, seed):
    """``Model.fit`` over a shuffled ``DataLoader`` with workers for
    HAPI_ITERS steps; returns the steps' losses, images/s, the loader's
    waits, the trace and the model."""
    from paddle_tpu_torch.jit import api as jit_api
    model = hapi_model(pt, compiled)
    loader = pt.io.DataLoader(ds, batch_size=HAPI_BATCH, shuffle=True,
                              drop_last=True, num_workers=HAPI_WORKERS)
    rec = hapi_recorder(torch, pt)
    jit_api.reset_metrics()
    zero_counts(kern)
    np.random.seed(seed)
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, num_iters=HAPI_ITERS,
              callbacks=[rec])
    wall = time.perf_counter() - t0
    launches = read_counts(kern)
    if any(launches.values()):
        raise AssertionError(f"9b launched a port kernel: {launches}")
    # the steps from the third on, but for those the trace spans or its
    # teardown (after step HAPI_TRACE[1]'s end) delays
    kept = [i for i in range(2, HAPI_ITERS) if not
            HAPI_TRACE[0] <= i <= HAPI_TRACE[1] + 1]
    step_s = np.array([rec.end[i] - rec.end[i - 1] for i in kept])
    waits = [(rec.begin[i] - rec.end[i - 1]) * 1e3 for i in kept]
    losses = [lg["loss"] for lg in rec.logs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"9b losses not finite: {losses}")
    if rec.trace is None:
        raise AssertionError(f"9b {'compiled' if compiled else 'eager'} "
                             f"fit: steps {HAPI_TRACE} were not traced")
    return model, rec.state, dict(
        losses=losses, wall_s=wall, first_step_s=rec.end[0] - rec.begin[0],
        images_per_s=HAPI_BATCH / float(np.median(step_s)),
        median_step_ms=float(np.median(step_s)) * 1e3,
        loader_wait_ms=float(np.mean(waits)),
        loader_wait_ms_max=float(np.max(waits)),
        loader_stats=dict(loader.stats), acc=rec.logs[-1]["acc"],
        trace={k: v for k, v in rec.trace.items() if k != "names"},
        spec_cache=dict(jit_api.METRICS) if compiled else None)


def state_copy(net):
    """The network's parameters and buffers, copied."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def update_gap(got, want, base, keys=None):
    """The largest gap between two updates of state ``base`` (to ``got``
    and to ``want``), over ``keys`` (all by default), each tensor's
    against the largest change ``want`` made to it (its absolute gap where
    that is 0), and the tensor's name."""
    gaps = []
    for k in keys or base:
        b = base[k].double()
        g, w = got[k].double() - b, want[k].double() - b
        top = float(w.abs().max())
        gaps.append((float((g - w).abs().max()) / (top or 1.0), k))
    return max(gaps)


def hand_steps(torch, pt, ds, seed, steps=2):
    """``steps`` steps of the fit's recipe (the same network, optimizer
    and shuffle) through a hand-written eager loop: the losses, the
    network's state before and after the first update."""
    np.random.seed(seed)
    idx = np.random.permutation(len(ds))
    net = hapi_net(pt)
    net.train()
    opt = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=net.parameters(),
        weight_decay=pt.optimizer.L2Decay(1e-4))
    losses, init, state = [], state_copy(net), None
    for i in range(steps):
        rows = idx[i * HAPI_BATCH:(i + 1) * HAPI_BATCH]
        x = torch.as_tensor(ds.x[rows], device="cuda")
        y = torch.as_tensor(ds.y[rows].astype(np.int64), device="cuda")
        loss = pt.nn.CrossEntropyLoss()(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        if i == 0:
            state = state_copy(net)
    del net, opt
    return losses, init, state


def hapi_accuracy_check(torch, pt, model, ds):
    """``evaluate``'s top-1 and top-5 against those computed from
    ``predict``'s logits on the same two batches."""
    sub = pt.io.Subset(ds, range(2 * HAPI_BATCH))
    ev = model.evaluate(pt.io.DataLoader(sub, batch_size=HAPI_BATCH),
                        verbose=0)
    logits = model.predict(pt.io.DataLoader(sub, batch_size=HAPI_BATCH),
                           stack_outputs=True)[0]
    order = np.argsort(-logits, axis=-1)
    y = ds.y[:2 * HAPI_BATCH]
    want = [float((order[:, :k] == y[:, None]).any(1).mean())
            for k in (1, 5)]
    if ev["acc"] != want:
        raise AssertionError(f"9b Accuracy {ev['acc']} against the logits' "
                             f"{want}")
    if not np.isfinite(ev["loss"]):
        raise AssertionError(f"9b evaluate's loss {ev['loss']}")
    return dict(acc=ev["acc"], loss=ev["loss"])


def deterministic_first_update(torch, pt, ds, seed):
    """Eager fit's first update against the hand-written step's, both
    under cuDNN's deterministic algorithms: the largest gap, which must be
    0. (With its default algorithms the two need not reduce the weight
    gradients alike; ``hapi_resnet`` prints that gap.)"""
    torch.backends.cudnn.deterministic = True
    try:
        _, init, want = hand_steps(torch, pt, ds, seed, steps=1)
        model = hapi_model(pt, False)
        rec = hapi_recorder(torch, pt)
        np.random.seed(seed)
        model.fit(pt.io.DataLoader(ds, batch_size=HAPI_BATCH, shuffle=True,
                                   drop_last=True), epochs=1, verbose=0,
                  num_iters=1, callbacks=[rec])
        return update_gap(rec.state, want, init)
    finally:
        torch.backends.cudnn.deterministic = False


def hapi_resnet(torch, pt, kern):
    """9(b): PaddleClas's ResNet-50 through ``Model.fit``, eager and with
    the network under ``jit.to_static``, each fit's first step held to a
    hand-written one."""
    ds = ImageData(HAPI_BATCHES * HAPI_BATCH, 17)
    seed = 23
    hand_losses, init, hand_state = hand_steps(torch, pt, ds, seed)
    hand = hand_losses[0]
    stats = [k for k in init if k.endswith(("._mean", "._variance"))]
    head = [k for k in init if k.startswith("fc.")]
    if not stats or len(head) != 2:
        raise AssertionError(f"9b state keys: {sorted(init)}")
    gap, where = deterministic_first_update(torch, pt, ds, seed)
    check(f"9b eager fit's first update against the hand-written step's, "
          f"deterministic cuDNN (worst {where})", gap, 0.0)
    out = {"hand_step_losses": hand_losses}
    for name, compiled, tol in (("eager", False, HAPI_EAGER_TOL),
                                ("compiled", True, HAPI_COMPILED_TOL)):
        model, state, run = hapi_fit(torch, pt, kern, ds, compiled, seed)
        check(f"9b {name} fit: first step's loss against the hand-written "
              f"step's (relative)", abs(run["losses"][0] - hand) / abs(hand),
              tol)
        run["update_gap"] = update_gap(state, hand_state, init)
        run["checked_gap"] = update_gap(state, hand_state, init, stats + head)
        del state
        if name == "eager":
            run["accuracy_check"] = hapi_accuracy_check(torch, pt, model, ds)
        out[name] = run
        tr = run["trace"]
        log(f"  9b {name}: losses {run['losses'][0]:.6f} -> "
            f"{run['losses'][-1]:.6f}; {run['images_per_s']:.1f} images/s "
            f"(median step {run['median_step_ms']:.2f} ms to the logs' "
            f"sync); first step {run['first_step_s']:.1f} s; loader wait "
            f"{run['loader_wait_ms']:.3f} ms a step (max "
            f"{run['loader_wait_ms_max']:.3f}); idle share over steps "
            f"{HAPI_TRACE[0]}-{HAPI_TRACE[1]} {tr.get('idle_share')}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    c, e = out["compiled"], out["eager"]
    check(f"9b compiled fit: the first update of BatchNorm's running "
          f"statistics and of the head against the hand-written step's "
          f"(each tensor's change against its largest; worst "
          f"{c['checked_gap'][1]})", c["checked_gap"][0], HAPI_UPDATE_TOL)
    # the whole update is not held: this network's fp32 weight gradients
    # are ill-conditioned (BatchNorm's backward cancels), so rounding the
    # BatchNorm arithmetic elsewhere, as inductor's fused kernels do, moves
    # some tensors' updates by a large share; two eager steps round it
    # alike and differ only in cuDNN's weight-gradient sums
    log(f"  9b the whole first update against the hand-written step's (each "
        f"tensor's change against its largest): eager fit {e['update_gap']}"
        f", compiled fit {c['update_gap']}")
    second = {"hand": hand_losses[1], "eager fit": e["losses"][1],
              "compiled fit": c["losses"][1]}
    out["second_step_losses"] = second
    log(f"  9b the second step's loss: {second}")
    m = out["compiled"]["spec_cache"]
    if (m["miss"], m["breaks"]) != (1, 0):
        raise AssertionError(f"9b spec cache {m}: expected one miss, no "
                             f"graph break")
    return out


def add_compiled_launches(rows, loop):
    """Phase 9(a)'s B1-B3 launches into their kernel rows: the O2 steps'
    (compiled and eager) into the tensor-core rows, the fp32 copy's
    compiled step into the scalar ones."""
    llama = loop["llama"]
    fp32 = llama["fp32"]["flash_launches"]
    wgmma = {"flash_fwd_wgmma": "flash_wgmma",
             "flash_bwd_dq_wgmma": "flash_bwd_dq_wgmma",
             "flash_bwd_dkv_wgmma": "flash_bwd_dkv_wgmma"}
    for row in rows:
        if row["name"] in wgmma:
            key = wgmma[row["name"]]
            add = {f"9a {mode} O2 steps": llama["launches"][mode][key]
                   for mode in ("compiled", "eager")}
            row["compiled_launches"] = add["9a compiled O2 steps"]
        elif row["name"] in ("flash_fwd_simt", "flash_bwd_dq_simt",
                             "flash_bwd_dkv_simt"):
            add = {"9a fp32 compiled step": fp32}
            row["compiled_launches"] = fp32
        else:
            continue
        row["launches_by_path"].update(add)
        row["launches"] += sum(add.values())


def loop_phase(torch, pt, kern, none, smi):
    """Phase 9: 9(a) the Llama step compiled, 9(b) ResNet-50 through
    ``Model.fit``."""
    t0 = time.perf_counter()
    llama = loop_llama(torch, pt, kern, none)
    t1 = time.perf_counter()
    hapi = hapi_resnet(torch, pt, kern)
    return dict(llama=llama, hapi=hapi, card=smi,
                seconds={"9a": t1 - t0, "9b": time.perf_counter() - t1})


def paged_logits_rel_err(torch, gen, model, full, n_prompt):
    """Logits of a prefill then decode steps over a ``PagedKVCache``
    against the cache-free forward of the same tokens."""
    cache = gen.PagedKVCache(page_size=PAGE, max_len=full.shape[0])
    with torch.inference_mode():
        got = [model(full[None, :n_prompt], cache=cache)[0, -1]]
        for t in range(n_prompt, full.shape[0] - 1):
            got.append(model(full[None, t:t + 1], cache=cache)[0, -1])
        got = torch.stack(got)
        ref = model(full[None, :-1])[0, n_prompt - 1:]
    if not (torch.isfinite(got).all() and got.shape == ref.shape):
        raise AssertionError("paged logits not finite or mis-shaped")
    return float((got - ref).abs().max() / ref.abs().max())


def tick_breakdown(torch, rpa, gen, probes, scale, n_layers):
    """Where each engine's tick time goes. For every tick of the two
    instrumented runs: the forward (host clock to a device sync), the
    schedule build and the attention calls in place (CUDA events around
    each layer's call). For the q-block run's ticks also both kernels
    replayed alone at that tick's descriptors (kernel 6 on the engines'
    fixed grid; L2 flushed, median of 10) times the layer count, and C21
    held at those descriptors on a random q: kernel 6 on the fixed grid
    against kernel 8 over layer 0's pool, and B7 against B9
    over the pool quantised by the cache's codec, in fp32, bf16 and
    fp16."""
    phase("phase 6: tick breakdown (the bf16 model, fp32 pages, every tick "
          "of the 8-request load)")
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    out, c21_cases, pools = {}, 0, {}
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
                plans = {}
                for impl in rpa.IMPLS:
                    # the q-block kernels on the engines' fixed grid
                    plan = plans[impl] = rpa.make_plan(
                        t["tokens"], *t["desc"], t["tbl"], PAGE, impl=impl,
                        device="cuda", max_slots=ENGINE_SLOTS)
                    s[f"replay_{impl}_ms"] = n_layers * time_ms(
                        torch, lambda: kern[impl](q, kp, vp, plan, scale),
                        iters=10, warmup=2)
                if id(kp) not in pools:
                    pools[id(kp)] = (*gen.quantize_kv_rows(kp),
                                     *gen.quantize_kv_rows(vp))
                kq, ks, vq, vs = pools[id(kp)]
                rows = torch.as_tensor(span_rows(*t["desc"][1:3]),
                                       device="cuda")
                q32 = torch.randn((t["tokens"], N_HEADS, HEAD_DIM),
                                  generator=g, device="cuda")
                for pages in ((kp, vp), (kq, vq, ks, vs)):
                    c21_cases += check_c21(torch, rpa, q32, pages, plans,
                                           rows, f"replayed tick {i}",
                                           verbose=False)
                line += (f" | {s['replay_qblock_ms']:.3f} "
                         f"{s['replay_token_ms']:.3f}")
            log(line)
            ticks.append(s)
        tot = {k: sum(s[k] for s in ticks) for k in ticks[0]
               if k != "tokens"}
        log(f"  run {run} sums over {len(ticks)} ticks: " + ", ".join(
            f"{k} {v:.3f}" for k, v in tot.items()))
        out[run] = dict(ticks=len(ticks), **tot)
    log(f"  C21 held on every replayed tick: {c21_cases} cases (native and "
        f"int8, {', '.join(C21_DTYPES)})")
    log(json.dumps({"tick_breakdown": out}))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 10: long context, tiered KV and the handoff, quantization
# ---------------------------------------------------------------------------

#: the long-context path's stripe, prompt and seed (the prompt and its new
#: tokens stay inside Llama-3-8B's 8192 rope positions: a CUDA index past
#: the table raises, where JAX clamps)
SEP_STRIPE, LONG_PROMPT, LONG_SEED = 512, 8000, 17
#: 10(a): B1 at the sep path's shapes, ``(label, sq, sk, q_offset,
#: kv_offset)`` (b = 1, head_dim 128): a decode token against a stripe and
#: against the tail window (whose keys past the query are masked), a
#: chunk against a stripe and against itself
SEP_FLASH_CASES = (("decode against a stripe", 1, 512, 7999, 3584),
                   ("decode against the tail window", 1, 512, 8007, 7680),
                   ("chunk against a stripe", 512, 512, 7680, 7168),
                   ("chunk against itself", 512, 512, 7680, 7680))
#: 10(b)/(c): the sep engine's page pool (4096 tokens), and the plain
#: ragged engine's (the whole prompt)
SEP_PAGES, PLAIN_PAGES = 257, 1025
#: 10(d): the tier engine's pool and host tier
TIER_PAGES, TIER_MB = 129, 512
#: 10(e): PTQ's calibration batches (the first 3a prompts)
CALIBRATION_BATCHES = 4


def sep_flash_bound(sq, sk, q_offset, kv_offset, el):
    """``flash_bound`` with the keys at ``kv_offset``: query ``q_offset +
    i`` sees ``min(sk, q_offset + i - kv_offset + 1)`` of them; fp32 (the
    sep partials run B1's fp32 variant) at the fp32 peak."""
    visible = np.clip(q_offset - kv_offset + np.arange(sq) + 1, 0, sk).sum()
    flops = 4 * HEAD_DIM * N_HEADS * int(visible)
    nbytes = el * (2 * sq * N_HEADS + 2 * sk * N_KV) * HEAD_DIM \
        + 4 * N_HEADS * sq
    return _bound(nbytes, flops, FP32_FLOPS)


def sep_flash(torch, fa, ra):
    """10(a): B1 at each sep shape in fp32 against its plain version (out
    within FP32_TOL, lse within FP32_TOL relative), and the 16-bit q route
    of ``ring_partial`` (a bf16 q over fp32 keys: B1's fp32 variant on the
    upcast q, the partial rounded to bf16) bit-equal to the fp32 kernel on
    the upcast q, rounded; each timed beside its bound, its plain version
    and SDPA with the same mask. Returns the timing rows and the worst
    errors."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, errs = [], {"fp32": 0.0, "lse": 0.0}
    for label, sq, sk, qo, ko in SEP_FLASH_CASES:
        q = torch.randn(1, N_HEADS, sq, HEAD_DIM, device="cuda",
                        generator=gen)
        k, v = (torch.randn(1, N_KV, sk, HEAD_DIM, device="cuda",
                            generator=gen) for _ in "kv")
        scale = HEAD_DIM ** -0.5

        def call():
            return fa.flash_attention_with_lse(q, k, v, True, scale, qo, ko)
        n_tc = fa.flash_attention.wgmma_launches
        out, lse = call()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, True, scale, qo, ko)
        if fa.flash_attention.wgmma_launches != n_tc:
            raise AssertionError(f"sep {label}: fp32 ran the tensor cores")
        e, el = float((out - ref).abs().max()), rel_lse_err(lse, ref_lse)
        check(f"sep {label} fp32 out", e, FP32_TOL)
        check(f"sep {label} fp32 lse", el, FP32_TOL, "max rel err")
        errs = {"fp32": max(errs["fp32"], e), "lse": max(errs["lse"], el)}
        qb = q.bfloat16()
        o16, l16 = ra.ring_partial(qb, k, v, qo, ko, scale)
        o32, l32 = fa.flash_attention_with_lse(qb.float(), k, v, True, scale,
                                               qo, ko)
        if not (o16.dtype == torch.bfloat16
                and torch.equal(o16, o32.bfloat16())
                and torch.equal(l16, l32)):
            raise AssertionError(f"sep {label}: the bf16 q route is not the "
                                 f"fp32 kernel on the upcast q, rounded")
        mask = (torch.arange(sq, device="cuda")[:, None] + qo
                >= torch.arange(sk, device="cuda")[None, :] + ko)
        row = {"shape": f"sep {label}: b=1 sq={sq} sk={sk} q_offset={qo} "
                        f"kv_offset={ko} causal GQA 32/8 d=128 float32",
               "ms": time_ms(torch, call),
               "host_us": host_us(torch, call),
               "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                   q, k, v, True, scale, qo, ko), iters=10),
               **sep_flash_bound(sq, sk, qo, ko, 4),
               "library": "sdpa(attn_mask=bool [sq, sk] at the offsets, "
                          "enable_gqa=True)"}

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        row["library_vs_kernel_max_abs_diff"] = float(
            (lib() - out).abs().max())
        row["library_ms"] = time_ms(torch, lib)
        log(f"  {row['shape']}: {row['ms']:.4f} ms (host {row['host_us']:.1f}"
            f" us a call), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}), library "
            f"{row['library_ms']:.4f} ms (max abs diff "
            f"{row['library_vs_kernel_max_abs_diff']:.3e}); bf16 q route "
            f"bit-equal")
        rows.append(row)
    torch.cuda.synchronize()
    return rows, errs


class SepProbe:
    """On one engine: every sep chunk and decode step bracketed by CUDA
    events (device time, read after the run, no sync in it), B1's launches
    in each (the ``flash`` counter's deltas: the sep path's alone, as the
    ragged ticks launch none), the stripes stored before each chunk, and
    the most device pages a sep slot's table maps."""

    def __init__(self, torch, eng, kern):
        self.torch, self.eng, self.kern = torch, eng, kern
        self.chunks, self.decodes, self.max_pages = [], [], 0
        self.launches = {"prefill": 0, "decode": 0}
        self.patches = Patches()

    def _wrap(self, name, kind, log_to):
        fn = getattr(self.eng, name)
        torch = self.torch

        def timed(cache, free, active, slot, *rest):
            stripes = cache.sep_view(slot)["stripes"]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            n0 = self.kern["flash"].launches
            a.record()
            out = fn(cache, free, active, slot, *rest)
            b.record()
            self.launches[kind] += self.kern["flash"].launches - n0
            log_to.append((stripes, a, b))
            self.max_pages = max(self.max_pages, int(
                (cache._tables[slot] != 0).sum()))
            return out
        self.patches.swap(self.eng, name, timed)

    def __enter__(self):
        self._wrap("_sep_prefill_chunk", "prefill", self.chunks)
        self._wrap("_sep_decode_step", "decode", self.decodes)
        return self

    def __exit__(self, *exc):
        self.patches.restore()

    def times(self, records):
        return [(s, a.elapsed_time(b)) for s, a, b in records]


def long_prompt():
    return np.random.RandomState(LONG_SEED).randint(
        0, 128256, LONG_PROMPT).astype(np.int64)


def sep_engine(pt, model, **kw):
    return pt.ContinuousServingEngine(
        model, max_batch_size=ENGINE_SLOTS, page_size=PAGE, max_len=8192,
        num_pages=SEP_PAGES, token_budget=256, prefill_chunk_tokens=256,
        sep_prefill=True, sep_stripe_tokens=SEP_STRIPE, **kw)


def plain_long(torch, pt, model, prompt):
    """The long prompt alone through the plain ragged path, whose pool
    holds it: outputs and the logits row of every token."""
    eng = pt.ContinuousServingEngine(
        model, max_batch_size=ENGINE_SLOTS, page_size=PAGE, max_len=8192,
        num_pages=PLAIN_PAGES, token_budget=256, prefill_chunk_tokens=256)
    with LogitsProbe(pt) as probe, eng:
        out = run_in_order(eng, [prompt])
    return out, probe.rows


def sep_launches_expected(n_layers, prompt_len, new_tokens):
    """B1's launches on the sep path: chunk ``c`` (``c`` stripes stored)
    runs ``c + 1`` partials a layer; every decode step one a stripe and
    one for the tail window, a layer."""
    chunks = -(-prompt_len // SEP_STRIPE)
    stripes = prompt_len // SEP_STRIPE
    return {"prefill": n_layers * chunks * (chunks + 1) // 2,
            "decode": n_layers * (stripes + 1) * (new_tokens - 1)}


def long_context(torch, pt, amp, kern, model, prompts):
    """10(b): the 8000-token prompt and the first seven 3a prompts on the
    sep engine under ``auto_cast`` O2: only the long prompt takes the sep
    path, 15 stripes stored and 16 chunks (the trailing 320 tokens in
    tail pages, ``LONG_PROMPT`` and ``SEP_STRIPE`` deciding), the sep slot never maps more than its tail's pages, B1's
    sep launches exactly as counted; its stream against the plain ragged
    path's (``first_difference``: bf16 GEMMs at other M may flip a
    near-tie, C23), chunk and decode times, tokens/s and the peak."""
    long = long_prompt()
    load = [long] + list(prompts[:7])
    eng = sep_engine(pt, model)
    torch.cuda.reset_peak_memory_stats()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        with eng:
            eng.generate(prompts[1], max_new_tokens=2, timeout=600)
            zero_counts(kern)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with LogitsProbe(pt) as probe, SepProbe(torch, eng, kern) as sep:
                outs = run_in_order(eng, load)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts(kern)
        peak = torch.cuda.max_memory_allocated()
        plain, plain_rows = plain_long(torch, pt, model, long)
    check_outputs(load, outs, 128256, "10(b) sep load")
    cache = eng._cache
    want = sep_launches_expected(N_LAYERS, LONG_PROMPT, NEW_TOKENS)
    tail_pages = -(-(LONG_PROMPT % SEP_STRIPE + NEW_TOKENS) // PAGE)
    facts = {"sep_requests": eng.sep_requests,
             "stripes": eng.sep_stripes_stored, "chunks": eng.sep_chunks,
             "last_chunk": [e for e in eng.events if e[0] == "sep_chunk"][-1],
             "max_sep_slot_pages": sep.max_pages,
             "b1_launches": dict(sep.launches),
             "b1_tensor_core_launches": counts["flash_wgmma"]}
    log(f"  10(b) sep facts: {facts}")
    stripes = LONG_PROMPT // SEP_STRIPE
    if (eng.sep_requests != 1 or eng.sep_stripes_stored != stripes
            or eng.sep_chunks != -(-LONG_PROMPT // SEP_STRIPE)
            or facts["last_chunk"][2] != LONG_PROMPT % SEP_STRIPE
            or sep.max_pages > tail_pages or sep.launches != want
            or counts["flash"] != sum(want.values())
            or counts["flash_wgmma"]):
        raise AssertionError(f"10(b): {facts}, B1 launches expected {want}, "
                             f"{tail_pages} tail pages at most")
    chunks = sep.times(sep.chunks)
    decodes = sep.times(sep.decodes)
    diff = first_difference([long], outs[:1], plain, probe.rows, plain_rows)
    res = {"first_difference": diff, "wall_s": wall,
           "generated_tokens_per_s": NEW_TOKENS * len(load) / wall,
           "chunk_ms_by_stripes": chunks,
           "decode_stripes": stripes,
           "decode_ms": float(np.median([ms for s, ms in decodes
                                         if s == stripes])),
           "peak_gib": peak / 2 ** 30, "facts": facts,
           "pool_pages": SEP_PAGES - 1}
    log(f"  10(b) long prompt vs the plain ragged path (pool of "
        f"{PLAIN_PAGES - 1} pages): "
        + ("identical" if diff is None else f"first difference {diff}"))
    log(f"  10(b) chunk ms by stripes stored: "
        + ", ".join(f"{s}: {ms:.2f}" for s, ms in chunks)
        + f"; decode step at {stripes} stripes {res['decode_ms']:.2f}"
        f" ms (median of {len(decodes)}); load {wall:.3f} s, "
        f"{res['generated_tokens_per_s']:.1f} generated tokens/s; peak "
        f"{res['peak_gib']:.2f} GiB")
    return res


def long_context_fp32(torch, pt, kern):
    """10(c): the same comparison as a hard check in fp32 (2 layers, full
    width, TF32 off): the sep stream equals the plain ragged path's, and
    the first token's logits lie within 1e-4 of the largest logit
    magnitude. A greedy difference is accepted only at a near-tie (the
    plain run's top-two gap within that bound), reported with its gap
    (C29's rule)."""
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = 2
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0)
    long = long_prompt()
    eng = sep_engine(pt, model)
    zero_counts(kern)
    with LogitsProbe(pt) as probe, eng:
        outs = run_in_order(eng, [long])
    counts = read_counts(kern)
    plain, plain_rows = plain_long(torch, pt, model, long)
    key = (long.tobytes(), 0)
    got, want = probe.rows[key], plain_rows[key]
    rel = float((got - want).abs().max() / want.abs().max())
    check("10(c) sep vs plain first-token logits (fp32, 2 layers, "
          "relative to the largest)", rel, 1e-4)
    exp = sep_launches_expected(2, LONG_PROMPT, NEW_TOKENS)
    if counts["flash"] != sum(exp.values()) or counts["flash_wgmma"]:
        raise AssertionError(f"10(c): B1 launches {counts['flash']}, "
                             f"expected {exp}")
    diff = first_difference([long], outs, plain, probe.rows, plain_rows)
    if diff is not None:
        bound = 1e-4 * diff["logits_scale"]
        log(f"  10(c) greedy difference {diff} (near-tie bound {bound:.3e})")
        if diff["margin_off"] > bound:
            raise AssertionError(f"10(c): the sep stream leaves the plain "
                                 f"path's at {diff}, not a near-tie")
    else:
        log("  10(c) sep stream identical to the plain ragged path's "
            f"({NEW_TOKENS} tokens)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"first_difference": diff, "first_logits_rel": rel,
            "b1_launches": counts["flash"]}


class TierProbe:
    """On a tier engine's next cache (patched on the class around one
    run): every demotion and promotion timed to a device sync, each
    promoted page held bit for bit to the entry it was demoted as, and no
    page allocated inside a CUDA graph capture."""

    def __init__(self, torch, gen):
        self.torch, self.cls = torch, gen.SlotPagedKVCache
        self.demoted, self.demote_ms, self.promote_ms = {}, [], []
        self.checked = 0
        self.patches = Patches()

    def __enter__(self):
        torch, demote, promote = self.torch, self.cls._demote, \
            self.cls._promote
        alloc = self.cls._alloc_page

        def check_alloc(cache):
            if torch.cuda.is_current_stream_capturing():
                raise AssertionError("a page allocated inside a capture")
            return alloc(cache)

        def timed_demote(cache, digest, page):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = demote(cache, digest, page)
            torch.cuda.synchronize()
            if ok:
                self.demote_ms.append((time.perf_counter() - t0) * 1e3)
                self.demoted[bytes(digest)] = cache.host_pool._entries[
                    bytes(digest)]
            return ok

        def timed_promote(cache, digest):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            page = promote(cache, digest)
            torch.cuda.synchronize()
            if page is not None and cache._pools:
                self.promote_ms.append((time.perf_counter() - t0) * 1e3)
                got, want = cache._page_entry(page), \
                    self.demoted[bytes(digest)]
                for group in ("layers", "scales"):
                    for a, b in zip(got[group] or [], want[group] or []):
                        for x, y in zip(a, b):
                            if not np.array_equal(x, y):
                                raise AssertionError(
                                    "a promoted page differs from its "
                                    "demoted entry")
                self.checked += 1
            return page
        self.patches.swap(self.cls, "_demote", timed_demote)
        self.patches.swap(self.cls, "_promote", timed_promote)
        self.patches.swap(self.cls, "_alloc_page", check_alloc)
        return self

    def __exit__(self, *exc):
        self.patches.restore()


def tier_engine(pt, model, int8, **kw):
    dtypes = dict(kv_dtype="int8", weight_dtype="int8") if int8 else {}
    return pt.ContinuousServingEngine(
        model, max_batch_size=ENGINE_SLOTS, page_size=PAGE, max_len=2048,
        token_budget=256, prefill_chunk_tokens=256, **dtypes, **kw)


def evicting_prompts():
    """Four unrelated 480-token prompts: together they need nearly the
    whole tier pool, so the LRU evicts the older prefix pages."""
    rng = np.random.RandomState(23)
    return [rng.randint(0, 128256, 480).astype(np.int64) for _ in range(4)]


def tier_and_handoff(torch, pt, gen, amp, model, prompts, int8):
    """10(d) on one pool type (fp32 pages, or fully int8): the four
    prefix-sharing 3a prompts, the four unrelated ones and four more that
    evict the shared pages from the device, then the sharing prompts
    again, on the tier engine (``TIER_PAGES`` pages, ``TIER_MB`` MiB of
    host tier) and on a twin whose pool holds everything; the third
    pass's streams and every logits row bit-equal to the twin's, each
    promoted page bit-equal to its demoted entry. Then the handoff: the
    longest sharing prompt's chain exported from the twin and imported
    into a fresh engine before its first forward and into a running one;
    both serve the prompt with prefix hits equal to the imported pages
    and the twin's stream for it (served alone after its own prefix)."""
    label = "int8" if int8 else "fp32"
    sharing, unrelated = list(prompts[4:8]), list(prompts[0:4])
    passes = (sharing, unrelated, evicting_prompts(), sharing)
    longest = max(sharing, key=len)
    runs = {}
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        for name, kw in (("tier", dict(num_pages=TIER_PAGES,
                                       host_pool_mb=TIER_MB)),
                         ("twin", {})):
            eng = tier_engine(pt, model, int8, **kw)
            with TierProbe(torch, gen) as tp, eng:
                for p in passes[:-1]:
                    run_in_order(eng, p)
                shared = block_chain(gen, sharing)
                evicted = sum(d not in eng._cache._index for d in shared)
                with LogitsProbe(pt) as probe:
                    outs = run_in_order(eng, passes[-1])
                if name == "twin":
                    # the handoff's source: the longest sharing prompt
                    # alone after its own prefix, then its chain exported
                    source = handoff_source(torch, gen, eng, longest)
            runs[name] = dict(eng=eng, outs=outs, rows=probe.rows, probe=tp,
                              evicted=evicted, shared=len(shared))
        tier, twin = runs["tier"], runs["twin"]
        for a, b in zip(tier["outs"], twin["outs"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"10(d) {label}: the third pass leaves "
                                     f"the twin's streams")
        for key, row in twin["rows"].items():
            if not torch.equal(tier["rows"][key], row):
                raise AssertionError(f"10(d) {label}: a logits row differs "
                                     f"from the twin's")
        tp, cache = tier["probe"], tier["eng"]._cache
        if (tier["evicted"] != tier["shared"]
                or cache.host_promotions < tier["shared"] or tp.checked == 0
                or tp.checked != cache.host_promotions):
            raise AssertionError(f"10(d) {label}: {tier['evicted']} of "
                                 f"{tier['shared']} shared blocks evicted, "
                                 f"{cache.host_promotions} promotions, "
                                 f"{tp.checked} checked")
        out = {"shared_blocks": tier["shared"],
               "evicted_before_pass_3": tier["evicted"],
               "host_demotions": cache.host_demotions,
               "host_promotions": cache.host_promotions,
               "host_pool_evictions": cache.host_pool.evictions,
               "promotions_checked_bit_equal": tp.checked,
               "demote_ms_median": float(np.median(tp.demote_ms)),
               "promote_ms_median": float(np.median(tp.promote_ms)),
               "third_pass_bit_equal_to_twin": True}
        log(f"  10(d) {label} tier: {out}")
        out["handoff"] = handoff(torch, pt, model, source, longest,
                                 unrelated[1], int8)
    return out


def block_chain(gen, prompts):
    """The digests of every full block the prompts register."""
    chain = []
    for p in prompts:
        for d in gen.block_hash_chain(p, PAGE):
            if d not in chain:
                chain.append(d)
    return chain


def handoff_source(torch, gen, eng, prompt):
    """On a running engine: ``prompt`` served alone (after its own
    prefix), then the chain of its matchable blocks exported on the serve
    loop. Returns its stream, the blob, the export's ms and the blob's
    bytes."""
    want = run_in_order(eng, [prompt])[0]
    chain = gen.block_hash_chain(prompt, PAGE)[:(len(prompt) - 1) // PAGE]

    def export(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = e._cache.export_pages(chain)
        return blob, (time.perf_counter() - t0) * 1e3
    blob, ms = eng.run_on_loop(export, 600)
    if blob is None or blob["digests"] != chain:
        raise AssertionError("10(d): the handoff's chain was not exported "
                             "whole")
    nbytes = sum(a.nbytes for pair in blob["layers"] + (blob["scales"] or [])
                 for a in pair)
    return {"want": want, "blob": blob, "export_ms": ms, "bytes": nbytes}


def handoff(torch, pt, model, source, prompt, warm_prompt, int8):
    """10(d)'s handoff (see ``tier_and_handoff``): the source's blob into a
    fresh engine before its first forward (the backlog) and into a running
    one (written in place, on the serve loop)."""
    label = "int8" if int8 else "fp32"
    blob, n_pages = source["blob"], len(source["blob"]["digests"])
    res = {"pages": n_pages, "blob_bytes": source["bytes"],
           "export_ms": source["export_ms"]}
    for path in ("backlog", "direct"):
        eng = tier_engine(pt, model, int8)
        if path == "backlog":
            eng._adopt = eng._new_cache()
            t0 = time.perf_counter()
            n = eng._adopt.import_pages(blob)
            res["import_ms_backlog"] = (time.perf_counter() - t0) * 1e3
        with eng:
            if path == "direct":
                run_in_order(eng, [warm_prompt])

                def land(e):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n = e._cache.import_pages(blob)
                    torch.cuda.synchronize()
                    return n, (time.perf_counter() - t0) * 1e3
                n, res["import_ms_direct"] = eng.run_on_loop(land, 600)
            hits0 = eng.prefix_hits
            got = run_in_order(eng, [prompt])[0]
            hits = eng.prefix_hits - hits0
        if n != n_pages or hits != n_pages \
                or not np.array_equal(got, source["want"]):
            raise AssertionError(f"10(d) {label} handoff ({path}): {n} "
                                 f"imported, {hits} prefix hits, streams "
                                 f"equal {np.array_equal(got, source['want'])}")
    log(f"  10(d) {label} handoff: {res}; both paths serve the source's "
        f"stream with {n_pages} prefix hits")
    return res


def ptq_llama(torch, pt, amp, kern, prompts, warm, ref):
    """10(e)1: PTQ + calibrate (the first 3a prompts) + convert on a fresh
    32-layer Llama of the seed of ``ref``'s, served under O2: streams and
    every logits row bit-equal to the ``weight_dtype="int8"`` engine's
    (``ref``: its codes and B10 calls are the same), B10 225 times a
    forward."""
    from paddle_tpu_torch import quantization as tq
    model = pt.LlamaForCausalLM(pt.llama3_8b(), device="cuda", seed=0).to(
        torch.bfloat16)
    torch.cuda.empty_cache()
    tq.PTQ(tq.QuantConfig(activation=tq.AbsmaxObserver(),
                          weight=tq.AbsmaxObserver())).quantize(model)
    wrapped = sum(isinstance(m, tq.QuantedLinear) for m in model.modules())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = tq.calibrate(model, [p[None] for p in
                                   prompts[:CALIBRATION_BATCHES]])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    tq.convert(model)
    torch.cuda.empty_cache()
    got = ptq_serve(torch, pt, amp, kern, model, prompts, warm, {})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for a, b in zip(got["outs"], ref["outs"]):
        if not np.array_equal(a, b):
            raise AssertionError("10(e): the PTQ-converted streams leave the "
                                 "int8 engine's")
    for key, row in ref["rows"].items():
        if not torch.equal(got["rows"][key], row):
            raise AssertionError("10(e): a PTQ logits row differs from the "
                                 "int8 engine's")
    if wrapped != N_LINEARS or batches != CALIBRATION_BATCHES:
        raise AssertionError(f"10(e): {wrapped} Linears wrapped, {batches} "
                             f"batches")
    res = {"wrapped_linears": wrapped, "calibration_s": calib_s,
           "calibration_batches": batches, "b10_launches": got["b10"],
           "forwards": got["forwards"], "bit_equal_to_int8_engine": True}
    log(f"  10(e) PTQ Llama-3-8B: {res}")
    return res


def ptq_serve(torch, pt, amp, kern, model, prompts, warm, kw):
    """The 3a load in order under O2 on the q-block engine, its logits
    rows kept and B10's launches checked: 225 a forward."""
    eng = tier_engine(pt, model, False, **kw)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        with eng:
            run_in_order(eng, [warm])
            zero_counts(kern)
            steps0 = eng.ragged_steps
            with LogitsProbe(pt) as probe:
                outs = run_in_order(eng, prompts)
            forwards = eng.ragged_steps - steps0
    b10 = kern["int8_matmul"].launches
    if b10 != N_LINEARS * forwards:
        raise AssertionError(f"10(e): B10 {b10} launches over {forwards} "
                             f"forwards")
    return {"outs": outs, "rows": probe.rows, "b10": b10,
            "forwards": forwards}


def qat_resnet(torch, pt, kern):
    """10(e)2: a QAT-wrapped ResNet-50 (10 classes) on the CPU, one train
    forward through its fake quanters, then converted and in eval: its
    copy on the card (the head through B10, every conv on its dequantised
    filter) against an fp64 copy, within phase 8's rule (``RESNET_FACTOR``
    times the CPU fp32's distance, or ``RESNET_FLOOR``)."""
    from paddle_tpu_torch import quantization as tq
    pt.set_device("cpu")
    try:
        pt.seed(3)
        cpu = pt.vision.models.resnet50(num_classes=10)
        q = tq.FakeQuanterWithAbsMaxObserver
        tq.QAT(tq.QuantConfig(activation=q(), weight=q())).quantize(cpu)
        x, _ = _resnet_batch(torch, RESNET_CHECK_BATCH, 5, "cpu")
        cpu.train()
        cpu(x)
        tq.convert(cpu)
        cpu.eval()
        card = copy.deepcopy(cpu).to("cuda")
        f64 = copy.deepcopy(cpu).double()
        with torch.no_grad():
            want, exact = cpu(x), f64(x.double())
    finally:
        pt.set_device("gpu:0")
    zero_counts(kern)
    with torch.no_grad():
        got = card(x.cuda()).double().cpu()
    b10 = kern["int8_matmul"].launches

    held = f64_held(torch, "10(e) QAT-converted ResNet-50 eval logits", got,
                    want, exact)
    if b10 != 1:
        raise AssertionError(f"10(e): B10 launched {b10} times, expected 1")
    return {"card_vs_fp64": held["card"], "cpu_vs_fp64": held["cpu"],
            "b10_launches": b10}


def phase10(torch, pt, amp, fa, ra, gen, kern, prompts, warm):
    """Phase 10: B1 at the sep shapes, long context at full width (O2) and
    in fp32, the tier and the handoff at full width, PTQ on Llama-3-8B and
    QAT on ResNet-50. Returns the results, with the sep rows for B1's
    kernel row."""
    gc.collect()
    torch.cuda.empty_cache()
    phase(" 10(a): B1 at the sep path's shapes")
    sep_rows, sep_errs = sep_flash(torch, fa, ra)
    phase(" 10(b): long context, Llama-3-8B (32 layers, bf16, O2): an "
          f"{LONG_PROMPT}-token prompt beside seven 3a prompts, sep prefill "
          f"in {SEP_STRIPE}-token stripes over a {SEP_PAGES - 1}-page pool")
    model = pt.LlamaForCausalLM(pt.llama3_8b(), device="cuda", seed=0).to(
        torch.bfloat16)
    torch.cuda.empty_cache()
    lc = long_context(torch, pt, amp, kern, model, prompts)
    phase(" 10(d): the host tier and the handoff at full width (O2), fp32 "
          "pages, then fully int8")
    tier = {"fp32": tier_and_handoff(torch, pt, gen, amp, model, prompts,
                                     False)}
    tier["int8"] = tier_and_handoff(torch, pt, gen, amp, model, prompts, True)
    phase(" 10(e): quantization: PTQ + calibrate + convert on Llama-3-8B "
          "against the int8 engine (O2), QAT on ResNet-50")
    ref = ptq_serve(torch, pt, amp, kern, model, prompts, warm,
                    dict(weight_dtype="int8"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    quant = {"ptq_llama": ptq_llama(torch, pt, amp, kern, prompts, warm, ref),
             "qat_resnet": qat_resnet(torch, pt, kern)}
    phase(" 10(c): long context in fp32 (2 layers, full width): the sep "
          "stream against the plain ragged path")
    lc["fp32"] = long_context_fp32(torch, pt, kern)
    log(json.dumps({"long_context": dict(lc, tier=tier, b1_sep=sep_rows,
                                         b1_sep_errors=sep_errs)}))
    log(json.dumps({"quant": quant}))
    return {"sep_rows": sep_rows, "sep_errs": sep_errs, "long": lc,
            "tier": tier, "quant": quant}


def add_sep_launches(rows, p10):
    """Phase 10's B1 launches (the sep path: O2 at 32 layers, fp32 at 2)
    into the scalar B1 row, its sep shapes beside its other shapes."""
    lc = p10["long"]
    add = {"10b sep prefill": lc["facts"]["b1_launches"]["prefill"],
           "10b sep decode": lc["facts"]["b1_launches"]["decode"],
           "10c fp32 sep": lc["fp32"]["b1_launches"]}
    for row in rows:
        if row["name"] == "flash_fwd_simt":
            row["launches_by_path"].update(add)
            row["launches"] += sum(add.values())
            row["other_shapes"] = row["other_shapes"] + p10["sep_rows"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     p10["sep_errs"]["fp32"])


# ---------------------------------------------------------------------------
# phase 11: the language-model zoo (GPT-3-1.3B, Mixtral-8x7B widths,
# BERT-base, T5)
# ---------------------------------------------------------------------------

#: the zoo's training steps (batch, sequence): GPT-3-1.3B at full depth,
#: Mixtral-8x7B widths at MIXTRAL_TRAIN_LAYERS
ZOO_TRAIN = {"gpt": (2, 2048), "mixtral": (1, 2048)}
#: counted steps after ZOO_WARM_STEPS warm ones; the step's times are
#: their median (one step's host clock meets allocator and host stalls)
ZOO_COUNTED_STEPS, ZOO_WARM_STEPS = 5, 2
#: Mixtral-8x7B is 46.7 B parameters (93 GB in bf16), beyond one card: it
#: serves at 2 layers (3.16 B parameters) and trains at 1 (1.71 B, ~27 GB
#: under O2 AdamW)
MIXTRAL_SERVE_LAYERS, MIXTRAL_TRAIN_LAYERS = 2, 1
#: GPT's fp32 checks against the port on the CPU: 2 layers of full width
ZOO_CPU_LAYERS = 2
#: the BERT-base fine-tune (BASELINE.json configs[1]): batch, sequence,
#: AdamW steps, and its depth, cut from 12 layers to keep the whole run
#: inside its time (the compiled model's first step took 95 s at 12);
#: the eval forward without a mask at ZOO_BERT_EVAL, at full depth
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_TRAIN_LAYERS = 32, 128, 6, 2
ZOO_BERT_EVAL = (8, 512)
#: the card's fp32 logits against the CPU's, relative to the largest
#: (phase 4's bound)
ZOO_LOGITS_TOL = 1e-4
#: a greedy stream of the card that leaves another path's is put down to
#: a near-tie only where the top-two gap there is within this share of
#: the largest logit (fp32 sums in another order over 24 layers)
ZOO_TIE_SHARE = 1e-4
#: the reference test's tolerance on the fine-tune's losses
#: (``tests/test_bert_to_static.py:54``)
BERT_RTOL, BERT_ATOL = 2e-4, 2e-5


def zoo_prompts(vocab):
    """The zoo's serving load: eight prompts of 128-600 tokens, four of
    them after a shared 64-token prefix, and a warm request on the prefix;
    and the generate batch, four of them cut to 256 tokens."""
    rng = np.random.RandomState(31)
    prefix = rng.randint(0, vocab, 64)
    prompts = [rng.randint(0, vocab, n) for n in (600, 128, 257, 181)]
    prompts += [np.concatenate([prefix, rng.randint(0, vocab, n)])
                for n in (100, 64, 240, 300)]
    warm = np.concatenate([prefix, rng.randint(0, vocab, 20)])
    prompts = [p.astype(np.int64) for p in prompts]
    batch = np.stack([p[:256] for p in prompts if p.shape[0] >= 256])
    return prompts, warm.astype(np.int64), batch


def by_variant(fa, pa, rpa):
    """B1-B3's launches by shape (dtype, head_dim, group, mask) and kernels
    4, 6 and 8's by dtypes since the counts were zeroed."""
    return {"flash": dict(fa.flash_attention.launches_by_shape),
            "flash_bwd_dq": dict(fa.flash_bwd_dq.launches_by_shape),
            "flash_bwd_dkv": dict(fa.flash_bwd_dkv.launches_by_shape),
            "paged": dict(pa.paged_attention.launches_by_dtype),
            "qblock": dict(rpa.qblock_attention.launches_by_dtype),
            "token": dict(rpa.token_attention.launches_by_dtype)}


def check_variants(label, got, want):
    """``want`` maps wrappers to their by-variant counts; every other
    wrapper's dict is empty."""
    full = {k: want.get(k, {}) for k in got}
    log(f"  {label}: launches by variant {got}")
    if got != full:
        raise AssertionError(f"{label}: launches by variant {got}, "
                             f"expected {full}")


def cpu_twin(model, build):
    """``build("meta")`` allocated on the CPU with ``model``'s state: the
    port on the CPU with the card's weights (a seeded draw differs
    between a CPU and a CUDA generator)."""
    twin = build("meta")
    twin.to_empty(device="cpu")
    twin.load_state_dict({k: v.detach().cpu()
                          for k, v in model.state_dict().items()})
    return twin


def rel_to_max(torch, got, want):
    """max |got - want| over max |want|, on the CPU in fp32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def stream_gap(torch, logits_fn, prompt, out, other):
    """Where two greedy streams of one prompt first differ: the position
    and ``logits_fn``'s top-two gap there over its largest logit (None
    when they agree)."""
    n = prompt.shape[0]
    diff = np.nonzero(out[n:] != other[n:])[0]
    if not diff.size:
        return None
    pos = int(diff[0])
    top = torch.topk(logits_fn(out[:n + pos]).float(), 2).values
    scale = float(logits_fn(out[:n + pos]).float().abs().max())
    return {"position": pos, "gap": float(top[0] - top[1]),
            "share": float(top[0] - top[1]) / scale}


def hold_streams(torch, label, logits_fn, prompts, outs, others):
    """Stream by stream, ``outs`` against ``others``: equal, or leaving at
    a near-tie (ZOO_TIE_SHARE of the largest logit). Returns the count of
    equal streams and the departures."""
    same, left = 0, []
    for p, a, b in zip(prompts, outs, others):
        a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
        g = stream_gap(torch, logits_fn, p, a, b)
        if g is None:
            same += 1
            continue
        left.append(g)
        if g["share"] > ZOO_TIE_SHARE:
            raise AssertionError(f"{label}: a stream leaves at {g}, no "
                                 f"near-tie")
    log(f"  {label}: {same} of {len(prompts)} streams equal"
        + (f"; the others leave at near-ties {left}" if left else ""))
    return {"equal": same, "of": len(prompts), "near_ties": left}


def zoo_flash_bound(q, k, causal, q_offset=0, flops_per_d=4, q_side=2,
                    kv_side=2, row_floats=1):
    """``flash_bound`` on ``[b, s, h, d]`` inputs of any width: B1's by
    default (q, k, v read and out written once in their dtype, fp32 lse,
    4 d flops a visible (query, key) pair a query head at the dtype's
    peak); B2's and B3's with ``BWD_BOUNDS``."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    visible = (int(np.clip(q_offset + np.arange(sq) + 1, 0, sk).sum())
               if causal else sq * sk)
    el = q.element_size()
    nbytes = (el * d * (q_side * b * sq * hq + kv_side * b * sk * hk)
              + 4 * row_floats * b * hq * sq)
    return _bound(nbytes, flops_per_d * d * hq * b * visible, peak_of(q))


def zoo_time_flash(torch, fa, cap, label):
    """B1 on captured ``[b, s, h, d]`` inputs: the kernel, its plain
    version, PyTorch's SDPA on the same data and the bound."""
    q, k, v, causal = cap["q"], cap["k"], cap["v"], cap["causal"]
    qo = cap.get("q_offset", 0)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row = {"shape": f"{label}: b={b} sq={sq} sk={sk} "
                    f"{'causal' if causal else 'non-causal'} {hq}/{hk} "
                    f"heads d={d} {str(q.dtype).removeprefix('torch.')}",
           "key": fa.shape_key(q.dtype, d, hq, hk, causal)}
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(
        q, k, v, causal, None, qo))
    row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(
        qt, kt, vt, causal, None, qo), iters=5)
    row.update(zoo_flash_bound(q, k, causal, qo))
    kw = {"is_causal": True} if causal else {}
    if causal and sq != sk:
        raise AssertionError(f"{label}: a causal capture with sq != sk")
    row["library"] = f"sdpa({'is_causal=True, ' if causal else ''}" \
                     f"enable_gqa=True)"
    row["library_ms"] = time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw))
    log(f"  B1 at {row['shape']}: {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}), SDPA {row['library_ms']:.4f} ms")
    return row


def zoo_time_paged(torch, pa, cap, label):
    """B4 on a captured decode step: the kernel, its plain version and the
    bound (q and out once, every distinct page the contexts cover once,
    the tables; 4 d flops a visible key a query head)."""
    q, kp, vp, tbl, ctx = (cap[k] for k in ("q", "kp", "vp", "tables",
                                            "ctx"))
    c, t = ctx.cpu().numpy(), tbl.cpu().numpy()
    heads, d = q.shape[1], q.shape[2]
    page = kp.shape[2]
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * distinct_pages(t, range(len(c)), c, page) * kp.shape[0]
              * page * page_row_bytes(kp, False) + t.nbytes + c.nbytes)
    row = {"shape": f"{label}: b={q.shape[0]}, ctx {c.tolist()}, "
                    f"{heads}/{kp.shape[0]} heads d={d}, "
                    f"{pa.dtype_key(q, kp)}",
           **_bound(nbytes, 4 * d * heads * int(c.sum()), peak_of(q))}
    row["ms"] = time_ms(torch, lambda: pa.paged_attention(q, kp, vp, tbl,
                                                          ctx))
    row["plain_ms"] = time_ms(torch, lambda: pa.paged_decode_plain(
        q, kp, vp, tbl, ctx, d ** -0.5), iters=10)
    row["library_ms"], row["library"] = None, "none: no single PyTorch " \
        "call reads a block-table cache"
    log(f"  B4 at {row['shape']}: {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']})")
    return row


def zoo_time_ragged(torch, rpa, cap, label):
    """Kernels 6 (the engine's fixed grid) and 8 on a captured tick, their
    plain versions and the tick's bound."""
    q, kp, vp, tbl, desc = (cap[k] for k in ("q", "kp", "vp", "tbl", "desc"))
    scale = q.shape[-1] ** -0.5
    bound = bound_ms(q, kp, tbl, desc)
    shape = (f"{label}: q_lens {np.asarray(desc[2]).tolist()}, ctx "
             f"{np.asarray(desc[3]).tolist()}, {q.shape[1]}/{kp.shape[0]} "
             f"heads d={q.shape[2]}, "
             f"{str(q.dtype)[6:]}/{str(kp.dtype)[6:]}")
    plans = {"qblock": rpa.make_plan(q.shape[0], *desc, tbl, PAGE,
                                     impl="qblock", device="cuda",
                                     max_slots=ENGINE_SLOTS),
             "token": rpa.make_plan(q.shape[0], *desc, tbl, PAGE,
                                    impl="token", device="cuda")}
    kern = {"qblock": rpa.qblock_attention, "token": rpa.token_attention}
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    out = {}
    for impl in kern:
        row = {"shape": shape, **bound, "library_ms": None,
               "library": RAGGED_LIBRARY}
        row["ms"] = time_ms(torch, lambda: kern[impl](q, kp, vp, plans[impl],
                                                      scale))
        row["plain_ms"] = time_ms(torch, lambda: plain[impl](
            q, kp, vp, plans[impl], scale), iters=5)
        log(f"  {impl} at the {shape}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']})")
        out[impl] = row
    return out


def serve_bf16(torch, pt, kern, fa, pa, rpa, model, prompts, warm, impl,
               n_layers, pages):
    """One counted graph run of the load under the caller's O2 block
    (``serve``): the outputs checked, the pools' and the logits' dtypes,
    and every attention launch kernel ``impl``'s at ``pages`` (the pool
    dtype key, ``"bfloat16/bfloat16"`` for a bf16 GPT)."""
    outs, st = serve(torch, pt, kern, model, prompts, warm, impl=impl)
    check_outputs(prompts, outs, model.config.vocab_size, f"O2 {impl}")
    variants = by_variant(fa, pa, rpa)
    check_variants(f"O2 {impl} engine", variants,
                   {impl: {pages: n_layers * st["steps"]}})
    if st["launches"][impl] != n_layers * st["steps"] or any(
            n for k, n in st["launches"].items()
            if not k.startswith(impl) and n):
        raise AssertionError(f"O2 {impl}: launches {st['launches']}")
    if st["logits_dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"O2 {impl}: logits {st['logits_dtypes']}")
    st["by_variant"] = variants
    log(f"  O2 {impl}: {st['steps']} ticks, {st['hits']} prefix hits, "
        f"{serving_rate(st, prompts):.1f} generated tokens/s, pools "
        f"{st['pool_dtypes']}, wall {st['wall']:.3f} s")
    return outs, st


def zoo_generate(torch, amp, kern, fa, pa, rpa, model, batch, paged,
                 probes=()):
    """``generate`` on ``batch`` under O2 with the counts zeroed: the dense
    cache (B1 for the prefill, SDPA's einsum for the one-token steps) or
    the paged one (B1, then B4 a step a layer). Returns the ids and the
    counts."""
    zero_counts(kern)
    ids = torch.as_tensor(batch, device="cuda")
    with contextlib.ExitStack() as stack:
        for p in probes:
            stack.enter_context(p)
        stack.enter_context(amp.auto_cast(**AMP_O2))
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=NEW_TOKENS,
                             use_paged_cache=paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out.cpu().numpy(), {"launches": read_counts(kern),
                               "by_variant": by_variant(fa, pa, rpa),
                               "wall": wall}


def zoo_step(torch, model, opt, ids, labels, cast):
    """One eager step (``train_step``) of ``model(ids, labels=labels)``,
    which gives ``(loss, _)``, under ``cast()``; no scheduler."""
    sched = types.SimpleNamespace(step=lambda: None)
    return train_step(torch, model, opt, sched, ids, labels, cast)


def zoo_trainer(torch, pt, amp, model, batch, seq, vocab, seed=21):
    """AdamW (decay off for the norms, the fused step) and O2 bf16 on
    ``model`` in train mode, with a repeated batch of ``batch`` x ``seq``
    tokens."""
    from paddle_tpu_torch.optimizer import AdamW
    model.train()
    opt = AdamW(learning_rate=1e-5, parameters=model.named_parameters(),
                weight_decay=0.1,
                apply_decay_param_fun=lambda n: "norm" not in n)
    # the fused step (K-A) whatever the parameter count: Mixtral's one
    # layer has fewer than the engine's MIN_PARAMS
    opt.fuse_step = True
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    tokens = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    ids = torch.as_tensor(tokens[:, :-1], device="cuda")
    labels = torch.as_tensor(tokens[:, 1:], device="cuda")
    return opt, ids, labels, (lambda: amp.auto_cast(**AMP_O2))


def median_steps(torch, kern, step, batches, label):
    """ZOO_WARM_STEPS warm steps (the first makes the masters and moments,
    the second still meets the allocator growing around them), then
    ZOO_COUNTED_STEPS counted with the port's counts zeroed between, each
    ``step(*batch)`` (``train_step``'s result) on the next of
    ``batches``: the losses, the counted steps' median phase ms, their
    spread and peak memory, the counts and the warm steps' ms; and the
    iterator for the batches after them."""
    it = iter(batches)
    warm = [step(*next(it)) for _ in range(ZOO_WARM_STEPS)]
    zero_counts(kern)
    counted = [step(*next(it)) for _ in range(ZOO_COUNTED_STEPS)]
    counts = read_counts(kern)
    losses = [r[0] for r in warm + counted]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    ms = {k: float(np.median([r[1][k] for r in counted]))
          for k in counted[0][1]}
    steps = [r[1]["step"] for r in counted]
    return dict(losses=losses, ms=ms, counted_step_ms=steps,
                spread=(max(steps) - min(steps)) / ms["step"],
                warm_ms=[r[1] for r in warm],
                peak_gib=max(max(r[2].values()) for r in counted) / 2**30,
                launches=counts), it


def zoo_train(torch, pt, amp, kern, fa, pa, rpa, model, label, n_layers, key,
              vocab, batch, seq, cap=None, trace=False):
    """O2 steps on one batch (``median_steps``): B1-B3 once a layer a
    counted step each at shape ``key`` (``shape_key``), K-A at least
    once; the times are the counted steps' median, printed with their
    spread. With ``cap`` one more step runs under it, with ``trace`` one
    more under ``traced_step`` (device ms by phase and kernel)."""
    opt, ids, labels, cast = zoo_trainer(torch, pt, amp, model, batch, seq,
                                         vocab)
    res, _ = median_steps(
        torch, kern, lambda i, y: zoo_step(torch, model, opt, i, y, cast),
        itertools.repeat((ids, labels)), label)
    counts, variants = res["launches"], by_variant(fa, pa, rpa)
    check_variants(f"{label} steps", variants,
                   {w: {key: n_layers * ZOO_COUNTED_STEPS}
                    for w in ("flash", "flash_bwd_dq", "flash_bwd_dkv")})
    if not counts["adam_step"] or not counts["flash_wgmma"]:
        raise AssertionError(f"{label}: launches {counts}")
    ms, steps = res["ms"], res["counted_step_ms"]
    log(f"  {label}: losses " + ", ".join(f"{x:.6f}" for x in res["losses"])
        + "; the warm steps " + " and ".join(
            f"{w['step']:.2f}" for w in res["warm_ms"])
        + " ms; the counted steps "
        + ", ".join(f"{x:.2f}" for x in steps) + " ms, median "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + f" (spread {res['spread']:.3f} of the median), "
        f"{batch * seq / ms['step'] * 1e3:.1f} tokens/s, peak "
        f"{res['peak_gib']:.2f} GiB; K-A launches {counts['adam_step']}, "
        f"K-B {counts['sum_squares']}")
    if cap is not None:
        with cap:
            zoo_step(torch, model, opt, ids, labels, cast)
    res["by_variant"], res["traced"] = variants, None
    if trace:
        res["traced"] = traced_step(torch, model, opt,
                                    types.SimpleNamespace(step=lambda: None),
                                    ids, labels, cast)
    del opt
    return res


def gpt_cpu_check(torch, pt, fa, kern, batch):
    """GPT-3-1.3B's widths at ZOO_CPU_LAYERS layers, fp32 (TF32 off): the
    card's logits and first AdamW update against the port on the CPU with
    the same weights. The logits and the gradients are held to
    ZOO_LOGITS_TOL of their largest. The first update is ``lr g / (|g| +
    eps)`` (weight decay off), so the card's gradient ``g + d`` may move
    it by up to ``lr |d| eps / (max(|g| - |d|, 0) + eps)^2`` (the
    function's slope over the interval between the two gradients): every
    element is held to that, plus one ulp of the parameter (each side
    rounds its new value once) and ZOO_LOGITS_TOL of ``lr``; where both
    gradients are 0 the update must be exactly 0 on both sides."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt_mod.gpt3_1p3b(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    cfg.num_hidden_layers = ZOO_CPU_LAYERS
    dev = gpt_mod.GPTForCausalLM(cfg, device="cuda", seed=0)
    cpu = cpu_twin(dev, lambda d: gpt_mod.GPTForCausalLM(cfg, device=d))
    ids = batch[:1]
    lr, out = 1e-4, {}
    zero_counts(kern)
    for m in (dev, cpu):
        m.train()
        x = torch.as_tensor(ids, device=m.device)
        loss, logits = m(x, labels=x)
        loss.backward()
        m._logits = logits.detach()
        m._before = {n: p.detach().clone() for n, p in m.named_parameters()}
        m._grads = {n: p.grad.detach().clone()
                    for n, p in m.named_parameters()}
        opt = AdamW(learning_rate=lr, parameters=m.parameters(),
                    weight_decay=0.0)
        eps = opt._epsilon
        opt.step()
    if not kern["flash"].launches or kern["flash_wgmma"].launches:
        raise AssertionError("the fp32 check did not take the scalar B1")
    out["logits_rel"] = rel_to_max(torch, dev._logits, cpu._logits)
    check("GPT fp32 logits, card vs CPU (relative, 2 layers)",
          out["logits_rel"], ZOO_LOGITS_TOL)
    grad_rel, worst, zeros, nonzero_zero_grad = 0.0, None, 0, 0
    for n, g in cpu._grads.items():
        gd = dev._grads[n].cpu()
        grad_rel = max(grad_rel, rel_to_max(torch, gd, g))
        du = (dict(dev.named_parameters())[n].detach().cpu()
              - dev._before[n].cpu())
        cu = dict(cpu.named_parameters())[n].detach() - cpu._before[n]
        p0, d = cpu._before[n], (gd - g).abs()
        both_zero = (g == 0) & (gd == 0)
        zeros += int(both_zero.sum())
        nonzero_zero_grad += int(((du != 0) | (cu != 0))[both_zero].sum())
        slope = eps / ((g.abs() - d).clamp_min(0) + eps) ** 2
        allow = (torch.ldexp(torch.ones_like(p0), torch.frexp(p0).exponent
                             - 24) + ZOO_LOGITS_TOL * lr + lr * d * slope)
        ratio = (du - cu).abs() / allow
        i = int(ratio.argmax())
        r = float(ratio.view(-1)[i])
        if worst is None or r > worst["ratio"]:
            worst = {"ratio": r, "tensor": n,
                     "g_over_max": float(g.view(-1)[i].abs()
                                         / g.abs().max().clamp_min(1e-30)),
                     "g": float(g.view(-1)[i]), "d": float(d.view(-1)[i]),
                     "update_diff": float((du - cu).abs().view(-1)[i])}
    out.update(grad_rel=grad_rel, update_worst=worst, zero_grad=zeros,
               zero_grad_moved=nonzero_zero_grad)
    check("GPT fp32 gradients, card vs CPU (relative)", grad_rel,
          ZOO_LOGITS_TOL)
    check("GPT fp32 first AdamW update, card vs CPU (error / (ulp(p) + "
          "1e-4 lr + lr |d| eps / (|g| - |d| + eps)^2))", worst["ratio"],
          1.0, "max ratio")
    log(f"  the update's worst element: {worst}")
    check(f"GPT fp32 first AdamW update where both gradients are 0 "
          f"({zeros} elements): elements moved", nonzero_zero_grad, 0,
          "count")
    del dev, cpu
    return out


def zoo_gpt(torch, pt, amp, fa, pa, rpa, gen, nn_functional, kern):
    """11(a): GPT-3-1.3B at full depth. fp32: generate against the q-block
    and per-token engines (C21: those two equal). O2 bf16 (a bf16 GPT
    serves on bf16 pages, no rope): both engines with CUDA graphs, the
    replayed ticks, generate on the paged and the dense caches; layer
    0's captured inputs held and timed (B1 group 1 d 128, B4, kernels 6
    and 8 ``<bf16, bf16>``); one O2 AdamW step at 2 x 2048; 2 layers in
    fp32 against the CPU."""
    from paddle_tpu_torch.models import gpt as gpt_mod
    cfg = gpt_mod.gpt3_1p3b(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = gpt_mod.GPTForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  GPT-3-1.3B built in {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f} B parameters")
    prompts, warm, batch = zoo_prompts(cfg.vocab_size)
    res = {"params": n_params, "launches": {}, "by_variant": {}}

    def logits_fn(ids):
        with torch.inference_mode():
            return model(torch.as_tensor(ids[None], device="cuda"))[0, -1]

    # fp32: one generate batch and both engines on its rows, in order
    zero_counts(kern)
    want = model.generate(torch.as_tensor(batch, device="cuda"),
                          max_new_tokens=NEW_TOKENS,
                          use_paged_cache=True).cpu().numpy()
    check_variants("fp32 generate (paged)", by_variant(fa, pa, rpa), {
        "flash": {"float32 d128 g1 causal": n_layers},
        "paged": {"float32/float32": n_layers * (NEW_TOKENS - 1)}})
    res["launches"]["11a fp32 generate paged"] = read_counts(kern)
    fp32_runs = {}
    for impl in rpa.IMPLS:
        outs, st, _ = graph_run(torch, pt, kern, model, list(batch), warm,
                                True, dict(impl=impl))
        fp32_runs[impl] = [np.asarray(o).reshape(-1) for o in outs]
        if st["launches"][impl] != n_layers * st["ragged_steps"]:
            raise AssertionError(f"fp32 {impl}: launches {st['launches']}")
        res["launches"][f"11a fp32 {impl} engine"] = st["launches"]
    for a, b in zip(fp32_runs["qblock"], fp32_runs["token"]):
        if not np.array_equal(a, b):
            raise AssertionError("fp32 GPT: q-block and per-token engines "
                                 "disagree (C21)")
    res["fp32_streams"] = hold_streams(
        torch, "fp32 GPT generate (paged) vs the engines", logits_fn,
        list(batch), list(want), fp32_runs["qblock"])
    # O2 bf16: parameters bf16 but the norms, the pools take k's bf16
    amp.decorate(model, level="O2", dtype="bfloat16")
    torch.cuda.empty_cache()
    runs = {}
    with amp.auto_cast(**AMP_O2):
        for impl in rpa.IMPLS:
            runs[impl] = serve_bf16(torch, pt, kern, fa, pa, rpa, model,
                                    prompts, warm, impl, n_layers,
                                    "bfloat16/bfloat16")
            if runs[impl][1]["pool_dtypes"] != ["torch.bfloat16"]:
                raise AssertionError(f"O2 GPT {impl}: pools "
                                     f"{runs[impl][1]['pool_dtypes']}")
            res["launches"][f"11a O2 {impl} engine"] = \
                runs[impl][1]["launches"]
        res["serving"] = {impl: {
            "tokens_per_s": serving_rate(st, prompts), "ticks": st["steps"],
            "wall_s": st["wall"], "prefix_hits": st["hits"]}
            for impl, (_, st) in runs.items()}
        res["replayed"] = replayed_ticks(torch, pt, kern, model, prompts,
                                         warm, "GPT O2 q-block",
                                         dict(impl="qblock"))
        probe = TickProbe(torch, gen, model, n_layers)
        serve(torch, pt, kern, model, prompts, warm, impl="qblock",
              probes=[probe])
    dec_cap = decode_capture(gen, n_layers)
    flash_cap = flash_capture(nn_functional, n_layers)
    gens = {}
    for paged, probes in ((True, (dec_cap, flash_cap)), (False, ())):
        name = "paged" if paged else "dense"
        ids, st = zoo_generate(torch, amp, kern, fa, pa, rpa, model, batch,
                               paged, probes)
        want_v = {"flash": {"bfloat16 d128 g1 causal": n_layers}}
        if paged:
            want_v["paged"] = {"bfloat16/bfloat16":
                               n_layers * (NEW_TOKENS - 1)}
        check_variants(f"O2 generate ({name})", st["by_variant"], want_v)
        gens[name] = ids
        res["launches"][f"11a O2 generate {name}"] = st["launches"]
        res["by_variant"][f"11a O2 generate {name}"] = st["by_variant"]
        log(f"  O2 generate ({name}): 4 x 256 + {NEW_TOKENS} tokens in "
            f"{st['wall']:.3f} s")
    del logits_fn
    res["o2_generate_paged_vs_dense_equal"] = int(sum(
        np.array_equal(a, b) for a, b in zip(gens["paged"], gens["dense"])))
    # layer 0's captured inputs against the plain versions, then timed
    fc = flash_cap.best
    res["b1_errs"] = compare_flash_case(
        torch, fa, *(fc[k].transpose(1, 2) for k in ("q", "k", "v")), True,
        0, 0, "GPT O2 prefill, layer 0")
    dc = dec_cap.best
    res["b4_errs"] = compare_paged(torch, pa, dc["q"], dc["kp"], dc["vp"],
                                   dc["tables"], dc["ctx"],
                                   "GPT O2 paged decode step, layer 0")
    res["ragged_errs"] = {}
    for name, cap in (("mixed", probe.best), ("decode", probe.decode)):
        errs, _ = compare_kernels(torch, rpa, cap["q"], cap["kp"],
                                  cap["vp"], cap["tbl"], cap["desc"],
                                  f"GPT O2 {name} tick, layer 0")
        res["ragged_errs"][name] = errs
    res["timed"] = {
        "flash_prefill": zoo_time_flash(torch, fa, fc,
                                        "GPT-3-1.3B O2 generate prefill"),
        "paged": zoo_time_paged(torch, pa, dc, "GPT-3-1.3B O2 decode step"),
        **{f"ragged_{name}": zoo_time_ragged(torch, rpa, cap,
                                             f"GPT-3-1.3B O2 {name} tick")
           for name, cap in (("mixed", probe.best),
                             ("decode", probe.decode))}}
    del probe, dec_cap, flash_cap, model
    gc.collect()
    torch.cuda.empty_cache()
    # O2 AdamW steps at 2 x 2048, dropouts 0: B1-B3 at group 1; one more
    # keeps layer 0's q, k, v and dO (its backward comes last)
    model = gpt_mod.GPTForCausalLM(cfg, device="cuda", seed=0)
    train_cap = BackwardCapture(fa)
    batch_t, seq_t = ZOO_TRAIN["gpt"]
    res["train"] = zoo_train(torch, pt, amp, kern, fa, pa, rpa, model,
                             "GPT-3-1.3B O2 step", n_layers,
                             "bfloat16 d128 g1 causal", cfg.vocab_size,
                             batch_t, seq_t, cap=train_cap, trace=True)
    res["launches"]["11a O2 training steps"] = res["train"]["launches"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tc = dict(train_cap.best, causal=True)
    if tc["q_offset"] or tc["q"].dtype != torch.bfloat16:
        raise AssertionError(f"GPT step capture: q_offset {tc['q_offset']},"
                             f" {tc['q'].dtype}")
    # B1, B2 and B3 at the step's shape (group 1, d 128) against their
    # plain versions: bf16 on the captured bits, fp32 and fp16 on them too
    qkv = [tc[x].transpose(1, 2) for x in ("q", "k", "v")]
    label = "GPT-3-1.3B O2 training step, layer 0"
    res["train_b1_errs"] = compare_flash_case(torch, fa, *qkv, True, 0, 0,
                                              label)
    res["train_bwd_errs"] = compare_flash_bwd_case(
        torch, fa, *qkv, tc["dout"].transpose(1, 2), None, True, 0, 0,
        label)
    res["timed"]["flash_train"] = zoo_time_flash(
        torch, fa, tc, "GPT-3-1.3B O2 training step")
    del train_cap, tc, qkv
    torch.cuda.empty_cache()
    res["cpu"] = gpt_cpu_check(torch, pt, fa, kern, batch)
    res["launches"]["11a fp32 2-layer check"] = read_counts(kern)
    return res


def zoo_mixtral(torch, pt, amp, fa, pa, rpa, gen, kern):
    """11(b): Mixtral-8x7B widths at MIXTRAL_SERVE_LAYERS layers: fp32
    logits on a 64-token prompt and layer 0's routing plan against the
    CPU; under O2 ``generate`` on the paged cache and the q-block engine
    with CUDA graphs (the MoE inside the captured ticks); one O2 step at
    MIXTRAL_TRAIN_LAYERS layer."""
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import mixtral as mix_mod
    cfg = mix_mod.mixtral_8x7b(num_hidden_layers=MIXTRAL_SERVE_LAYERS)
    n_layers = cfg.num_hidden_layers
    res = {"launches": {}, "by_variant": {}}
    t0 = time.perf_counter()
    model = mix_mod.MixtralForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    res["params"] = sum(p.numel() for p in model.parameters())
    log(f"  Mixtral-8x7B widths, {n_layers} layers, built in "
        f"{time.perf_counter() - t0:.1f} s, {res['params'] / 1e9:.3f} B "
        f"parameters")
    prompt = np.random.RandomState(41).randint(0, cfg.vocab_size, (1, 64))
    seen = {}

    def capture(module, args):
        seen.setdefault(args[0].device.type, args[0].detach().clone())

    block = model.mixtral.layers[0].block_sparse_moe
    hook = block.register_forward_pre_hook(capture)
    with torch.inference_mode():
        logits = model(torch.as_tensor(prompt, device="cuda"))
    hook.remove()
    t0 = time.perf_counter()

    cpu = cpu_twin(model, lambda d: mix_mod.MixtralForCausalLM(cfg,
                                                               device=d))
    cpu.mixtral.init_rope("cpu")
    cpu.eval()
    cblock = cpu.mixtral.layers[0].block_sparse_moe
    hook = cblock.register_forward_pre_hook(capture)
    with torch.inference_mode():
        clog = cpu(torch.as_tensor(prompt))
    hook.remove()
    res["cpu_seconds"] = time.perf_counter() - t0
    res["logits_rel"] = rel_to_max(torch, logits, clog)
    check("Mixtral fp32 logits, card vs CPU (relative, 64 tokens)",
          res["logits_rel"], ZOO_LOGITS_TOL)
    # layer 0's plan on the card's captured hidden states, on both sides
    h = seen["cuda"].reshape(-1, cfg.hidden_size)
    s, e, k = h.shape[0], block.num_experts, block.top_k
    c = moe.moe_capacity(s, e, k, block.capacity_factor)
    with torch.inference_mode():
        lg_dev = h @ block.gate.weight.T
        lg_cpu = h.cpu() @ cblock.gate.weight.T
    p_dev, d_dev, _ = moe.plan_dispatch(lg_dev, c, k)
    p_cpu, d_cpu, _ = moe.plan_dispatch(lg_cpu, c, k)
    # a token's experts, as sets: a flipped choice moves the queue places
    # of the tokens after it, so the dispatch tensors are compared only
    # where no choice flipped
    choice_dev = torch.sort(moe.top_k_indices(p_dev, k).cpu(), -1).values
    choice_cpu = torch.sort(moe.top_k_indices(p_cpu, k), -1).values
    flips = np.nonzero((choice_dev != choice_cpu).any(-1).numpy())[0]
    if not flips.size and not torch.equal(d_dev.cpu(), d_cpu):
        raise AssertionError("Mixtral routing: the same choices, another "
                             "dispatch")
    srt = torch.sort(lg_cpu, -1, descending=True).values
    delta = (lg_dev.cpu() - lg_cpu).abs().amax(-1)
    held = []
    for r in flips.tolist():
        gap = float(srt[r, k - 1] - srt[r, k])
        held.append({"token": r, "logit_gap": gap,
                     "logit_diff": float(delta[r])})
        if gap > 2 * float(delta[r]):
            raise AssertionError(f"Mixtral routing: token {r} flips at a "
                                 f"gap {gap} beyond the logits' difference "
                                 f"{float(delta[r])}")
    res["routing"] = {"tokens": s, "capacity": c, "flips": held,
                      "router_logits_max_diff": float(delta.max())}
    log(f"  Mixtral layer 0 routing on the captured states: {s} tokens, "
        f"capacity {c}, {len(held)} flipped rows {held} (router logits "
        f"within {float(delta.max()):.3e} of the CPU's)")
    del cpu
    gc.collect()
    amp.decorate(model, level="O2", dtype="bfloat16")
    torch.cuda.empty_cache()
    prompts, warm, batch = zoo_prompts(cfg.vocab_size)
    ids, st = zoo_generate(torch, amp, kern, fa, pa, rpa, model, batch,
                           True)
    check_variants("Mixtral O2 generate (paged)", st["by_variant"], {
        "flash": {"bfloat16 d128 g4 causal": n_layers},
        "paged": {"bfloat16/float32": n_layers * (NEW_TOKENS - 1)}})
    res["launches"]["11b O2 generate paged"] = st["launches"]
    res["generate_wall"] = st["wall"]
    with amp.auto_cast(**AMP_O2):
        outs, st = serve(torch, pt, kern, model, prompts, warm)
        check_outputs(prompts, outs, cfg.vocab_size, "Mixtral O2 q-block")
        check_variants("Mixtral O2 q-block engine", by_variant(fa, pa, rpa),
                       {"qblock": {"bfloat16/float32":
                                   n_layers * st["steps"]}})
        if st["replays"] != st["steps"]:
            raise AssertionError(f"Mixtral: {st['replays']} replays of "
                                 f"{st['steps']} ticks")
    res["launches"]["11b O2 q-block engine"] = st["launches"]
    res["serving"] = {"tokens_per_s": serving_rate(st, prompts),
                      "ticks": st["steps"], "replays": st["replays"],
                      "wall_s": st["wall"]}
    log(f"  Mixtral O2 q-block engine: {st['steps']} ticks, all replayed, "
        f"{serving_rate(st, prompts):.1f} generated tokens/s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg_t = mix_mod.mixtral_8x7b(num_hidden_layers=MIXTRAL_TRAIN_LAYERS)
    model = mix_mod.MixtralForCausalLM(cfg_t, device="cuda", seed=0)
    batch_t, seq_t = ZOO_TRAIN["mixtral"]
    res["train"] = zoo_train(torch, pt, amp, kern, fa, pa, rpa, model,
                             "Mixtral O2 step", MIXTRAL_TRAIN_LAYERS,
                             "bfloat16 d128 g4 causal", cfg_t.vocab_size,
                             batch_t, seq_t)
    res["launches"]["11b O2 training steps"] = res["train"]["launches"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def zoo_bert(torch, pt, amp, fa, pa, rpa, nn_functional, kern):
    """11(c): BERT-base. BERT_STEPS AdamW fine-tune steps at BERT_BATCH x
    BERT_SEQ with a padding mask (the einsum route), BERT_TRAIN_LAYERS
    layers of full width, compiled (``jit.to_static``) and eager from the
    same weights, the losses within the reference test's tolerance; an
    eval forward of all 12 layers at ZOO_BERT_EVAL without a mask: B1
    non-causal at d 64, fp32 and under O1 bf16, held against its plain
    version and timed."""
    from paddle_tpu_torch.models import bert as bert_mod
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_mod.bert_base()
    model = bert_mod.BertForSequenceClassification(
        bert_mod.bert_base(num_hidden_layers=BERT_TRAIN_LAYERS),
        device="cuda", seed=0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(51)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                      (BERT_BATCH, BERT_SEQ)), device="cuda")
    labels = torch.as_tensor(rng.randint(0, 2, (BERT_BATCH,)), device="cuda")
    lens = rng.randint(BERT_SEQ // 4, BERT_SEQ + 1, BERT_BATCH)
    mask = torch.as_tensor((np.arange(BERT_SEQ)[None] < lens[:, None])
                           .astype(np.int64), device="cuda")
    res = {}
    for mode in ("eager", "compiled"):
        model.load_state_dict(state)
        model.eval()             # dropout off: the two runs comparable
        fwd = model
        if mode == "compiled":
            fwd = pt.jit.to_static(model)
        opt = AdamW(learning_rate=5e-5, parameters=model.parameters())
        losses, ms = [], []
        for _ in range(BERT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = fwd(ids, attention_mask=mask, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[mode] = {"losses": losses, "step_ms": ms}
        log(f"  BERT-base fine-tune, {mode}: losses {losses}, step ms "
            f"{[round(x, 2) for x in ms]}")
        if mode == "compiled":
            model.forward = model._dygraph_forward
        del opt
    err = np.abs(np.array(res["compiled"]["losses"])
                 - np.array(res["eager"]["losses"]))
    ratio = float(np.max(err / (BERT_ATOL + BERT_RTOL
                                * np.abs(res["eager"]["losses"]))))
    check("BERT-base compiled vs eager losses (err / (atol + rtol |eager|))",
          ratio, 1.0, "max ratio")
    res["loss_ratio"] = ratio
    model = bert_mod.BertForSequenceClassification(cfg, device="cuda",
                                                   seed=0)
    model.eval()
    b, s = ZOO_BERT_EVAL
    ev = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s)),
                         device="cuda")
    res["eval"] = {}
    for name, ctx, key in (
            ("fp32", contextlib.nullcontext(), "float32 d64 g1 full"),
            ("O1 bf16", amp.auto_cast(level="O1", dtype="bfloat16"),
             "bfloat16 d64 g1 full")):
        cap = flash_capture(nn_functional, cfg.num_hidden_layers)
        zero_counts(kern)
        with cap, ctx, torch.inference_mode():
            logits = model(ev)
        if not torch.isfinite(logits).all() or logits.shape != (b, 2):
            raise AssertionError(f"BERT eval {name}: logits {logits.shape}")
        launches = read_counts(kern)
        check_variants(f"BERT-base eval ({name}, seq {s}, no mask)",
                       by_variant(fa, pa, rpa),
                       {"flash": {key: cfg.num_hidden_layers}})
        fc = cap.best
        errs = compare_flash_case(
            torch, fa, *(fc[k].transpose(1, 2) for k in ("q", "k", "v")),
            False, 0, 0, f"BERT-base eval {name}, layer 0")
        res["eval"][name] = {"launches": launches, "errs": errs,
                             "timed": zoo_time_flash(
                                 torch, fa, fc, f"BERT-base eval {name}")}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def zoo_t5(torch, pt):
    """11(d): T5 at its default config (t5-small widths), fp32: the
    forward's logits and greedy ``generate`` on the card against the port
    on the CPU with the same weights."""
    from paddle_tpu_torch.models import t5 as t5_mod
    cfg = t5_mod.T5Config()
    model = t5_mod.T5ForConditionalGeneration(cfg, device="cuda", seed=0)
    cpu = cpu_twin(model, lambda d: t5_mod.T5ForConditionalGeneration(
        cfg, device=d))
    model.eval()
    cpu.eval()
    rng = np.random.RandomState(61)
    src = rng.randint(2, cfg.vocab_size, (2, 64))
    labels = rng.randint(2, cfg.vocab_size, (2, 32))
    with torch.inference_mode():
        _, dev_logits = model(src, labels=labels)
        _, cpu_logits = cpu(src, labels=labels)
    res = {"logits_rel": rel_to_max(torch, dev_logits, cpu_logits)}
    check("T5 fp32 logits, card vs CPU (relative)", res["logits_rel"],
          ZOO_LOGITS_TOL)
    got = model.generate(src, max_new_tokens=NEW_TOKENS).cpu().numpy()
    want = cpu.generate(src, max_new_tokens=NEW_TOKENS).numpy()

    def logits_fn_for(row):
        def fn(dec):
            with torch.inference_mode():
                return cpu(src[row:row + 1], decoder_input_ids=dec[None])[
                    0, -1]
        return fn
    res["streams"] = [hold_streams(
        torch, f"T5 greedy generate row {r}, card vs CPU", logits_fn_for(r),
        [got[r, :1]], [got[r]], [want[r]]) for r in range(got.shape[0])]
    return res


#: a kernel row's launches from a path's counts (``read_counts``)
LAUNCH_ROWS = {"flash_fwd_wgmma": lambda c: c["flash_wgmma"],
               "flash_fwd_simt": lambda c: c["flash"] - c["flash_wgmma"],
               "flash_bwd_dq_wgmma": lambda c: c["flash_bwd_dq_wgmma"],
               "flash_bwd_dq_simt": lambda c: c["flash_bwd_dq"]
               - c["flash_bwd_dq_wgmma"],
               "flash_bwd_dkv_wgmma": lambda c: c["flash_bwd_dkv_wgmma"],
               "flash_bwd_dkv_simt": lambda c: c["flash_bwd_dkv"]
               - c["flash_bwd_dkv_wgmma"],
               "paged_decode": lambda c: c["paged_cluster"]
               - c["paged_mixed"],
               "paged_decode_mixed": lambda c: c["paged_mixed"],
               "ragged_token": lambda c: c["token_cluster"]
               - c["token_mixed"],
               "ragged_qblock_mixed": lambda c: c["qblock_mixed"],
               "adam_step_multi_tensor": lambda c: c["adam_step"],
               "sum_squares_multi_tensor": lambda c: c["sum_squares"]}


def add_zoo_launches(rows, zoo):
    """Phase 11's launches into the kernel rows by path, and its timed
    shapes under ``zoo_shapes``."""
    paths = {**{k: v for k, v in zoo["gpt"]["launches"].items()},
             **zoo["mixtral"]["launches"],
             **{f"11c BERT eval {k}": v["launches"]
                for k, v in zoo["bert"]["eval"].items()}}
    g = zoo["gpt"]["timed"]
    shapes = {"flash_fwd_wgmma": [g["flash_prefill"], g["flash_train"],
                                  zoo["bert"]["eval"]["O1 bf16"]["timed"]],
              "flash_fwd_simt": [zoo["bert"]["eval"]["fp32"]["timed"]],
              "paged_decode": [g["paged"]],
              "ragged_qblock": [g["ragged_mixed"]["qblock"],
                                g["ragged_decode"]["qblock"]],
              "ragged_token": [g["ragged_mixed"]["token"],
                               g["ragged_decode"]["token"]]}
    # the errors of GPT's layer-0 captures (prefill and training step)
    # against the plain versions, in the rows' dtypes
    b1, tb1, tb = (zoo["gpt"][k] for k in ("b1_errs", "train_b1_errs",
                                          "train_bwd_errs"))
    zoo_errs = {"flash_fwd_wgmma": max(b1["bf16"], tb1["bf16"]),
                "flash_fwd_simt": max(b1["fp32"], tb1["fp32"]),
                "flash_bwd_dq_wgmma": tb["dq_bf16"],
                "flash_bwd_dq_simt": tb["dq_fp32_abs"],
                "flash_bwd_dkv_wgmma": max(tb["dk_bf16"], tb["dv_bf16"]),
                "flash_bwd_dkv_simt": max(tb["dk_fp32_abs"],
                                          tb["dv_fp32_abs"])}
    add_path_launches(rows, paths, shapes, zoo_errs, "zoo_shapes")


def add_path_launches(rows, paths, shapes, errs, shapes_key):
    """A phase's launches (``paths``: a path's counts by kernel name)
    into the kernel rows by path; its timed shapes (by row name) under
    ``shapes_key`` and its errors into each row's ``max_abs_err``."""
    for row in rows:
        name = row["name"]
        if name == "ragged_qblock":
            add = {k: {v: c[f"qblock_{v}"] - (c["qblock_mixed"]
                                              if v == "unit" else 0)
                       for v in ("unit", "runtime")}
                   for k, c in paths.items()}
            add = {k: v for k, v in add.items() if any(v.values())}
            row["launches"] += sum(sum(v.values()) for v in add.values())
        elif name in LAUNCH_ROWS:
            add = {k: LAUNCH_ROWS[name](c) for k, c in paths.items()
                   if LAUNCH_ROWS[name](c)}
            row["launches"] += sum(add.values())
        else:
            continue
        row.setdefault("launches_by_path", {}).update(add)
        if name in shapes:
            row[shapes_key] = shapes[name]
        if name in errs:
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])


def zoo_phase(torch, pt, amp, fa, pa, rpa, gen, nn_functional, kern):
    """Phase 11: the language-model zoo on the card."""
    t0 = time.perf_counter()
    zoo = {}
    phase(" 11(a): GPT-3-1.3B (24 layers, hidden 2048, 16 heads of 128): "
          "fp32 and O2 serving, an O2 step at 2 x 2048, 2 layers against "
          "the CPU")
    zoo["gpt"] = zoo_gpt(torch, pt, amp, fa, pa, rpa, gen, nn_functional,
                         kern)
    phase(f" 11(b): Mixtral-8x7B widths ({MIXTRAL_SERVE_LAYERS} layers to "
          f"serve, {MIXTRAL_TRAIN_LAYERS} to train)")
    zoo["mixtral"] = zoo_mixtral(torch, pt, amp, fa, pa, rpa, gen, kern)
    phase(f" 11(c): BERT-base: the to_static fine-tune at "
          f"{BERT_TRAIN_LAYERS} layers and an eval at {ZOO_BERT_EVAL[1]} "
          "tokens without a mask")
    zoo["bert"] = zoo_bert(torch, pt, amp, fa, pa, rpa, nn_functional, kern)
    phase(" 11(d): T5 (t5-small widths), fp32, against the CPU")
    zoo["t5"] = zoo_t5(torch, pt)
    zoo["seconds"] = time.perf_counter() - t0
    log(f"  phase 11 took {zoo['seconds']:.1f} s")
    return zoo


# ---------------------------------------------------------------------------
# phase 12: the vision zoo, PP-YOLOE and the RNNs
# ---------------------------------------------------------------------------

#: 12(a): ViT-B/16's O2 AdamW steps (``median_steps``) at VIT_BATCH,
#: its O2 eval at VIT_EVAL_BATCH, and the fp32 check against the CPU at
#: VIT_CPU_LAYERS layers of full width
VIT_BATCH, VIT_EVAL_BATCH, VIT_CPU_LAYERS, VIT_CPU_BATCH = 64, 128, 2, 2
#: B1-B3's launches at ViT-B/16's shape: 197 tokens, 12 heads of 64
VIT_KEY = "bfloat16 d64 g1 full"
#: 12(b): PP-YOLOE (BASELINE.json configs[2]) at 640 x 640 fed by
#: DataLoader workers with the example's augmentation; the fp32 check
#: against the CPU at PPYOLOE_CHECK_BATCH
PPYOLOE_SIZE, PPYOLOE_BATCH, PPYOLOE_WORKERS = 640, 8, 4
PPYOLOE_CHECK_BATCH, PPYOLOE_PREDICT_IMAGES = 2, 2
#: 12(c): (constructor, input size, input channels) of the conv zoo; the
#: fp32 check at batch ZOO_CHECK_BATCH, O2 eval at ZOO_EVAL_BATCH
CONV_ZOO = (("LeNet", 28, 1), ("vgg16", 224, 3), ("alexnet", 224, 3),
            ("squeezenet1_1", 224, 3), ("mobilenet_v1", 224, 3),
            ("mobilenet_v2", 224, 3), ("mobilenet_v3_large", 224, 3),
            ("shufflenet_v2_x1_0", 224, 3), ("densenet121", 224, 3),
            ("googlenet", 224, 3), ("inception_v3", 299, 3))
ZOO_CHECK_BATCH, ZOO_EVAL_BATCH, ZOO_EVAL_ITERS = 2, 64, 5
#: 12(d): the RNNs: batch, steps, input and hidden width; card against
#: CPU within RNN_TOL of each tensor's largest magnitude
RNN_BATCH, RNN_STEPS, RNN_WIDTH, RNN_TOL = 64, 128, 512, 1e-5
#: 12(e): the vision ops, card against CPU (TF32 off)
VISION_OPS_TOL = 1e-5
#: phase 8's rule in 12(b) and 12(c) measures a tensor smaller than this
#: share of its group's largest against that share (ROADMAP C42)
GROUP_FLOOR = 1e-3
#: 12(c)'s run on cuDNN's default fp32 algorithms is held by phase 8's
#: rule with this floor for the gradients: about twice AlexNet's
#: ``features.8`` bias gradient, 5.35e-3 from fp64 in every run, the
#: worst of the zoo; RESNET_FACTOR covers the rest (GoogLeNet's 3.07 x
#: the CPU's is the largest ratio) (ROADMAP C45)
CUDNN_GRAD_FLOOR = 1e-2


class DetectionData:
    """``examples/train_ppyoloe_pipeline.py``'s ``SyntheticDetection``
    (numpy only): item ``i`` from ``default_rng(i)``, a flipped, scaled
    and jittered random image and dense per-level targets (class hits at
    2 %, ltrb distances, positives at 10 %)."""

    def __init__(self, size=64, img=64, classes=4):
        self.size, self.img, self.classes = size, img, classes

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = rng.integers(0, 256, (3, self.img, self.img)).astype(
            np.float32)
        if rng.random() < 0.5:
            img = img[:, :, ::-1]
        img = (img / 127.5) - 1.0
        img = img + rng.normal(0, 0.01, img.shape).astype(np.float32)
        tcls, treg, mask = [], [], []
        for stride in (8, 16, 32):
            g = self.img // stride
            tcls.append(rng.random((self.classes, g, g)).astype(np.float32)
                        < 0.02)
            treg.append(rng.random((4, g, g)).astype(np.float32) * 4)
            mask.append((rng.random((4, g, g)) < 0.1).astype(np.float32))
        return (img.astype(np.float32),
                [t.astype(np.float32) for t in tcls], treg, mask)


def detection_collate(batch):
    """The example's ``collate``: images stacked, each level's targets
    stacked."""
    return (np.stack([b[0] for b in batch]),
            *([np.stack([b[k][lv] for b in batch]) for lv in range(3)]
              for k in (1, 2, 3)))


class ImageNetData:
    """``n`` 3 x ``size`` x ``size`` images and labels of ``classes``:
    item ``i`` is image ``i % pool`` of a pool of standard-normal images
    drawn once from ``default_rng(seed)`` (a worker copies, it does not
    draw) and a label from ``default_rng(seed + i)``."""

    def __init__(self, n, size, classes, seed=0, pool=16):
        self.n, self.classes, self.seed = n, classes, seed
        self.pool = np.random.default_rng(seed).standard_normal(
            (min(pool, n), 3, size, size), dtype=np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed + i)
        return (self.pool[i % len(self.pool)].copy(),
                np.int64(rng.integers(0, self.classes)))


def time_flash_bwd_full(torch, fa, cap, label):
    """B2 and B3 on a captured non-causal training backward (``[b, s, h,
    d]``), their plain versions and PyTorch's SDPA backward (dq, dk and
    dv in one call) on the same data, with the bounds. Returns a row a
    kernel."""
    q, k, v, dout = (cap[x] for x in ("q", "k", "v", "dout"))
    b, sq, hq, d = q.shape
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous()
                      for x in (q, k, v, dout))
    shape = (f"{label}: b={b} sq={sq} sk={k.shape[1]} non-causal "
             f"{hq}/{k.shape[2]} heads d={d} "
             f"{str(q.dtype).removeprefix('torch.')}")
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(qt, kt, vt, False)
        delta = fa.bwd_delta(out, dt)
        args = (lse, delta, False, None, 0, 0)
        rows = {}
        for key, kern_fn, plain_fn in (
                ("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain),
                ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain)):
            rows[key] = dict(
                shape=shape,
                ms=time_ms(torch, lambda: kern_fn(q, k, v, dout, *args,
                                                  kernel_layout=False)),
                plain_ms=time_ms(torch, lambda: plain_fn(
                    *(x.float() for x in (qt, kt, vt, dt)), *args),
                    iters=5),
                **zoo_flash_bound(q, k, False, **BWD_BOUNDS[key]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    lib_out = sdpa(ql, kl, vl)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dt, retain_graph=True))
    for key, row in rows.items():
        row.update(library_ms=lib_ms, library="sdpa backward (non-causal):"
                   " dq, dk and dv in one call, the B2 + B3 pair")
        log(f"  B{2 if key == 'dq' else 3} at {shape}: {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} "
            f"ms ({row['bound_by']}), SDPA backward {lib_ms:.4f} ms")
    del lib_out, ql, kl, vl
    return rows


def vit_cpu_check(torch, pt):
    """12(a) against the CPU: ViT-B/16's widths at VIT_CPU_LAYERS layers,
    fp32 (TF32 off), one batch of VIT_CPU_BATCH: the card's logits and
    every gradient of a cross-entropy loss against the port on the CPU
    with the same weights, each within ZOO_LOGITS_TOL of its largest
    (B1-B3's fp32 kernels against their plain versions on the CPU)."""
    vit = pt.vision.models.vit_base_patch16_224
    pt.set_device("cpu")
    try:
        pt.seed(5)
        cpu = vit(depth=VIT_CPU_LAYERS)
        card = copy.deepcopy(cpu).to("cuda")
    finally:
        pt.set_device("gpu:0")
    data = ImageNetData(VIT_CPU_BATCH, 224, 1000, seed=900)
    x = torch.from_numpy(np.stack([data[i][0] for i in range(len(data))]))
    y = torch.as_tensor([int(data[i][1]) for i in range(len(data))])
    loss_fn = pt.nn.CrossEntropyLoss()
    out = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        logits = m(x.to(dev))
        loss_fn(logits, y.to(dev)).backward()
        out[name] = (logits, {n: p.grad for n, p in m.named_parameters()})
    res = {"logits": rel_to_max(torch, out["card"][0], out["cpu"][0])}
    res["grads"] = max(rel_to_max(torch, g, out["cpu"][1][n])
                       for n, g in out["card"][1].items())
    check("ViT-B/16 fp32 logits, card vs CPU (relative)", res["logits"],
          ZOO_LOGITS_TOL)
    check("ViT-B/16 fp32 gradients, card vs CPU (relative, worst)",
          res["grads"], ZOO_LOGITS_TOL)
    return res


def vit_phase(torch, pt, amp, fa, pa, rpa, kern, smi):
    """12(a): ViT-B/16 at full width (12 layers, 768, 12 heads of 64,
    197 tokens). O2 bf16 AdamW steps at VIT_BATCH on DataLoader batches:
    B1-B3 once a layer a step at VIT_KEY; the median step split, peak
    memory and one traced step's idle share. The O2 eval's images/s at
    VIT_EVAL_BATCH (B1 only). Layer 0's captured q, k, v and dO held to
    the plain versions by C15 and C17 in bf16 and fp16 and timed against
    SDPA; and the fp32 check against the CPU."""
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(0)
    model = pt.vision.models.vit_base_patch16_224()
    n_layers = len(model.blocks)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.05)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    model.train()
    loss_fn = pt.nn.CrossEntropyLoss()
    n = VIT_BATCH * (ZOO_WARM_STEPS + ZOO_COUNTED_STEPS + 2)
    loader = pt.io.DataLoader(ImageNetData(n, 224, 1000, seed=100),
                              batch_size=VIT_BATCH, num_workers=4,
                              drop_last=True)

    def head(x, labels):
        return loss_fn(model(x), labels), None

    def step(x, y):
        return zoo_step(torch, head, opt, x, y,
                        lambda: amp.auto_cast(**AMP_O2))

    res, it = median_steps(torch, kern, step, loader, "ViT-B/16 O2 step")
    variants = by_variant(fa, pa, rpa)
    check_variants("ViT-B/16 O2 steps", variants,
                   {w: {VIT_KEY: n_layers * ZOO_COUNTED_STEPS}
                    for w in ("flash", "flash_bwd_dq", "flash_bwd_dkv")})
    res["by_variant"] = variants
    res["images_per_s"] = VIT_BATCH / res["ms"]["step"] * 1e3
    cap = BackwardCapture(fa, causal=False)
    with cap:
        step(*next(it))
    traced_batch = next(it)
    res["traced"] = traced_window(torch, lambda: step(*traced_batch))
    res["traced"].pop("names")
    res["loader"] = dict(loader.stats)
    log(f"  ViT-B/16 O2 AdamW at batch {VIT_BATCH} ({smi}): losses "
        + ", ".join(f"{x:.4f}" for x in res["losses"])
        + f"; median step {res['ms']['step']:.2f} ms (forward "
        f"{res['ms']['forward']:.2f}, backward {res['ms']['backward']:.2f},"
        f" optimizer {res['ms']['optimizer']:.2f}; spread "
        f"{res['spread']:.3f}), {res['images_per_s']:.1f} images/s, peak "
        f"{res['peak_gib']:.2f} GiB; one "
        f"traced step {res['traced']['window_ms']:.2f} ms, device busy "
        f"{res['traced']['busy_ms']:.2f}, idle share "
        f"{res['traced']['idle_share']:.3f}; loader waits "
        f"{res['loader']['wait_s']:.3f} s over {res['loader']['batches']} "
        f"batches")
    # O2 eval at VIT_EVAL_BATCH: B1 alone
    model.eval()
    x = torch.randn((VIT_EVAL_BATCH, 3, 224, 224), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    times = []
    zero_counts(kern)
    with torch.inference_mode(), amp.auto_cast(**AMP_O2):
        for i in range(ZOO_WARM_STEPS + ZOO_COUNTED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ev_variants = by_variant(fa, pa, rpa)
    check_variants("ViT-B/16 O2 eval", ev_variants, {"flash": {
        VIT_KEY: n_layers * (ZOO_WARM_STEPS + ZOO_COUNTED_STEPS)}})
    if not torch.isfinite(logits).all() or logits.shape != (
            VIT_EVAL_BATCH, 1000):
        raise AssertionError(f"ViT eval logits {logits.shape}")
    ms = float(np.median(times[ZOO_WARM_STEPS:]))
    res["eval"] = dict(batch=VIT_EVAL_BATCH, ms=ms, launches=read_counts(
        kern), images_per_s=VIT_EVAL_BATCH / ms * 1e3)
    log(f"  ViT-B/16 O2 eval at batch {VIT_EVAL_BATCH}: {ms:.2f} ms, "
        f"{res['eval']['images_per_s']:.1f} images/s")
    del model, opt, loader, it, x, logits
    gc.collect()
    torch.cuda.empty_cache()
    # layer 0's captured step inputs against the plain versions, timed
    tc = cap.best
    if tc["q"].dtype != torch.bfloat16 or tuple(tc["q"].shape) != (
            VIT_BATCH, 197, 12, 64):
        raise AssertionError(f"ViT capture: {tc['q'].dtype} "
                             f"{tuple(tc['q'].shape)}")
    qkv = [tc[x].transpose(1, 2) for x in ("q", "k", "v")]
    label = "ViT-B/16 O2 training step, layer 0"
    res["b1_errs"] = compare_flash_case(torch, fa, *qkv, False, 0, 0, label)
    res["bwd_errs"] = compare_flash_bwd_case(
        torch, fa, *qkv, tc["dout"].transpose(1, 2), None, False, 0, 0,
        label)
    res["timed"] = {"fwd": zoo_time_flash(torch, fa, tc,
                                          "ViT-B/16 O2 training step"),
                    **time_flash_bwd_full(torch, fa, tc,
                                          "ViT-B/16 O2 training step")}
    del cap, tc, qkv
    torch.cuda.empty_cache()
    res["cpu"] = vit_cpu_check(torch, pt)
    return res


def group_distance(a, b, keys):
    """The largest distance of ``a[n]`` from ``b[n]`` over ``keys`` and
    the tensor that has it: each tensor against its own largest
    magnitude, floored at GROUP_FLOOR of the group's largest: a gradient
    that cancels or a BatchNorm mean that is zero by construction (a
    BatchNorm fed by a bias-free 1 x 1 conv of a BatchNorm, C42) carries
    roundoff alone."""
    big = max(float(b[n].double().abs().max()) for n in keys)
    return max((float((a[n].double().cpu() - b[n].double().cpu())
                      .abs().max()) / max(float(b[n].double().abs().max()),
                                          GROUP_FLOOR * big, 1e-30), n)
               for n in keys)


def staged_against_f64(torch, pt, build, x, run, label, also_cudnn=False):
    """Phase 8's rule on one model: ``build()`` on the CPU (seeded), a copy
    on the card and an fp64 copy on the CPU; ``run(model, x)`` gives named
    tensors per group (``"out"``, ``"grad"``, ``"buffer"``). Each group
    of the card's run is at most RESNET_FACTOR times as far from the fp64
    run's as the CPU fp32 run's is, or RESNET_FLOOR; each tensor's
    distance is relative to its largest magnitude, or to GROUP_FLOOR of
    its group's largest where that is more. With ``also_cudnn`` the first
    card run uses PyTorch's own CUDA convolutions (cuDNN off), and a
    second card run with cuDNN's default fp32 algorithms is held by the
    same rule with the gradients' floor CUDNN_GRAD_FLOOR (ROADMAP C45).
    Returns the distances (with the worst tensor) and the last card
    copy."""
    pt.set_device("cpu")
    try:
        cpu = build()
        cards = [copy.deepcopy(cpu).to("cuda") for _ in range(1 + also_cudnn)]
        f64 = copy.deepcopy(cpu).double()
        want = run(cpu, x)
        exact = run(f64, x.double())
    finally:
        pt.set_device("gpu:0")
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = not also_cudnn
    try:
        got = run(cards[0], x.to("cuda"))
    finally:
        torch.backends.cudnn.enabled = enabled

    lib = run(cards[1], x.to("cuda")) if also_cudnn else None
    errs = {}
    for group in ("out", "grad", "buffer"):
        keys = [n for n in got if n.split(" ")[0] == group]
        if not keys:
            continue
        (card_d, worst), (cpu_d, _) = (group_distance(got, exact, keys),
                                       group_distance(want, exact, keys))
        tol = held_to_f64(f"{label} fp32 {group}", card_d, cpu_d, worst)
        errs[group] = dict(card=card_d, cpu=cpu_d, worst=worst)
        if lib is not None:
            lib_d, lib_worst = group_distance(lib, exact, keys)
            check(f"{label} fp32 {group}, cuDNN: card vs fp64 (cpu fp32 "
                  f"{cpu_d:.3e}; worst {lib_worst})", lib_d,
                  max(tol, CUDNN_GRAD_FLOOR if group == "grad" else 0.0),
                  "max err / max")
            errs[group]["cudnn"], errs[group]["cudnn_worst"] = (lib_d,
                                                                lib_worst)
    return errs, cards[-1]


def no_dropout(model):
    """Dropout off (``p = 0``) on every layer: the card's and the CPU's
    draws differ."""
    for m in model.sublayers():
        if hasattr(m, "p") and type(m).__name__.startswith("Dropout"):
            m.p = 0.0
    return model


def train_run_cot(torch, seed=7):
    """A training-mode run for ``staged_against_f64``: the outputs, the
    gradients of ``sum(out * cot)`` (cotangents seeded on the CPU) and
    the buffers, named by group."""
    def run(model, x):
        model.train()
        outs = model(x)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        gen = torch.Generator().manual_seed(seed)
        loss = sum((o * torch.randn(o.shape, generator=gen).to(o)).sum()
                   for o in outs)
        loss.backward()
        named = {f"out {i}": o.detach() for i, o in enumerate(outs)}
        named.update({f"grad {n}": p.grad for n, p in
                      model.named_parameters()})
        named.update({f"buffer {n}": b for n, b in model.named_buffers()})
        return named
    return run


def ppyoloe_phase(torch, pt, kern, smi):
    """12(b): PP-YOLOE as the reference defines it (80 classes, width 32,
    depth 1, neck 96) at 640 x 640: fp32 AdamW steps at PPYOLOE_BATCH on
    batches from PPYOLOE_WORKERS DataLoader workers running the example's
    augmentation; the loop's wait for each batch, images/s and one traced
    step's idle share. ``predict`` on PPYOLOE_PREDICT_IMAGES images: the
    points that clear the threshold, the boxes kept, NMS's ms, and the
    kept set against the CPU's ``nms`` on the same arrays. One fp32 step
    at PPYOLOE_CHECK_BATCH against the CPU by phase 8's rule."""
    from paddle_tpu_torch.models import ppyoloe as ppyoloe_mod
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.vision import ops as vops
    pt.seed(0)
    model = ppyoloe_mod.PPYOLOE()
    loss_fn = ppyoloe_mod.DetectionLoss()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    n = PPYOLOE_BATCH * (ZOO_WARM_STEPS + ZOO_COUNTED_STEPS + 1)
    loader = pt.io.DataLoader(DetectionData(n, PPYOLOE_SIZE, 80),
                              batch_size=PPYOLOE_BATCH,
                              num_workers=PPYOLOE_WORKERS, drop_last=True,
                              collate_fn=detection_collate)

    def head(imgs, labels):
        model.train()
        return loss_fn(*model(imgs), *labels), None

    def step(imgs, targets):
        return zoo_step(torch, head, opt, imgs, targets,
                        contextlib.nullcontext)

    res, it = median_steps(torch, kern, step,
                            ((b[0], b[1:]) for b in loader), "PP-YOLOE step")
    # the fused AdamW step (K-A) is the only port kernel on this path
    if not res["launches"]["adam_step"] or any(
            n for k, n in res["launches"].items() if k != "adam_step"):
        raise AssertionError(f"PP-YOLOE launches: {res['launches']}")
    res["loader"] = dict(loader.stats)
    res["images_per_s"] = PPYOLOE_BATCH / res["ms"]["step"] * 1e3
    batch = next(it)
    res["traced"] = traced_window(torch, lambda: step(*batch))
    res["traced"].pop("names")
    waits = res["loader"]
    log(f"  PP-YOLOE fp32 AdamW at batch {PPYOLOE_BATCH}, "
        f"{PPYOLOE_SIZE} x {PPYOLOE_SIZE}, {PPYOLOE_WORKERS} loader "
        f"workers ({smi}): losses "
        + ", ".join(f"{x:.4f}" for x in res["losses"])
        + f"; median step {res['ms']['step']:.2f} ms (forward "
        f"{res['ms']['forward']:.2f}, backward {res['ms']['backward']:.2f},"
        f" optimizer {res['ms']['optimizer']:.2f}), "
        f"{res['images_per_s']:.1f} images/s; the loop waited "
        f"{waits['wait_s']:.3f} s for {waits['batches']} batches (max "
        f"{waits['max_wait_s']:.3f} s); peak {res['peak_gib']:.2f} GiB; "
        f"one traced step {res['traced']['window_ms']:.2f} ms, idle share "
        f"{res['traced']['idle_share']:.3f}")
    # predict: NMS's matrix on the card, its scan on the host, timed and
    # held against the CPU's nms on the same arrays
    calls, orig = [], vops.nms

    def timed_nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
                  categories=None, top_k=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = orig(boxes, iou_threshold, scores, category_idxs, top_k=top_k)
        torch.cuda.synchronize()
        calls.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          boxes=boxes, scores=scores, cats=category_idxs,
                          thr=iou_threshold))
        return keep
    vops.nms = timed_nms
    try:
        dets = model.predict(batch[0][:PPYOLOE_PREDICT_IMAGES])
    finally:
        vops.nms = orig
    res["predict"] = []
    for i, (c, d) in enumerate(zip(calls, dets)):
        cpu_keep = orig(c["boxes"].cpu(), c["thr"], c["scores"].cpu(),
                        c["cats"].cpu()).numpy()
        card_all = orig(c["boxes"], c["thr"], c["scores"],
                        c["cats"]).cpu().numpy()
        row = dict(cleared=int(c["boxes"].shape[0]),
                   kept=int(len(card_all)), returned=len(d["boxes"]),
                   nms_ms=c["ms"], equal=bool(np.array_equal(card_all,
                                                             cpu_keep)))
        if not row["equal"]:
            # the IoUs where the two sets part, and their distance from
            # the threshold
            diff = np.setxor1d(card_all, cpu_keep)
            iou = vops.box_iou(c["boxes"][diff].cpu(),
                               c["boxes"].cpu()).numpy()
            row["differ"] = diff.tolist()[:10]
            row["iou_gap"] = float(np.abs(iou - c["thr"]).min())
            raise AssertionError(f"PP-YOLOE predict image {i}: the card's "
                                 f"NMS set differs from the CPU's {row}")
        res["predict"].append(row)
        log(f"  PP-YOLOE predict image {i}: {row['cleared']} points clear "
            f"the 0.4 score, NMS keeps {row['kept']} (returns "
            f"{row['returned']}), {row['nms_ms']:.2f} ms; the kept set "
            f"equals the CPU's nms on the same arrays")
    del model, opt, loader, it, batch, calls, dets
    gc.collect()
    torch.cuda.empty_cache()
    # one fp32 step against the CPU by phase 8's rule
    data = DetectionData(PPYOLOE_CHECK_BATCH, PPYOLOE_SIZE, 80)
    imgs, tcls, treg, mask = detection_collate([data[i] for i in range(
        PPYOLOE_CHECK_BATCH)])

    def run(m, x):
        m.train()
        to = (lambda a: torch.from_numpy(a).to(x))
        cls, reg = m(x)
        loss = loss_fn(cls, reg, [to(t) for t in tcls], [to(t) for t in treg],
                       [to(t) for t in mask])
        loss.backward()
        named = {f"out {i}": o.detach() for i, o in enumerate(cls + reg)}
        named["out loss"] = loss.detach().reshape(1)
        named.update({f"grad {n}": p.grad for n, p in m.named_parameters()})
        named.update({f"buffer {n}": b for n, b in m.named_buffers()})
        return named

    def build():
        pt.seed(4)
        return ppyoloe_mod.PPYOLOE()
    res["fp32"], _ = staged_against_f64(torch, pt, build,
                                        torch.from_numpy(imgs), run,
                                        "PP-YOLOE 640")
    return res


def conv_zoo_phase(torch, pt, amp, kern, smi):
    """12(c): each model of CONV_ZOO: one fp32 training-mode forward and
    backward at ZOO_CHECK_BATCH (dropout off, GoogLeNet's auxiliary heads
    on) held against the CPU by phase 8's rule on PyTorch's own CUDA
    convolutions and on cuDNN's (C45), then O2 bf16 eval
    images/s at ZOO_EVAL_BATCH (cuDNN). None launches a port kernel."""
    models = pt.vision.models
    res = {}
    for name, size, ch in CONV_ZOO:
        x = torch.from_numpy(np.random.default_rng(size).standard_normal(
            (ZOO_CHECK_BATCH, ch, size, size)).astype(np.float32))

        def build(name=name):
            pt.seed(6)
            return no_dropout(getattr(models, name)(num_classes=1000))
        zero_counts(kern)
        errs, card = staged_against_f64(torch, pt, build, x,
                                        train_run_cot(torch), name,
                                        also_cudnn=True)
        amp.decorate(card, level="O2", dtype="bfloat16")
        card.eval()
        xe = torch.randn((ZOO_EVAL_BATCH, ch, size, size), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
        times = []
        with torch.inference_mode(), amp.auto_cast(**AMP_O2):
            for _ in range(ZOO_WARM_STEPS + ZOO_EVAL_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = card(xe)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (ZOO_EVAL_BATCH, 1000) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{name} O2 eval: logits {logits.shape}")
        launches = read_counts(kern)
        if any(launches.values()):
            raise AssertionError(f"{name} launched a port kernel: "
                                 f"{launches}")
        ms = float(np.median(times[ZOO_WARM_STEPS:]))
        res[name] = dict(fp32=errs, eval_ms=ms,
                         eval_images_per_s=ZOO_EVAL_BATCH / ms * 1e3)
        log(f"  {name} at {size} x {size}: fp32 step vs fp64, card "
            + ", ".join(f"{g} {e['card']:.2e} (cpu {e['cpu']:.2e}, cuDNN "
                        f"{e['cudnn']:.2e} at {e['cudnn_worst']})"
                        for g, e in errs.items())
            + f"; O2 eval at batch {ZOO_EVAL_BATCH} {ms:.2f} ms, "
            f"{res[name]['eval_images_per_s']:.1f} images/s ({smi})")
        del card, xe, logits
        gc.collect()
        torch.cuda.empty_cache()
    return res


def rnn_phase(torch, pt):
    """12(d): a 2-layer bidirectional LSTM, a GRU and a SimpleRNN (input
    and hidden RNN_WIDTH, batch RNN_BATCH, RNN_STEPS steps, ragged
    ``sequence_length``): outputs, final states and every gradient of
    ``sum(out * cot)`` on the card against the CPU with the same weights,
    within RNN_TOL of each tensor's largest magnitude; the card's forward
    and backward ms."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(
        (RNN_BATCH, RNN_STEPS, RNN_WIDTH)).astype(np.float32))
    lens = torch.from_numpy(rng.integers(RNN_STEPS // 4, RNN_STEPS + 1,
                                         RNN_BATCH).astype(np.int64))
    cot = torch.from_numpy(rng.standard_normal(
        (RNN_BATCH, RNN_STEPS, 2 * RNN_WIDTH)).astype(np.float32))
    res = {}
    for name, kw in (("LSTM", dict(num_layers=2, direction="bidirect")),
                     ("GRU", {}), ("SimpleRNN", {})):
        pt.set_device("cpu")
        try:
            pt.seed(8)
            cpu = getattr(pt.nn, name)(RNN_WIDTH, RNN_WIDTH, **kw)
            card = copy.deepcopy(cpu).to("cuda")
        finally:
            pt.set_device("gpu:0")
        got = {}
        for tag, m, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
            xin = x.detach().to(dev).requires_grad_(True)
            out, state = m(xin, sequence_length=lens.to(dev))
            c = cot[..., :out.shape[-1]].to(dev)
            (out * c).sum().backward()
            states = state if isinstance(state, tuple) else (state,)
            got[tag] = {"out": out.detach(), **{f"state {i}": s.detach()
                                                 for i, s in
                                                 enumerate(states)},
                        "grad x": xin.grad,
                        **{f"grad {n}": p.grad for n, p in
                           m.named_parameters()}}
        worst = max(rel_to_max(torch, got["card"][k], got["cpu"][k])
                    for k in got["cpu"])
        check(f"{name} card vs CPU (each tensor's largest)", worst, RNN_TOL)
        xin = x.to("cuda").requires_grad_(True)
        cc = cot[..., :got["card"]["out"].shape[-1]].to("cuda")
        fwd_ms, bwd_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = card(xin, sequence_length=lens.to("cuda"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (out * cc).sum().backward()
            torch.cuda.synchronize()
            fwd_ms.append((t1 - t0) * 1e3)
            bwd_ms.append((time.perf_counter() - t1) * 1e3)
        res[name] = dict(worst=worst, forward_ms=float(np.median(fwd_ms)),
                         backward_ms=float(np.median(bwd_ms)))
        log(f"  {name} {kw} at batch {RNN_BATCH} x {RNN_STEPS} steps x "
            f"{RNN_WIDTH}: card vs CPU {worst:.2e} of each tensor's "
            f"largest; forward {res[name]['forward_ms']:.2f} ms, backward "
            f"{res[name]['backward_ms']:.2f} ms")
    return res


def vision_ops_phase(torch, pt):
    """12(e): the vision ops on the card against the CPU on the same
    seeded inputs: ``nms`` on 8,400 overlapping boxes (with 80 categories
    and without; the kept indices equal), ``roi_align``, ``roi_pool``, ``ps_roi_pool``,
    ``deform_conv2d`` (with the gradients of x, the offsets, the mask and
    the weight), ``yolo_box``, ``matrix_nms``, ``prior_box`` and
    ``distribute_fpn_proposals`` within VISION_OPS_TOL of each result's
    largest magnitude, integer results equal; ``box_coder`` raises on
    both, as the reference's does."""
    from paddle_tpu_torch.vision import ops as vops
    rng = np.random.default_rng(13)
    feat = rng.standard_normal((2, 256, 50, 68)).astype(np.float32)
    xy = rng.uniform(0, 700, (128, 2))
    wh = rng.uniform(8, 300, (128, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    nums = np.asarray([60, 68], np.int64)
    yolo = rng.standard_normal((2, 3 * 85, 20, 20)).astype(np.float32)
    img = np.asarray([[640, 640], [608, 640]], np.int64)
    dx = rng.standard_normal((2, 64, 32, 32)).astype(np.float32)
    off = (rng.standard_normal((2, 18, 32, 32)) * 2).astype(np.float32)
    msk = rng.uniform(0, 1, (2, 9, 32, 32)).astype(np.float32)
    wt = rng.standard_normal((64, 64, 3, 3)).astype(np.float32) * 0.05
    nms_boxes = np.concatenate([xy / 800, (xy + wh) / 800], 1).astype(
        np.float32)
    # 8,400 overlapping boxes (a 640 x 640 image's anchor points), 80
    # categories: nms's kept set, card against CPU
    pxy = rng.uniform(0, 600, (8400, 2))
    pwh = rng.uniform(10, 200, (8400, 2))
    det = np.concatenate([pxy, pxy + pwh], 1).astype(np.float32)
    det_scores = rng.uniform(0, 1, 8400).astype(np.float32)
    det_cats = rng.integers(0, 80, 8400).astype(np.int64)
    nms_scores = rng.uniform(0, 1, (80, 128)).astype(np.float32)

    def deform(x, o, m, w):
        for t in (x, o, m, w):
            t.requires_grad_(True)
        out = vops.deform_conv2d(x, o, w, None, 1, 1, 1, 1, 1, m)
        out.square().sum().backward()
        return [out, x.grad, o.grad, m.grad, w.grad]

    cases = {
        "nms": (lambda b, s, c: [vops.nms(b, 0.5, s, c),
                                 vops.nms(b, 0.5, s)],
                (det, det_scores, det_cats)),
        "roi_align": (lambda f, r, n: vops.roi_align(f, r, n, 7, 1 / 16),
                      (feat, rois, nums)),
        "roi_pool": (lambda f, r, n: vops.roi_pool(f, r, n, 7, 1 / 16),
                     (feat[:, :64], rois[:32], np.asarray([16, 16]))),
        "ps_roi_pool": (lambda f, r, n: vops.ps_roi_pool(
            f[:, :196], r, n, 7, 1 / 16), (feat, rois[:32],
                                            np.asarray([16, 16]))),
        "deform_conv2d": (deform, (dx, off, msk, wt)),
        "yolo_box": (lambda p, i: vops.yolo_box(
            p, i, [10, 13, 16, 30, 33, 23], 80, 0.01, 32), (yolo, img)),
        "matrix_nms": (lambda b, s: vops.matrix_nms(b, s, 0.5, 0.1, 64, 100),
                       (nms_boxes, nms_scores)),
        "prior_box": (lambda f, i: vops.prior_box(
            f, i, [32.0, 64.0], [64.0, 128.0], [2.0], flip=True, clip=True),
            (feat, np.zeros((2, 3, 800, 1088), np.float32))),
        "distribute_fpn_proposals": (lambda r, n: [
            *vops.distribute_fpn_proposals(r, 2, 5, 4, 224, rois_num=n)[0],
            vops.distribute_fpn_proposals(r, 2, 5, 4, 224, rois_num=n)[1]],
            (rois, np.asarray([60, 68], np.int32)))}
    res = {}
    for name, (fn, arrays) in cases.items():
        outs = {}
        for dev in ("cpu", "cuda"):
            got = fn(*(torch.from_numpy(a.copy()).to(dev) for a in arrays))
            got = got if isinstance(got, (list, tuple)) else [got]
            outs[dev] = [g.detach().cpu() for g in got]
        worst = 0.0
        for a, b in zip(outs["cuda"], outs["cpu"]):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name}: card {a.shape} {a.dtype}, "
                                     f"cpu {b.shape} {b.dtype}")
            if a.is_floating_point():
                if b.numel():
                    worst = max(worst, rel_to_max(torch, a, b))
            elif not torch.equal(a, b):
                raise AssertionError(f"{name}: integer results differ")
        check(f"vision op {name} card vs CPU", worst, VISION_OPS_TOL,
              "max err / max")
        res[name] = worst
    for dev in ("cpu", "cuda"):
        try:
            vops.box_coder(torch.zeros(1, 4, device=dev), None,
                           torch.zeros(1, 4, device=dev))
        except NotImplementedError:
            continue
        raise AssertionError("box_coder did not raise")
    res["box_coder"] = "raises NotImplementedError on both, as the reference"
    log(f"  vision ops card vs CPU (max err / max): "
        + ", ".join(f"{k} {v:.2e}" for k, v in res.items()
                    if isinstance(v, float)))
    return res


def add_vision_launches(rows, vis):
    """Phase 12's launches (B1-B3 in ViT's counted steps and eval, K-A in
    those steps and PP-YOLOE's) into the kernel rows, ViT's timed shapes
    under ``vit_shapes`` and its layer-0 errors against the plain
    versions."""
    paths = {"12a ViT-B/16 O2 training steps": vis["vit"]["launches"],
             "12a ViT-B/16 O2 eval": vis["vit"]["eval"]["launches"],
             "12b PP-YOLOE fp32 steps": vis["ppyoloe"]["launches"]}
    v = vis["vit"]
    shapes = {"flash_fwd_wgmma": v["timed"]["fwd"],
              "flash_bwd_dq_wgmma": v["timed"]["dq"],
              "flash_bwd_dkv_wgmma": v["timed"]["dkv"]}
    errs = {"flash_fwd_wgmma": v["b1_errs"]["bf16"],
            "flash_bwd_dq_wgmma": v["bwd_errs"]["dq_bf16"],
            "flash_bwd_dkv_wgmma": max(v["bwd_errs"]["dk_bf16"],
                                       v["bwd_errs"]["dv_bf16"])}
    for row in rows:
        name = row["name"]
        if name not in LAUNCH_ROWS:
            continue
        add = {k: LAUNCH_ROWS[name](c) for k, c in paths.items()
               if LAUNCH_ROWS[name](c)}
        row["launches"] += sum(add.values())
        row.setdefault("launches_by_path", {}).update(add)
        if name in shapes:
            row["vit_shapes"] = [shapes[name]]
        if name in errs:
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])


def vision_phase(torch, pt, amp, fa, pa, rpa, kern, smi):
    """Phase 12: ViT-B/16, PP-YOLOE, the conv zoo, the RNNs and the vision
    ops on the card."""
    t0 = time.perf_counter()
    vis = {}
    phase(" 12(a): ViT-B/16 (12 layers, 768 wide, 12 heads of 64, 197 "
          f"tokens): O2 steps at batch {VIT_BATCH}, O2 eval, B1-B3 on layer "
          f"0, {VIT_CPU_LAYERS} layers against the CPU")
    vis["vit"] = vit_phase(torch, pt, amp, fa, pa, rpa, kern, smi)
    phase(f" 12(b): PP-YOLOE at {PPYOLOE_SIZE} x {PPYOLOE_SIZE}, batch "
          f"{PPYOLOE_BATCH}, {PPYOLOE_WORKERS} DataLoader workers")
    vis["ppyoloe"] = ppyoloe_phase(torch, pt, kern, smi)
    phase(" 12(c): the conv zoo: fp32 against the CPU, O2 eval")
    vis["zoo"] = conv_zoo_phase(torch, pt, amp, kern, smi)
    phase(" 12(d): LSTM, GRU and SimpleRNN against the CPU")
    vis["rnn"] = rnn_phase(torch, pt)
    phase(" 12(e): the vision ops against the CPU")
    vis["ops"] = vision_ops_phase(torch, pt)
    vis["seconds"] = time.perf_counter() - t0
    log(f"  phase 12 took {vis['seconds']:.1f} s")
    return vis


# ---------------------------------------------------------------------------
# phase 13: Hugging Face checkpoints, the spectral features, the data
# pipeline and Viterbi decoding
# ---------------------------------------------------------------------------

#: 13(a): the HF checkpoints' depths. Llama-3-8B widths at 2 layers, bf16,
#: two shards with an index (~2.97 GB; the full 32 layers would be ~16 GB
#: to write and read inside the phase's time); GPT-2's layout at
#: GPT-3-1.3B widths at 2 layers; BERT-base and T5-v1.1-small whole
HF_LLAMA_LAYERS, HF_GPT_LAYERS = 2, 2
#: 13(a): BERT-base's eval batch without a mask (B1 non-causal at d 64)
HF_BERT_EVAL = (8, 512)
#: 13(b): a batch of clips of 10 s at 16 kHz, and the fft functions' input
AUDIO_CLIPS, AUDIO_SAMPLES, AUDIO_SR = 16, 160000, 16000
FFT_SHAPE = (64, 4096)
#: every spectral result against the CPU, of its largest magnitude
SIGNAL_TOL = 1e-5
#: 13(c): CIFAR-10 in the cache layout (five train batches of
#: CIFAR_PER_FILE images), PaddleClas's train transforms in
#: CIFAR_WORKERS workers, O2 steps of ResNet-18 at CIFAR_BATCH
CIFAR_PER_FILE, CIFAR_BATCH, CIFAR_WORKERS = 512, 256, 4
CIFAR_MEAN, CIFAR_STD = [125.31, 122.95, 113.87], [62.99, 62.09, 66.70]
#: 13(d): Viterbi potentials [batch, steps, tags], BOS/EOS transitions
VITERBI_SHAPE = (64, 128, 50)
#: phase 13's device (a rehearsal on the CPU sets "cpu")
DEV = "cuda"

_ST_CODES = {"torch.float32": "F32", "torch.bfloat16": "BF16",
             "torch.float16": "F16", "torch.int64": "I64"}


def write_safetensors(torch, tensors, path):
    """This script's own safetensors writer (the format, independent of
    the port's reader): the header's length as 8 little-endian bytes, the
    JSON header padded with spaces to 8 bytes, then each tensor's bytes in
    order, each copied to the host alone. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(
                torch.uint8).numpy().tobytes())
    return 8 + len(blob) + offset


def write_hf_dir(torch, path, config, tensors, shards=1):
    """An HF checkpoint directory: ``config.json`` and ``tensors`` in
    ``shards`` safetensors files (consecutive runs of names) with
    ``model.safetensors.index.json`` when more than one. Returns the bytes
    written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    names = list(tensors)
    per = -(-len(names) // shards)
    index, total = {}, 0
    for s in range(shards):
        part = names[s * per:(s + 1) * per]
        fname = (f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
                 if shards > 1 else "model.safetensors")
        total += write_safetensors(torch, {k: tensors[k] for k in part},
                                   os.path.join(path, fname))
        index.update({k: fname for k in part})
    if shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": index}, f)
    return total


class Draw:
    """Seeded draws on ``dev``: ``w(*shape)`` N(0, std), ``norm(n)``
    1 + N(0, 0.1) (weights unlike each other, so a transposed or swapped
    tensor shows), in ``dtype``."""

    def __init__(self, torch, dev, seed, dtype):
        self.torch, self.dev, self.dtype = torch, dev, dtype
        self.gen = torch.Generator(dev).manual_seed(seed)

    def w(self, *shape, std=0.02):
        return (self.torch.randn(shape, generator=self.gen, device=self.dev)
                * std).to(self.dtype)

    def norm(self, n):
        return (1.0 + 0.1 * self.torch.randn(
            n, generator=self.gen, device=self.dev)).to(self.dtype)

    def bias(self, n):
        return self.w(n, std=0.01)


def hf_llama(torch, cfg, dev, seed):
    """HF Llama tensors at ``cfg``'s widths in bf16, and the port's name
    of each (``model.`` -> ``llama.``; HF's ``[out, in]`` Linears are the
    port's layout)."""
    d = Draw(torch, dev, seed, torch.bfloat16)
    h, m = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    t = {"model.embed_tokens.weight": d.w(cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": d.w(h, h),
                  p + "self_attn.k_proj.weight": d.w(kv, h),
                  p + "self_attn.v_proj.weight": d.w(kv, h),
                  p + "self_attn.o_proj.weight": d.w(h, h),
                  p + "mlp.gate_proj.weight": d.w(m, h),
                  p + "mlp.up_proj.weight": d.w(m, h),
                  p + "mlp.down_proj.weight": d.w(h, m),
                  p + "input_layernorm.weight": d.norm(h),
                  p + "post_attention_layernorm.weight": d.norm(h)})
    t["model.norm.weight"] = d.norm(h)
    t["lm_head.weight"] = d.w(cfg.vocab_size, h)
    names = {k: ("llama." + k[len("model."):] if k.startswith("model.")
                 else k) for k in t}
    config = dict(architectures=["LlamaForCausalLM"], model_type="llama",
                  vocab_size=cfg.vocab_size, hidden_size=h,
                  intermediate_size=m,
                  num_hidden_layers=cfg.num_hidden_layers,
                  num_attention_heads=cfg.num_attention_heads,
                  num_key_value_heads=cfg.num_key_value_heads,
                  max_position_embeddings=cfg.max_position_embeddings,
                  rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                  tie_word_embeddings=False, torch_dtype="bfloat16")
    return t, {names[k]: (k, False) for k in t}, config


def hf_gpt2(torch, cfg, dev, seed):
    """HF GPT-2 tensors at ``cfg``'s widths (fp32; ``Conv1D`` weights
    ``[in, out]``) and the port's name of each with whether it is
    transposed into the port's ``[out, in]`` Linear."""
    d = Draw(torch, dev, seed, torch.float32)
    h, ff = cfg.hidden_size, cfg.intermediate_size
    t = {"transformer.wte.weight": d.w(cfg.vocab_size, h),
         "transformer.wpe.weight": d.w(cfg.max_position_embeddings, h)}
    port = {"transformer.wte.weight":
            ("gpt.embeddings.word_embeddings.weight", False),
            "transformer.wpe.weight":
            ("gpt.embeddings.position_embeddings.weight", False)}
    for i in range(cfg.num_hidden_layers):
        p, q = f"transformer.h.{i}.", f"gpt.decoder.{i}."
        for hf, ours, shape in (
                ("attn.c_attn", "self_attn.qkv_proj", (h, 3 * h)),
                ("attn.c_proj", "self_attn.out_proj", (h, h)),
                ("mlp.c_fc", "linear1", (h, ff)),
                ("mlp.c_proj", "linear2", (ff, h))):
            t[p + hf + ".weight"] = d.w(*shape)
            t[p + hf + ".bias"] = d.bias(shape[1])
            port[p + hf + ".weight"] = (q + ours + ".weight", True)
            port[p + hf + ".bias"] = (q + ours + ".bias", False)
        for hf, ours in (("ln_1", "norm1"), ("ln_2", "norm2")):
            t[p + hf + ".weight"] = d.norm(h)
            t[p + hf + ".bias"] = d.bias(h)
            port[p + hf + ".weight"] = (q + ours + ".weight", False)
            port[p + hf + ".bias"] = (q + ours + ".bias", False)
    t["transformer.ln_f.weight"] = d.norm(h)
    t["transformer.ln_f.bias"] = d.bias(h)
    port["transformer.ln_f.weight"] = ("gpt.final_norm.weight", False)
    port["transformer.ln_f.bias"] = ("gpt.final_norm.bias", False)
    config = dict(model_type="gpt2", n_embd=h, n_layer=cfg.num_hidden_layers,
                  n_head=cfg.num_attention_heads, vocab_size=cfg.vocab_size)
    return t, {v[0]: (k, v[1]) for k, v in port.items()}, config


def hf_bert(torch, cfg, dev, seed):
    """HF BERT tensors (fp32, with the pooler and ``position_ids``) and
    the port's name of each."""
    d = Draw(torch, dev, seed, torch.float32)
    h, ff = cfg.hidden_size, cfg.intermediate_size
    t, port = {}, {}

    def add(hf, ours, value):
        t[hf], port[ours] = value, (hf, False)
    for table, n in (("word_embeddings", cfg.vocab_size),
                     ("position_embeddings", cfg.max_position_embeddings),
                     ("token_type_embeddings", cfg.type_vocab_size)):
        add(f"bert.embeddings.{table}.weight", f"embeddings.{table}.weight",
            d.w(n, h))
    add("bert.embeddings.LayerNorm.weight", "embeddings.layer_norm.weight",
        d.norm(h))
    add("bert.embeddings.LayerNorm.bias", "embeddings.layer_norm.bias",
        d.bias(h))
    t["bert.embeddings.position_ids"] = torch.arange(
        cfg.max_position_embeddings, device=dev)[None]
    for i in range(cfg.num_hidden_layers):
        p, q = f"bert.encoder.layer.{i}.", f"encoder.layers.{i}."
        for hf, ours, shape in (
                ("attention.self.query", "self_attn.q_proj", (h, h)),
                ("attention.self.key", "self_attn.k_proj", (h, h)),
                ("attention.self.value", "self_attn.v_proj", (h, h)),
                ("attention.output.dense", "self_attn.out_proj", (h, h)),
                ("intermediate.dense", "linear1", (ff, h)),
                ("output.dense", "linear2", (h, ff))):
            add(p + hf + ".weight", q + ours + ".weight", d.w(*shape))
            add(p + hf + ".bias", q + ours + ".bias", d.bias(shape[0]))
        for hf, ours in (("attention.output.LayerNorm", "norm1"),
                         ("output.LayerNorm", "norm2")):
            add(p + hf + ".weight", q + ours + ".weight", d.norm(h))
            add(p + hf + ".bias", q + ours + ".bias", d.bias(h))
    add("bert.pooler.dense.weight", "pooler.dense.weight", d.w(h, h))
    add("bert.pooler.dense.bias", "pooler.dense.bias", d.bias(h))
    config = dict(model_type="bert", vocab_size=cfg.vocab_size,
                  hidden_size=h, num_hidden_layers=cfg.num_hidden_layers,
                  num_attention_heads=cfg.num_attention_heads,
                  intermediate_size=ff,
                  max_position_embeddings=cfg.max_position_embeddings,
                  type_vocab_size=cfg.type_vocab_size,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return t, port, config


def hf_t5(torch, cfg, dev, seed):
    """HF T5 v1.1 tensors (fp32, gated-GeLU, untied head; the stacks'
    ``embed_tokens`` copies of ``shared``) and the port's name of each."""
    d = Draw(torch, dev, seed, torch.float32)
    dm, inner, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    t, port = {}, {}

    def add(hf, ours, value):
        t[hf] = value
        if ours is not None:
            port[ours] = (hf, False)
    add("shared.weight", "shared.weight", d.w(cfg.vocab_size, dm, std=1.0))
    add("encoder.embed_tokens.weight", None, t["shared.weight"])
    add("decoder.embed_tokens.weight", None, t["shared.weight"])
    for stack, n in (("encoder", cfg.num_layers),
                     ("decoder", cfg.num_decoder_layers)):
        for i in range(n):
            p, q = f"{stack}.block.{i}.layer.", f"{stack}.blocks.{i}."
            subs = [("0.SelfAttention", "self_attn", "0", "norm1")]
            if stack == "decoder":
                subs.append(("1.EncDecAttention", "cross_attn", "1",
                             "norm_cross"))
            for hf, ours, k, norm in subs:
                for x in "qkv":
                    add(f"{p}{hf}.{x}.weight", f"{q}{ours}.{x}.weight",
                        d.w(inner, dm, std=dm ** -0.5))
                add(f"{p}{hf}.o.weight", f"{q}{ours}.o.weight",
                    d.w(dm, inner, std=inner ** -0.5))
                add(f"{p}{k}.layer_norm.weight", f"{q}{norm}.weight",
                    d.norm(dm))
            if i == 0:
                add(f"{p}0.SelfAttention.relative_attention_bias.weight",
                    f"{q}self_attn.relative_attention_bias.weight",
                    d.w(cfg.relative_attention_num_buckets, cfg.num_heads,
                        std=0.5))
            k = "2" if stack == "decoder" else "1"
            for hf, ours, shape in (("wi_0", "wi", (ff, dm)),
                                    ("wi_1", "wi_1", (ff, dm)),
                                    ("wo", "wo", (dm, ff))):
                add(f"{p}{k}.DenseReluDense.{hf}.weight",
                    f"{q}ff.{ours}.weight", d.w(*shape, std=shape[1] ** -0.5))
            add(f"{p}{k}.layer_norm.weight", f"{q}norm2.weight", d.norm(dm))
        add(f"{stack}.final_layer_norm.weight", f"{stack}.final_norm.weight",
            d.norm(dm))
    add("lm_head.weight", "lm_head.weight", d.w(cfg.vocab_size, dm,
                                                std=dm ** -0.5))
    config = dict(model_type="t5", vocab_size=cfg.vocab_size, d_model=dm,
                  d_kv=cfg.d_kv, d_ff=ff, num_layers=cfg.num_layers,
                  num_decoder_layers=cfg.num_decoder_layers,
                  num_heads=cfg.num_heads, feed_forward_proj="gated-gelu",
                  tie_word_embeddings=False, dropout_rate=0.0)
    return t, port, config


def fill_direct(torch, model, tensors, port):
    """Set ``model``'s every parameter straight from the checkpoint's
    tensors by the script's own name table (``port``: the port's name ->
    (HF name, transposed)); every parameter must be named."""
    own = model.state_dict()
    if sorted(own) != sorted(port):
        raise AssertionError(f"direct fill: names differ "
                             f"{sorted(set(own) ^ set(port))[:8]}")
    with torch.no_grad():
        for name, dst in own.items():
            hf, flip = port[name]
            src = tensors[hf]
            dst.copy_(src.T if flip else src)
    return model


def same_params(torch, a, b, label):
    """The loaded model's parameters are the directly set model's, bit
    for bit."""
    sa, sb = a.state_dict(), b.state_dict()
    bad = [k for k in sa if sa[k].dtype != sb[k].dtype
           or not torch.equal(sa[k], sb[k])]
    if sorted(sa) != sorted(sb) or bad:
        raise AssertionError(f"{label}: parameters differ: {bad[:8]}")
    log(f"  {label}: all {len(sa)} tensors equal to the direct fill")


def same_bits(torch, label, got, want):
    if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        ok = np.array_equal(np.asarray(got), np.asarray(want))
    else:
        ok = got.dtype == want.dtype and torch.equal(got, want)
    if not ok:
        raise AssertionError(f"{label}: the loaded model's result differs "
                             f"from the directly filled model's")
    log(f"  {label}: equal bit for bit")


def hf_load(torch, load, nbytes, smi, label):
    """``load()`` timed to a device sync; logs the rate."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    log(f"  {label}: {nbytes / 1e9:.3f} GB loaded in {s:.3f} s, "
        f"{nbytes / 1e9 / s:.3f} GB/s (the files just written: a warm "
        f"read; {smi})")
    return model, {"bytes": nbytes, "seconds": s, "gb_per_s":
                   nbytes / 1e9 / s}


def hf_llama_phase(torch, pt, amp, fa, pa, rpa, gen, nn_functional, kern,
                   tmp, smi):
    """13(a) Llama: the bf16 two-shard checkpoint through
    ``LlamaForCausalLM.from_pretrained(dtype="bfloat16")`` against the
    model set directly from the same tensors: parameters, O2 logits,
    O2 ``generate`` on the paged cache (B1 ``bfloat16 d128 g4 causal``,
    kernel 4 ``<bf16, float>``) and the O2 q-block engine with CUDA
    graphs (kernel 6 ``<bf16, float>``), each bit for bit; layer 0's
    captured inputs of the loaded model hold B1, B4 and kernel 6 to their
    plain versions and are timed."""
    cfg = pt.llama3_8b()
    cfg.num_hidden_layers = n_layers = HF_LLAMA_LAYERS
    res = {"launches": {}, "by_variant": {}}
    tensors, port, config = hf_llama(torch, cfg, DEV, seed=131)
    path = os.path.join(tmp, "llama")
    t0 = time.perf_counter()
    nbytes = write_hf_dir(torch, path, config, tensors, shards=2)
    log(f"  Llama-3-8B widths, {n_layers} layers: {nbytes / 1e9:.3f} GB "
        f"written in two shards in {time.perf_counter() - t0:.1f} s")
    loaded, res["load"] = hf_load(
        torch, lambda: pt.LlamaForCausalLM.from_pretrained(
            path, dtype="bfloat16", device=DEV), nbytes, smi,
        "from_pretrained (2 shards, bf16)")
    prompts, warm, batch = zoo_prompts(cfg.vocab_size)
    loaded.eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        first = loaded.generate(torch.as_tensor(batch[:1], device=DEV),
                                max_new_tokens=1)
    torch.cuda.synchronize()
    res["first_token_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  first token after the load (fp32, a 256-token prompt, dense "
        f"cache): {res['first_token_ms']:.2f} ms ({smi})")
    if first.shape != (1, 257):
        raise AssertionError(f"first token: shape {tuple(first.shape)}")
    direct = fill_direct(torch, pt.LlamaForCausalLM(cfg, device=DEV,
                                                    seed=5),
                         tensors, port)
    direct.eval()
    del tensors
    same_params(torch, loaded, direct, "Llama from_pretrained")
    for m in (loaded, direct):
        amp.decorate(m, level="O2", dtype="bfloat16")
    ids = torch.as_tensor(batch, device=DEV)
    with torch.inference_mode(), amp.auto_cast(**AMP_O2):
        logits = [m(ids) for m in (loaded, direct)]
    same_bits(torch, "Llama O2 logits (4 x 256)", *logits)
    del logits
    dec_cap = decode_capture(gen, n_layers)
    flash_cap = flash_capture(nn_functional, n_layers)
    gens = []
    for m, probes in ((loaded, (dec_cap, flash_cap)), (direct, ())):
        out, st = zoo_generate(torch, amp, kern, fa, pa, rpa, m, batch,
                               True, probes)
        check_variants("Llama O2 generate (paged)", st["by_variant"], {
            "flash": {"bfloat16 d128 g4 causal": n_layers},
            "paged": {"bfloat16/float32": n_layers * (NEW_TOKENS - 1)}})
        gens.append(out)
        res["launches"].setdefault("13a Llama O2 generate paged", st[
            "launches"])
    same_bits(torch, "Llama O2 generate stream (paged)", *gens)
    runs = []
    with amp.auto_cast(**AMP_O2):
        for m in (loaded, direct):
            outs, st = serve_bf16(torch, pt, kern, fa, pa, rpa, m, prompts,
                                  warm, "qblock", n_layers,
                                  "bfloat16/float32")
            if st["pool_dtypes"] != ["torch.float32"]:
                raise AssertionError(f"Llama O2 engine: pools "
                                     f"{st['pool_dtypes']}")
            runs.append(outs)
            res["launches"].setdefault("13a Llama O2 qblock engine",
                                       st["launches"])
            res.setdefault("engine_tokens_per_s", serving_rate(st, prompts))
        probe = TickProbe(torch, gen, loaded, n_layers)
        serve(torch, pt, kern, loaded, prompts, warm, impl="qblock",
              probes=[probe])
    for i, (a, b) in enumerate(zip(*runs)):
        same_bits(torch, f"Llama O2 q-block engine stream {i}", a, b)
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    fc = flash_cap.best
    res["b1_errs"] = compare_flash_case(
        torch, fa, *(fc[k].transpose(1, 2) for k in ("q", "k", "v")), True,
        0, 0, "loaded Llama O2 prefill, layer 0")
    dc = dec_cap.best
    res["b4_errs"] = compare_paged(torch, pa, dc["q"], dc["kp"], dc["vp"],
                                   dc["tables"], dc["ctx"],
                                   "loaded Llama O2 paged decode, layer 0")
    res["ragged_errs"] = {}
    for name, cap in (("mixed", probe.best), ("decode", probe.decode)):
        res["ragged_errs"][name], _ = compare_kernels(
            torch, rpa, cap["q"], cap["kp"], cap["vp"], cap["tbl"],
            cap["desc"], f"loaded Llama O2 {name} tick, layer 0")
    res["timed"] = {
        "flash_prefill": zoo_time_flash(torch, fa, fc,
                                        "loaded Llama O2 generate prefill"),
        "paged": zoo_time_paged(torch, pa, dc,
                                "loaded Llama O2 decode step"),
        **{f"ragged_{name}": zoo_time_ragged(
            torch, rpa, cap, f"loaded Llama O2 {name} tick")
           for name, cap in (("mixed", probe.best),
                             ("decode", probe.decode))}}
    del probe, dec_cap, flash_cap, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return res


def hf_zoo_phase(torch, pt, amp, fa, pa, rpa, kern, tmp, smi):
    """13(a) GPT-2's layout at GPT-3-1.3B widths (2 layers), BERT-base and
    T5-v1.1-small: each checkpoint through its loader against the model
    set directly from the same tensors: parameters, fp32 outputs and a
    greedy stream (GPT under O2 on bf16 pages: B1 and kernel 4
    ``<bf16, bf16>``; BERT's eval at 8 x 512: B1 fp32 d 64), bit for bit."""
    from paddle_tpu_torch.models import bert as bert_mod
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.models import pretrained
    from paddle_tpu_torch.models import t5 as t5_mod
    res = {"launches": {}}
    rng = np.random.RandomState(137)
    # GPT-2 layout at GPT-3-1.3B widths
    cfg = gpt_mod.gpt3_1p3b(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    cfg.num_hidden_layers = HF_GPT_LAYERS
    tensors, port, config = hf_gpt2(torch, cfg, DEV, seed=132)
    path = os.path.join(tmp, "gpt2")
    nbytes = write_hf_dir(torch, path, config, tensors)
    loaded, res["gpt_load"] = hf_load(
        torch, lambda: pretrained.load_gpt_from_hf(
            gpt_mod.GPTForCausalLM(cfg, device=DEV), path), nbytes, smi,
        "load_gpt_from_hf (GPT-2 layout, GPT-3-1.3B widths, fp32)")
    direct = fill_direct(torch, gpt_mod.GPTForCausalLM(cfg, device=DEV,
                                                       seed=5),
                         tensors, port)
    del tensors
    same_params(torch, loaded, direct, "GPT-2 layout")
    batch = rng.randint(0, cfg.vocab_size, (4, 256))
    ids = torch.as_tensor(batch, device=DEV)
    for m in (loaded, direct):
        m.eval()
    with torch.inference_mode():
        same_bits(torch, "GPT fp32 logits (4 x 256)", loaded(ids),
                  direct(ids))
    gens = []
    for m in (loaded, direct):
        amp.decorate(m, level="O2", dtype="bfloat16")
        out, st = zoo_generate(torch, amp, kern, fa, pa, rpa, m, batch, True)
        check_variants("GPT O2 generate (paged)", st["by_variant"], {
            "flash": {"bfloat16 d128 g1 causal": cfg.num_hidden_layers},
            "paged": {"bfloat16/bfloat16": cfg.num_hidden_layers
                      * (NEW_TOKENS - 1)}})
        gens.append(out)
        res["launches"].setdefault("13a GPT O2 generate paged",
                                   st["launches"])
    same_bits(torch, "GPT O2 generate stream (paged)", *gens)
    del loaded, direct
    gc.collect()
    torch.cuda.empty_cache()
    # BERT-base, all 12 layers
    cfg = bert_mod.bert_base(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    tensors, port, config = hf_bert(torch, cfg, DEV, seed=133)
    path = os.path.join(tmp, "bert")
    nbytes = write_hf_dir(torch, path, config, tensors)
    bcfg = pretrained.bert_config_from_hf(path)
    loaded, res["bert_load"] = hf_load(
        torch, lambda: pretrained.load_bert_from_hf(
            bert_mod.BertModel(bcfg, device=DEV), path), nbytes, smi,
        "load_bert_from_hf (BERT-base, fp32)")
    direct = fill_direct(torch, bert_mod.BertModel(cfg, device=DEV,
                                                   seed=5), tensors, port)
    del tensors
    same_params(torch, loaded, direct, "BERT-base")
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, HF_BERT_EVAL),
                          device=DEV)
    outs = []
    for m in (loaded, direct):
        m.eval()
        zero_counts(kern)
        with torch.inference_mode():
            outs.append(m(ids))
        check_variants("BERT-base fp32 eval (8 x 512)",
                       by_variant(fa, pa, rpa),
                       {"flash": {"float32 d64 g1 full":
                                  cfg.num_hidden_layers}})
        res["launches"].setdefault("13a BERT-base fp32 eval",
                                   read_counts(kern))
    same_bits(torch, "BERT-base sequence output", outs[0][0], outs[1][0])
    same_bits(torch, "BERT-base pooled output", outs[0][1], outs[1][1])
    del loaded, direct, outs
    gc.collect()
    torch.cuda.empty_cache()
    # T5-v1.1-small: gated GeLU, untied head
    cfg = t5_mod.T5Config(vocab_size=32128, d_model=512, d_kv=64, d_ff=1024,
                          num_layers=8, num_decoder_layers=8, num_heads=6,
                          feed_forward_proj="gated-gelu",
                          tie_word_embeddings=False, dropout_rate=0.0)
    tensors, port, config = hf_t5(torch, cfg, DEV, seed=134)
    path = os.path.join(tmp, "t5")
    nbytes = write_hf_dir(torch, path, config, tensors)
    loaded, res["t5_load"] = hf_load(
        torch, lambda: t5_mod.T5ForConditionalGeneration.from_pretrained(
            path, device=DEV), nbytes, smi,
        "T5ForConditionalGeneration.from_pretrained (v1.1 small, fp32)")
    direct = fill_direct(torch, t5_mod.T5ForConditionalGeneration(
        cfg, device=DEV, seed=5), tensors, port)
    del tensors
    same_params(torch, loaded, direct, "T5-v1.1-small")
    src = torch.as_tensor(rng.randint(2, cfg.vocab_size, (4, 64)),
                          device=DEV)
    dec = torch.as_tensor(rng.randint(2, cfg.vocab_size, (4, 16)),
                          device=DEV)
    for m in (loaded, direct):
        m.eval()
    with torch.inference_mode():
        same_bits(torch, "T5 fp32 logits", loaded(src, decoder_input_ids=dec),
                  direct(src, decoder_input_ids=dec))
    same_bits(torch, "T5 greedy generate stream",
              loaded.generate(src, max_new_tokens=NEW_TOKENS),
              direct.generate(src, max_new_tokens=NEW_TOKENS))
    del loaded, direct
    gc.collect()
    torch.cuda.empty_cache()
    return res


def signal_phase(torch, pt, smi):
    """13(b): the audio features on AUDIO_CLIPS clips of 10 s at 16 kHz,
    an ``stft`` -> ``istft`` round trip and the 22 ``fft`` functions on
    FFT_SHAPE real and complex inputs, each against the CPU within
    SIGNAL_TOL of its largest magnitude (fp32, TF32 off) and timed."""
    from paddle_tpu_torch import audio, fft, signal
    gen = torch.Generator(DEV).manual_seed(141)
    clips = 0.1 * torch.randn(AUDIO_CLIPS, AUDIO_SAMPLES, device=DEV,
                              generator=gen)
    clips_cpu = clips.cpu()
    res = {}

    def held(name, fn, args, args_cpu, iters=10):
        got, want = fn(*args), fn(*args_cpu)
        err = rel_to_max(torch, torch.view_as_real(got) if got.is_complex()
                         else got, torch.view_as_real(want)
                         if want.is_complex() else want)
        check(f"{name} card vs CPU (of the largest)", err, SIGNAL_TOL)
        ms = time_ms(torch, lambda: fn(*args), iters=iters, warmup=2)
        res[name] = {"max_rel_err": err, "ms": ms,
                     "shape": list(got.shape)}
        log(f"  {name}: {ms:.4f} ms on the card ({smi})")
        return got

    feats = {"Spectrogram": audio.Spectrogram(n_fft=512, hop_length=160),
             "MelSpectrogram": audio.MelSpectrogram(
                 sr=AUDIO_SR, n_fft=512, hop_length=160, n_mels=80),
             "LogMelSpectrogram": audio.LogMelSpectrogram(
                 sr=AUDIO_SR, n_fft=512, hop_length=160, n_mels=80),
             "MFCC": audio.MFCC(sr=AUDIO_SR, n_mfcc=40, n_mels=80,
                                n_fft=512, hop_length=160)}
    for name, f in feats.items():
        held(f"{name} [{AUDIO_CLIPS}, {AUDIO_SAMPLES}]", f, (clips,),
             (clips_cpu,))
    win = torch.from_numpy(np.hanning(512).astype(np.float32))
    wins = (win.to(DEV), win)
    sp = held("stft n_fft 512 hop 160", lambda x, w: signal.stft(
        x, 512, 160, window=w), (clips, wins[0]), (clips_cpu, wins[1]))
    back = held("istft n_fft 512 hop 160", lambda s, w: signal.istft(
        s, 512, 160, window=w, length=AUDIO_SAMPLES),
        (sp, wins[0]), (sp.cpu(), wins[1]))
    res["round_trip_rel_err"] = rel_to_max(torch, back, clips)
    check("stft -> istft round trip (of the largest sample)",
          res["round_trip_rel_err"], SIGNAL_TOL)
    del sp, back
    real = torch.randn(FFT_SHAPE, device=DEV, generator=gen)
    cplx = torch.complex(torch.randn(FFT_SHAPE, device=DEV,
                                     generator=gen),
                         torch.randn(FFT_SHAPE, device=DEV,
                                     generator=gen))
    takes_complex = {"fft", "ifft", "irfft", "hfft", "fft2", "ifft2",
                     "irfft2", "hfft2", "fftn", "ifftn", "irfftn", "hfftn"}
    for name in fft.__all__:
        if name in ("fftfreq", "rfftfreq"):
            n = FFT_SHAPE[1]
            got = getattr(fft, name)(n, 0.5)
            prev = pt.get_device()
            pt.set_device("cpu")
            try:
                want = getattr(fft, name)(n, 0.5)
            finally:
                pt.set_device(prev)
            if got.device.type != torch.device(DEV).type:
                raise AssertionError(f"{name}: on {got.device}")
            check(f"fft.{name} card vs CPU (of the largest)",
                  rel_to_max(torch, got, want), SIGNAL_TOL)
            continue
        x = cplx if name in takes_complex else real
        held(f"fft.{name} {list(FFT_SHAPE)}"
             f" {'complex' if x.is_complex() else 'real'}",
             getattr(fft, name), (x,), (x.cpu(),))
    return res


class CifarTrain:
    """13(c)'s loop: ResNet-18 (10 classes) under O2 with Momentum on
    ``DataLoader`` batches; keeps the first batch and each step's host
    time to a device sync."""

    def __init__(self, torch, pt, amp):
        self.torch = torch
        pt.seed(151)
        self.model = pt.vision.models.resnet18(num_classes=10)
        opt = pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=self.model.parameters(),
                                    weight_decay=pt.optimizer.L2Decay(5e-4))
        self.model, self.opt = amp.decorate(self.model, opt, level="O2",
                                            dtype="bfloat16")
        self.amp, self.loss_fn = amp, pt.nn.CrossEntropyLoss()
        self.model.train()

    def run(self, loader):
        torch = self.torch
        first, losses, step_s = None, [], []
        for x, y in loader:
            if first is None:
                first = (x.cpu(), y.cpu())
            t0 = time.perf_counter()
            with self.amp.auto_cast(**AMP_O2):
                loss = self.loss_fn(self.model(x), y)
            loss.backward()
            self.opt.step()
            self.opt.clear_grad()
            losses.append(float(loss.detach()))
            step_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return first, losses, step_s


def cifar_phase(torch, pt, amp, tmp, smi):
    """13(c): a CIFAR-10 tarball in the cache layout (the pickled-batch
    format, pixels from a seed), read by ``vision.datasets.Cifar10`` with
    PaddleClas's CIFAR train transforms (``RandomCrop(32, padding=4)``,
    ``RandomHorizontalFlip``, ``Normalize``, ``Transpose``) in
    CIFAR_WORKERS ``DataLoader`` workers, into O2 steps of ResNet-18 at
    CIFAR_BATCH: images/s and the loop's wait per batch; the first batch
    the workers sent equal to a CPU loader's under the same seed."""
    import io as _io
    import pickle
    import tarfile
    from paddle_tpu_torch.vision import datasets, transforms as T
    rng = np.random.default_rng(152)
    path = os.path.join(tmp, "cifar", "cifar-10-python.tar.gz")
    os.makedirs(os.path.dirname(path))
    with tarfile.open(path, "w:gz", compresslevel=1) as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + [
                "test_batch"]:
            blob = pickle.dumps({
                b"batch_label": name.encode(),
                b"labels": rng.integers(0, 10, CIFAR_PER_FILE).tolist(),
                b"data": rng.integers(0, 256, (CIFAR_PER_FILE, 3072),
                                      dtype=np.uint8),
                b"filenames": [b"%d.png" % i
                               for i in range(CIFAR_PER_FILE)]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, _io.BytesIO(blob))
    ds = datasets.Cifar10(data_file=path, mode="train", transform=T.Compose([
        T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(),
        T.Normalize(CIFAR_MEAN, CIFAR_STD, data_format="HWC"),
        T.Transpose()]))

    def loader(places=None):
        return pt.io.DataLoader(ds, places=places, batch_size=CIFAR_BATCH,
                                shuffle=True, drop_last=True,
                                num_workers=CIFAR_WORKERS)
    trainer = CifarTrain(torch, pt, amp)
    np.random.seed(153)
    warm = loader()
    trainer.run(warm)                   # cuDNN's and the loader's first use
    np.random.seed(154)
    timed = loader()
    t0 = time.perf_counter()
    first, losses, step_s = trainer.run(timed)
    wall = time.perf_counter() - t0
    np.random.seed(154)
    cpu = loader(places="cpu")
    cpu_first = next(iter(cpu))
    for _ in cpu:
        pass
    for a, b, what in ((first[0], cpu_first[0], "images"),
                       (first[1], cpu_first[1], "labels")):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"CIFAR-10: the workers' first batch's "
                                 f"{what} differ from the CPU loader's")
    log("  CIFAR-10: the first batch off the card's loader equals the CPU "
        "loader's under the same seed (images and labels)")
    steps = len(losses)
    if steps != 5 * CIFAR_PER_FILE // CIFAR_BATCH or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"CIFAR-10 steps: {steps}, losses {losses}")
    res = {"steps": steps, "losses": losses, "wall_s": wall,
           "images_per_s": steps * CIFAR_BATCH / wall,
           "step_ms": [s * 1e3 for s in step_s],
           "loader": dict(timed.stats)}
    res["wait_ms_per_batch"] = (res["loader"]["wait_s"]
                                / max(res["loader"]["batches"], 1) * 1e3)
    log(f"  ResNet-18 O2 at batch {CIFAR_BATCH} on CIFAR-10 through "
        f"{CIFAR_WORKERS} workers ({smi}): {steps} steps, losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; {res['images_per_s']:.1f} images/s, the loop's wait "
        f"{res['wait_ms_per_batch']:.2f} ms a batch (max "
        f"{res['loader']['max_wait_s'] * 1e3:.2f} ms), median step "
        f"{float(np.median(res['step_ms'])):.2f} ms of host time")
    return res


def viterbi_phase(torch, smi):
    """13(d): ``viterbi_decode`` at VITERBI_SHAPE with BOS/EOS and lengths
    16-128 on the card: paths equal to the CPU's, scores within 1e-5 of
    their largest magnitude; timed."""
    from paddle_tpu_torch import text
    b, t, n = VITERBI_SHAPE
    gen = torch.Generator(DEV).manual_seed(161)
    emis = torch.randn(VITERBI_SHAPE, device=DEV, generator=gen)
    trans = torch.randn(n + 2, n + 2, device=DEV, generator=gen)
    lens = torch.as_tensor(np.random.RandomState(162).randint(16, t + 1, b),
                           device=DEV)
    score, path = text.viterbi_decode(emis, trans, lens)
    cscore, cpath = text.viterbi_decode(emis.cpu(), trans.cpu(), lens.cpu())
    if path.dtype != torch.int64 or not torch.equal(path.cpu(), cpath):
        raise AssertionError("viterbi_decode: the card's paths differ from "
                             "the CPU's")
    err = rel_to_max(torch, score, cscore)
    check("viterbi_decode scores card vs CPU (of the largest)", err, 1e-5)
    ms = time_ms(torch, lambda: text.viterbi_decode(emis, trans, lens),
                 iters=10, warmup=2)
    log(f"  viterbi_decode {list(VITERBI_SHAPE)} with BOS/EOS: paths equal "
        f"the CPU's; {ms:.3f} ms ({smi})")
    return {"max_rel_err": err, "ms": ms}


def pretrained_phase(torch, pt, amp, fa, pa, rpa, gen, nn_functional, kern,
                     smi):
    """Phase 13: HF checkpoints loaded and served, the spectral features,
    the data pipeline and Viterbi decoding on the card."""
    import tempfile
    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="hf_ckpt_") as tmp:
        phase(f" 13(a): HF checkpoints: Llama-3-8B widths at "
              f"{HF_LLAMA_LAYERS} layers (bf16, two shards) through "
              f"from_pretrained, served under O2; GPT-2's layout at "
              f"GPT-3-1.3B widths ({HF_GPT_LAYERS} layers), BERT-base, "
              f"T5-v1.1-small")
        res["llama"] = hf_llama_phase(torch, pt, amp, fa, pa, rpa, gen,
                                      nn_functional, kern, tmp, smi)
        res["zoo"] = hf_zoo_phase(torch, pt, amp, fa, pa, rpa, kern, tmp,
                                  smi)
        phase(f" 13(b): audio features on {AUDIO_CLIPS} clips of 10 s at "
              f"16 kHz, stft/istft, the 22 fft functions on "
              f"{list(FFT_SHAPE)}")
        res["signal"] = signal_phase(torch, pt, smi)
        phase(f" 13(c): CIFAR-10 through Cifar10 + transforms in "
              f"{CIFAR_WORKERS} workers into ResNet-18 O2 steps")
        res["cifar"] = cifar_phase(torch, pt, amp, tmp, smi)
    phase(f" 13(d): viterbi_decode at {list(VITERBI_SHAPE)}")
    res["viterbi"] = viterbi_phase(torch, smi)
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 13 took {res['seconds']:.1f} s")
    return res


def add_pretrained_launches(rows, p13):
    """Phase 13's launches into the kernel rows by path, the loaded
    Llama's timed shapes under ``pretrained_shapes`` and its layer-0
    errors."""
    ll = p13["llama"]
    paths = {**ll["launches"], **p13["zoo"]["launches"]}
    t = ll["timed"]
    shapes = {"flash_fwd_wgmma": [t["flash_prefill"]],
              "paged_decode_mixed": [t["paged"]],
              "ragged_qblock_mixed": [t["ragged_mixed"]["qblock"],
                                      t["ragged_decode"]["qblock"]]}
    errs = {"flash_fwd_wgmma": ll["b1_errs"]["bf16"],
            "flash_fwd_simt": ll["b1_errs"]["fp32"]}
    add_path_launches(rows, paths, shapes, errs, "pretrained_shapes")


# ---------------------------------------------------------------------------
# phase 14: geometric, sparse and distribution on the card

#: 14(a): OGB ogbn-arxiv's published sizes (169,343 nodes, 1,166,243
#: citation edges, 128 features, 40 classes) and OGB's GCN baseline (3
#: layers, hidden 256, dropout 0.5); the edges are drawn from a seed with
#: a skewed (power-law) degree distribution, self loops added
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATS, ARXIV_CLASSES = (169343, 1166243,
                                                        128, 40)
GCN_HIDDEN, GCN_DROPOUT, GCN_STEPS = 256, 0.5, 3
#: the power law of a node's weight when an edge end is drawn
GRAPH_SKEW = 0.8
#: 14(b): BigBird-base's pattern (ITC): blocks of 64, 3 sliding, 2
#: global, 3 random blocks a row, 12 heads of 64; timed at 4096 tokens,
#: held against the CPU at 1024
BIGBIRD_BLOCK, BIGBIRD_GLOBAL, BIGBIRD_RANDOM = 64, 2, 3
BIGBIRD_HEADS, BIGBIRD_HEAD_DIM = 12, 64
BIGBIRD_TOKENS, BIGBIRD_CHECK_TOKENS = 4096, 1024
#: 14(c): SECOND's first sparse block on KITTI's voxel grid (z, y, x):
#: 4 input features to 16 channels, kernel 3, 16,000 non-empty voxels
#: (SECOND's training max_voxels); held against the CPU on a grid of the
#: same depth with the same occupancy
SECOND_GRID, SECOND_CHECK_GRID = (41, 1600, 1408), (41, 200, 176)
SECOND_VOXELS, SECOND_IN, SECOND_OUT = 16000, 4, 16
#: 14(d): Llama-3's vocabulary at batch 64; a 256-dim MultivariateNormal
#: at batch 1024; the gamma-based samplers at 4096 x 64; a SAC policy
#: head over 6 actions at batch 256; the KL pairs at batch 4096
CAT_VOCAB, CAT_BATCH = 128256, 64
MVN_DIM, MVN_BATCH = 256, 1024
GAMMA_SHAPE = (4096, 64)
SAC_BATCH, SAC_ACTIONS = 256, 6
KL_BATCH = 4096
#: sample moments: a mean within MOMENT_SIGMAS standard errors
MOMENT_SIGMAS = 5.0


def arxiv_graph(np_rng):
    """src, dst (int64 numpy) of ARXIV_EDGES edges whose ends are drawn
    with weights rank^-GRAPH_SKEW over a shuffled node order, then the
    self loops."""
    w = np.arange(1, ARXIV_NODES + 1, dtype=np.float64) ** -GRAPH_SKEW
    w /= w.sum()
    order = np_rng.permutation(ARXIV_NODES)
    src = order[np_rng.choice(ARXIV_NODES, ARXIV_EDGES, p=w)]
    dst = order[np_rng.choice(ARXIV_NODES, ARXIV_EDGES, p=w)]
    loops = np.arange(ARXIV_NODES)
    return (np.concatenate([src, loops]).astype(np.int64),
            np.concatenate([dst, loops]).astype(np.int64))


class GcnGraph:
    """The graph on one device with GCN's symmetric normalisation
    ``deg^-1/2[src] deg^-1/2[dst]`` (in-degrees, self loops counted),
    aggregated by ``route``: ``"geometric"`` (``send_ue_recv`` mul / sum)
    or ``"sparse"`` (``sparse.matmul`` on the CSR adjacency)."""

    def __init__(self, torch, src, dst, n, device, dtype):
        from paddle_tpu_torch import geometric, sparse
        self.geometric, self.sparse = geometric, sparse
        self.n = n
        self.src = torch.as_tensor(src, device=device)
        self.dst = torch.as_tensor(dst, device=device)
        deg = torch.zeros(n, dtype=dtype, device=device).index_add_(
            0, self.dst, torch.ones(len(dst), dtype=dtype, device=device))
        dinv = deg.clamp_min(1).rsqrt()
        self.norm = dinv[self.src] * dinv[self.dst]
        self.adj = sparse.sparse_coo_tensor(
            torch.stack([self.dst, self.src]), self.norm,
            [n, n]).to_sparse_csr()
        self.route = "geometric"

    def aggregate(self, h):
        if self.route == "geometric":
            return self.geometric.send_ue_recv(
                h, self.norm[:, None], self.src, self.dst, "mul", "sum",
                out_size=self.n)
        return self.sparse.matmul(self.adj, h)


def gcn_model(pt):
    """OGB's GCN baseline on the port's layers: (Linear -> aggregate ->
    BatchNorm -> ReLU -> dropout) x 2, then Linear -> aggregate."""
    nn = pt.nn

    class GCN(nn.Layer):
        def __init__(self):
            super().__init__()
            dims = [ARXIV_FEATS, GCN_HIDDEN, GCN_HIDDEN, ARXIV_CLASSES]
            self.lins = nn.LayerList([nn.Linear(a, b) for a, b in
                                      zip(dims[:-1], dims[1:])])
            self.bns = nn.LayerList([nn.BatchNorm1D(GCN_HIDDEN)
                                     for _ in range(2)])
            self.dropout = GCN_DROPOUT

        def forward(self, x, graph):
            for i, lin in enumerate(self.lins):
                x = graph.aggregate(lin(x))
                if i < len(self.bns):
                    x = nn.functional.relu(self.bns[i](x))
                    x = nn.functional.dropout(x, self.dropout,
                                              training=self.training)
            return x
    return GCN()


def gcn_grads(torch, pt, model, x, labels, train, graph):
    """Eval logits and one training step's loss and gradients (dropout
    off, BatchNorm on batch statistics)."""
    model.eval()
    with torch.no_grad():
        logits = model(x, graph)
    model.train()
    model.dropout = 0.0
    for p in model.parameters():
        p.grad = None
    loss = pt.nn.functional.cross_entropy(model(x, graph)[train],
                                          labels[train])
    loss.backward()
    model.dropout = GCN_DROPOUT
    out = {"logits": logits, "loss": loss.detach()}
    out.update({f"grad {n}": p.grad.detach().clone()
                for n, p in model.named_parameters()})
    return out


def gcn_phase(torch, pt, smi):
    """14(a): OGB's GCN on an ogbn-arxiv-sized graph, aggregating by
    ``geometric.send_ue_recv`` and by ``sparse.matmul`` on the CSR
    adjacency: both routes' logits and first-step gradients (dropout off)
    against the port on the CPU in fp32 (the CSR route, the faster there)
    and an fp64 run on the card, by phase 8's rule, GCN_STEPS full-batch
    Adam steps a route (dropout 0.5, the same masks: the same seed), and
    ``send_u_recv`` sum / mean / max, ``send_ue_recv`` and ``send_uv``
    (GAT-style edge scores) at hidden width against the CPU the same way,
    each aggregation timed beside the other route's."""
    from paddle_tpu_torch import geometric
    rng = np.random.default_rng(1401)
    src, dst = arxiv_graph(rng)
    x_np = rng.standard_normal((ARXIV_NODES, ARXIV_FEATS)).astype(
        np.float32)
    labels_np = rng.integers(0, ARXIV_CLASSES, ARXIV_NODES)
    train_np = rng.random(ARXIV_NODES) < 0.54
    n_edges = len(src)
    res = {"nodes": ARXIV_NODES, "edges_with_loops": n_edges,
           "max_in_degree": int(np.bincount(dst).max()),
           "mean_in_degree": float(n_edges / ARXIV_NODES)}
    log(f"  graph: {ARXIV_NODES} nodes, {n_edges} edges with self loops, "
        f"in-degree max {res['max_in_degree']}, mean "
        f"{res['mean_in_degree']:.2f}")
    prev = pt.get_device()
    pt.set_device("cpu")
    try:
        pt.seed(14)
        cpu_model = gcn_model(pt)
        f64_model = copy.deepcopy(cpu_model).double().to(DEV)
        card_model = copy.deepcopy(cpu_model).to(DEV)
    finally:
        pt.set_device(prev)

    def tensors(device, dtype):
        return (torch.as_tensor(x_np, device=device).to(dtype),
                torch.as_tensor(labels_np, device=device),
                torch.as_tensor(train_np, device=device))

    cpu_graph = GcnGraph(torch, src, dst, ARXIV_NODES, "cpu",
                         torch.float32)
    f64_graph = GcnGraph(torch, src, dst, ARXIV_NODES, DEV,
                         torch.float64)
    graph = GcnGraph(torch, src, dst, ARXIV_NODES, DEV, torch.float32)
    t0 = time.perf_counter()
    exact = gcn_grads(torch, pt, f64_model, *tensors(DEV, torch.float64),
                      f64_graph)
    del f64_model
    t1 = time.perf_counter()
    # the CPU's fp32 run takes the CSR route (3-4x faster there than the
    # atomic one; their distances from fp64 are alike)
    cpu_graph.route = "sparse"
    want = gcn_grads(torch, pt, cpu_model, *tensors("cpu", torch.float32),
                     cpu_graph)
    log(f"  GCN references: fp64 on the card {t1 - t0:.1f} s, fp32 on the "
        f"CPU {time.perf_counter() - t1:.1f} s")
    x, labels, train = tensors(DEV, torch.float32)
    routes = {}
    start = copy.deepcopy(card_model.state_dict())
    for route in ("geometric", "sparse"):
        graph.route = route
        card_model.set_state_dict(start)
        got = gcn_grads(torch, pt, card_model, x, labels, train, graph)
        errs = {}
        for group in ("logits", "loss", "grad"):
            # phase 8's rule a group (staged_against_f64): the gradients
            # through BatchNorm's backward cancel (C42)
            keys = [k for k in got if k.split(" ")[0] == group]
            (card_d, worst), (cpu_d, _) = (group_distance(got, exact, keys),
                                           group_distance(want, exact, keys))
            held_to_f64(f"GCN {route} {group}", card_d, cpu_d, worst)
            errs[group] = dict(card=card_d, cpu=cpu_d, worst=worst)
        routes[route] = {"max_err_over_max": errs}
    # the training steps, a route at a time from the same weights and seed
    for route in ("geometric", "sparse"):
        graph.route = route
        card_model.set_state_dict(start)
        opt = pt.optimizer.Adam(learning_rate=0.01,
                                parameters=card_model.parameters())
        card_model.train()
        pt.seed(1402)
        losses, ms = [], []
        for _ in range(GCN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = pt.nn.functional.cross_entropy(
                card_model(x, graph)[train], labels[train])
            loss.backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        if not all(np.isfinite(losses)):
            raise AssertionError(f"GCN {route}: losses {losses}")
        routes[route].update(losses=losses, step_ms=ms)
        log(f"  GCN {route}: Adam steps {[f'{v:.2f}' for v in ms]} ms, "
            f"losses {[f'{v:.5f}' for v in losses]} ({smi})")
    res["routes"] = routes
    # the aggregations alone at hidden width, card against the CPU (the
    # fp64 run on the card)
    h_np = rng.standard_normal((ARXIV_NODES, GCN_HIDDEN)).astype(np.float32)
    h, h_cpu = torch.as_tensor(h_np, device=DEV), torch.from_numpy(h_np)
    att_np = rng.standard_normal((ARXIV_NODES, 8)).astype(np.float32)
    att, att_cpu = torch.as_tensor(att_np, device=DEV), torch.from_numpy(
        att_np)
    e_ids = n_edges * 16                 # src and dst, int64
    feat = ARXIV_NODES * GCN_HIDDEN * 4
    #: name -> (fn(graph, features), features, CPU features, bytes: the
    #: features read once, the output written once, the edge lists)
    ops = {
        "send_ue_recv mul sum (GCN)": (
            lambda g, a: geometric.send_ue_recv(
                a, g.norm[:, None], g.src, g.dst, "mul", "sum",
                out_size=g.n), h, h_cpu, 2 * feat + e_ids + n_edges * 4),
        "sparse.matmul CSR (GCN)": (
            lambda g, a: g.sparse.matmul(g.adj, a), h, h_cpu,
            2 * feat + n_edges * 8 + (ARXIV_NODES + 1) * 4),
        "send_u_recv sum": (lambda g, a: geometric.send_u_recv(
            a, g.src, g.dst, "sum", out_size=g.n), h, h_cpu,
            2 * feat + e_ids),
        "send_u_recv mean": (lambda g, a: geometric.send_u_recv(
            a, g.src, g.dst, "mean", out_size=g.n), h, h_cpu,
            2 * feat + e_ids),
        "send_u_recv max": (lambda g, a: geometric.send_u_recv(
            a, g.src, g.dst, "max", out_size=g.n), h, h_cpu,
            2 * feat + e_ids),
        "send_uv add (GAT edge scores, 8 heads)": (
            lambda g, a: geometric.send_uv(a, a, g.src, g.dst, "add"),
            att, att_cpu, 2 * att.numel() * 4 + n_edges * 8 * 4 + e_ids),
    }
    timed = {}
    for name, (fn, a, a_cpu, nbytes) in ops.items():
        got = fn(graph, a)
        held = f64_held(torch, name, got, fn(cpu_graph, a_cpu),
                        fn(f64_graph, a.double()))
        ms = time_ms(torch, lambda: fn(graph, a), iters=10, warmup=2)
        timed[name] = dict(ms=ms, bytes=nbytes,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, **held)
        log(f"  {name}: {ms:.4f} ms ({smi}); its bytes over 3.35 TB/s "
            f"{timed[name]['bound_ms']:.4f} ms")
        del got
    res["aggregations"] = timed
    log(f"  GCN aggregation: send_ue_recv "
        f"{timed['send_ue_recv mul sum (GCN)']['ms']:.4f} ms beside "
        f"sparse.matmul {timed['sparse.matmul CSR (GCN)']['ms']:.4f} ms")
    return res


def bigbird_mask(torch, gen, seq, device):
    """BigBird-ITC's block pattern, ``[heads, seq, seq]`` bool: each query
    block sees its own and both neighbouring blocks (3 sliding),
    BIGBIRD_RANDOM random blocks (per head), and the first
    BIGBIRD_GLOBAL blocks, which see every block."""
    nb = seq // BIGBIRD_BLOCK
    blocks = torch.zeros(BIGBIRD_HEADS, nb, nb, dtype=torch.bool,
                         device=device)
    i = torch.arange(nb, device=device)
    for off in (-1, 0, 1):
        j = (i + off).clamp(0, nb - 1)
        blocks[:, i, j] = True
    rand = torch.randint(0, nb, (BIGBIRD_HEADS, nb, BIGBIRD_RANDOM),
                         generator=gen, device=device)
    blocks.scatter_(2, rand, True)
    blocks[:, :BIGBIRD_GLOBAL, :] = True
    blocks[:, :, :BIGBIRD_GLOBAL] = True
    return blocks.repeat_interleave(BIGBIRD_BLOCK, 1).repeat_interleave(
        BIGBIRD_BLOCK, 2)


def bigbird_phase(torch, pt, smi):
    """14(b): ``sparse.nn.functional.attention`` over BigBird-base's
    pattern (a COO mask of the pattern's entries), at BIGBIRD_TOKENS
    timed beside SDPA with the same boolean mask (the library's call for
    the same function, held equal), and at BIGBIRD_CHECK_TOKENS against
    the CPU in fp32 and fp64."""
    from paddle_tpu_torch import sparse
    res = {}
    for seq in (BIGBIRD_CHECK_TOKENS, BIGBIRD_TOKENS):
        gen = torch.Generator(DEV).manual_seed(1403 + seq)
        shape = (1, BIGBIRD_HEADS, seq, BIGBIRD_HEAD_DIM)
        q, k, v = (torch.randn(shape, device=DEV, generator=gen)
                   for _ in range(3))
        dense = bigbird_mask(torch, gen, seq, DEV)
        idx = dense.nonzero().T
        mask = sparse.sparse_coo_tensor(
            idx, torch.ones(idx.shape[1], device=DEV),
            [BIGBIRD_HEADS, seq, seq])
        out = sparse.nn.functional.attention(q, k, v, mask)
        lib = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=dense[None])
        row = {"nnz": int(idx.shape[1]),
               "density": idx.shape[1] / (BIGBIRD_HEADS * seq * seq),
               "sdpa_vs_sparse": rel64(torch, lib, out)}
        check(f"BigBird {seq}: SDPA with the boolean mask vs sparse "
              f"attention", row["sdpa_vs_sparse"], FP32_TOL, "max err / max")
        if seq == BIGBIRD_CHECK_TOKENS:
            cpu = [t.cpu() for t in (q, k, v)]
            cmask = sparse.sparse_coo_tensor(
                idx.cpu(), torch.ones(idx.shape[1]),
                [BIGBIRD_HEADS, seq, seq])
            w32 = sparse.nn.functional.attention(*cpu, cmask)
            w64 = sparse.nn.functional.attention(
                *(t.double() for t in cpu), cmask)
            row.update(f64_held(torch, f"BigBird {seq} card vs CPU", out,
                                w32, w64))
        else:
            row["ms"] = time_ms(torch, lambda: sparse.nn.functional.attention(
                q, k, v, mask), iters=10, warmup=2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=dense[None]), iters=10, warmup=2)
            log(f"  BigBird attention at {seq} tokens: {row['ms']:.4f} ms "
                f"(SDPA with the mask {row['library_ms']:.4f} ms; {smi})")
        res[str(seq)] = row
        del q, k, v, dense, idx, mask, out, lib
    return res


def voxel_input(torch, rng, grid, n_vox):
    """A SparseCooTensor ``[1, *grid, SECOND_IN]`` on the CPU of ``n_vox``
    distinct voxels, uniform over the grid, with SECOND_IN features each
    (every feature an entry)."""
    from paddle_tpu_torch import sparse
    total = int(np.prod(grid))
    flat = np.unique(rng.integers(0, total, int(n_vox * 1.2)))
    flat = np.sort(rng.choice(flat, n_vox, replace=False))
    vox = np.stack(np.unravel_index(flat, grid))
    feats = rng.standard_normal((len(flat), SECOND_IN)).astype(np.float32)
    idx = np.concatenate([
        np.zeros((1, len(flat) * SECOND_IN), np.int64),
        np.repeat(vox, SECOND_IN, 1),
        np.tile(np.arange(SECOND_IN), len(flat))[None]], 0)
    return sparse.sparse_coo_tensor(idx, torch.from_numpy(feats.reshape(-1)),
                                    [1, *grid, SECOND_IN])


def second_phase(torch, pt, smi):
    """14(c): SECOND's first sparse block: ``SubmConv3D`` and a stride-2
    ``Conv3D`` (4 -> 16, kernel 3, padding 1), weights drawn on the CPU
    and carried to the card by ``jax_layout`` / ``load_jax_state``; timed
    on KITTI's grid with SECOND_VOXELS voxels, held against the CPU in
    fp32 and an fp64 run on the card on SECOND_CHECK_GRID at the same
    occupancy (the output patterns equal, values by phase 8's rule)."""
    from paddle_tpu_torch import sparse
    rng = np.random.default_rng(1404)
    res = {}
    occupancy = SECOND_VOXELS / np.prod(SECOND_GRID)
    for name, cls, kw in (("SubmConv3D", sparse.nn.SubmConv3D,
                           dict(padding=1)),
                          ("Conv3D", sparse.nn.Conv3D,
                           dict(stride=2, padding=1))):
        prev = pt.get_device()
        pt.set_device("cpu")
        try:
            pt.seed(1405)
            cpu_conv = cls(SECOND_IN, SECOND_OUT, 3, **kw)
            layout = pt.jax_layout(cpu_conv)
            f64_conv = copy.deepcopy(cpu_conv).double().to(DEV)
        finally:
            pt.set_device(prev)
        conv = pt.load_jax_state(cls(SECOND_IN, SECOND_OUT, 3, **kw), layout)
        n_small = int(round(occupancy * np.prod(SECOND_CHECK_GRID)))
        small = voxel_input(torch, rng, SECOND_CHECK_GRID, n_small)
        on_card = sparse.sparse_coo_tensor(small.indices().to(DEV),
                                           small.values().to(DEV),
                                           small.shape)
        got = conv(on_card)
        want = cpu_conv(small)
        exact = f64_conv(sparse.sparse_coo_tensor(
            on_card.indices(), on_card.values().double(), small.shape))
        if not (torch.equal(got.indices().cpu(), want.indices())
                and torch.equal(want.indices(), exact.indices().cpu())):
            raise AssertionError(f"{name}: output patterns differ")
        row = {"check_grid": list(SECOND_CHECK_GRID), "check_voxels":
               n_small, "check_nnz": want.nnz}
        row.update(f64_held(torch, f"{name} {list(SECOND_CHECK_GRID)} card "
                            "vs CPU", got.values(), want.values(),
                            exact.values()))
        big = voxel_input(torch, rng, SECOND_GRID, SECOND_VOXELS)
        big = sparse.sparse_coo_tensor(big.indices().to(DEV),
                                       big.values().to(DEV), big.shape)
        torch.cuda.reset_peak_memory_stats()
        out = conv(big)
        row.update(grid=list(SECOND_GRID), voxels=SECOND_VOXELS,
                   out_nnz=out.nnz, out_shape=out.shape,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        row["ms"] = time_ms(torch, lambda: conv(big), iters=5, warmup=1)
        log(f"  {name} on {list(SECOND_GRID)}, {SECOND_VOXELS} voxels: "
            f"{row['ms']:.3f} ms, out nnz {out.nnz}, peak "
            f"{row['peak_gib']:.2f} GiB ({smi})")
        res[name] = row
        del big, out
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _dist_pair(torch, build, args):
    """``build(*args)`` on the card, on the CPU and in fp64 on the CPU."""
    return (build(*[a.to(DEV) for a in args]),
            build(*[a.cpu() for a in args]),
            build(*[a.cpu().double() for a in args]))


def gamma_run(torch, families, build, params, loss, replay=None):
    """``build(*params).rsample()`` and the gradients of ``loss`` of it in
    ``params``, with every draw of the port's ``_standard_gamma``
    recorded; given ``replay`` (those draws, moved), each draw is
    replaced by the next of them, carrying the implicit gradient
    ``torch._standard_gamma_grad`` at the replaying device and dtype as
    its own. Returns the sample, the gradients and the draws."""
    draws, draw = [], families._standard_gamma

    def gamma(c, gen):
        if replay is None:
            g = draw(c, gen)
        else:
            g = replay[len(draws)]
            # the value g, d g / d c = _standard_gamma_grad(c, g)
            g = g + torch._standard_gamma_grad(c.detach(), g) * (
                c - c.detach())
        draws.append(g.detach())
        return g

    families._standard_gamma = gamma
    try:
        s = build(*params).rsample()
        loss(s).backward()
    finally:
        families._standard_gamma = draw
    return s.detach(), [p.grad for p in params], draws


def kl_pairs(torch, D, gen):
    """Every registered pair at KL_BATCH, parameters drawn on the card."""
    b = (KL_BATCH,)

    def u(lo, hi, shape=b):
        return lo + (hi - lo) * torch.rand(shape, device=DEV, generator=gen)

    def spd(d):
        a = torch.randn(d, d, device=DEV, generator=gen)
        return a @ a.T + d * torch.eye(d, device=DEV)

    return {
        "Normal": (D.Normal, [u(-1, 1), u(.5, 2)], [u(-1, 1), u(.5, 2)]),
        "Uniform": (D.Uniform, [u(0, .5), u(1, 1.5)], [u(-1, 0), u(2, 3)]),
        "Bernoulli": (D.Bernoulli, [u(.1, .9)], [u(.1, .9)]),
        "Categorical": (D.Categorical, [u(-2, 2, (KL_BATCH, 10))],
                        [u(-2, 2, (KL_BATCH, 10))]),
        "Beta": (D.Beta, [u(.5, 4), u(.5, 4)], [u(.5, 4), u(.5, 4)]),
        "Gamma": (D.Gamma, [u(.5, 4), u(.5, 3)], [u(.5, 4), u(.5, 3)]),
        "Dirichlet": (D.Dirichlet, [u(.5, 4, (KL_BATCH, 8))],
                      [u(.5, 4, (KL_BATCH, 8))]),
        "Exponential": (D.Exponential, [u(.2, 3)], [u(.2, 3)]),
        "Laplace": (D.Laplace, [u(-1, 1), u(.5, 2)], [u(-1, 1), u(.5, 2)]),
        "Geometric": (D.Geometric, [u(.1, .9)], [u(.1, .9)]),
        "MultivariateNormal": (
            D.MultivariateNormal, [u(-1, 1, (KL_BATCH, 16)), spd(16)],
            [u(-1, 1, (KL_BATCH, 16)), spd(16)]),
        "LogNormal": (D.LogNormal, [u(-1, 1), u(.5, 2)], [u(-1, 1),
                                                          u(.5, 2)]),
        "Poisson": (D.Poisson, [u(.5, 6)], [u(.5, 6)]),
    }


def moment_check(label, z, mean, var=None):
    """Draws ``z`` (numpy, float64) against their mean (and variance): the
    sample mean within MOMENT_SIGMAS standard errors (sqrt(var / n), the
    sample's own variance where ``var`` is None), the sample variance
    within MOMENT_SIGMAS of its standard error (sqrt((m4 - var^2) / n),
    from the sample's fourth central moment)."""
    z = np.asarray(z, np.float64).reshape(-1)
    n = z.size
    v = z.var() if var is None else var
    check(f"{label}: sample mean - {mean:.4g}", abs(z.mean() - mean)
          / np.sqrt(v / n), MOMENT_SIGMAS, "standard errors")
    if var is not None:
        m4 = float(((z - z.mean()) ** 4).mean())
        check(f"{label}: sample variance - {var:.4g}", abs(z.var() - var)
              / np.sqrt(max(m4 - z.var() ** 2, 1e-30) / n), MOMENT_SIGMAS,
              "standard errors")


def distribution_phase(torch, pt, smi):
    """14(d): ``distribution`` on the card: Categorical over Llama-3's
    vocabulary, a 256-dim MultivariateNormal, the gamma-based samplers'
    gradients, a SAC policy head, every KL pair; every deterministic
    function against the CPU in fp32 and fp64 by phase 8's rule, sample
    moments within MOMENT_SIGMAS standard errors, and each timed."""
    import paddle_tpu_torch.distribution as D
    gen = torch.Generator(DEV).manual_seed(1406)
    pt.seed(1407)
    res = {}

    # Categorical over the vocabulary: log_prob, entropy, sample
    logits = 3 * torch.randn(CAT_BATCH, CAT_VOCAB, device=DEV, generator=gen)
    cats = _dist_pair(torch, D.Categorical, [logits])
    tokens = torch.randint(0, CAT_VOCAB, (CAT_BATCH,), device=DEV,
                           generator=gen)
    res["Categorical log_prob"] = f64_held(
        torch, "Categorical log_prob",
        *[d.log_prob(tokens.to(d.logits.device)) for d in cats])
    res["Categorical entropy"] = f64_held(
        torch, "Categorical entropy", *[d.entropy() for d in cats])
    cat = cats[0]
    draws = cat.sample((256,))
    if not (draws.min() >= 0 and draws.max() < CAT_VOCAB):
        raise AssertionError("Categorical draws outside the vocabulary")
    # -log p of the draws has the entropy as its mean
    nll = -cat.log_prob(draws).double() - cat.entropy().double()[None]
    moment_check("Categorical -log p(draw) - entropy",
                 nll.cpu().numpy(), 0.0)
    res["categorical_ms"] = {
        "sample": time_ms(torch, lambda: cat.sample(), iters=10, warmup=2),
        "log_prob": time_ms(torch, lambda: cat.log_prob(tokens), iters=10,
                            warmup=2),
        "entropy": time_ms(torch, lambda: cat.entropy(), iters=10, warmup=2)}
    log(f"  Categorical [{CAT_BATCH}, {CAT_VOCAB}]: "
        f"{res['categorical_ms']} ms ({smi})")
    del cats, cat, draws, nll, logits

    # MultivariateNormal at dim 256, batch 1024
    a = torch.randn(MVN_DIM, MVN_DIM, device=DEV, generator=gen)
    cov = a @ a.T / MVN_DIM + torch.eye(MVN_DIM, device=DEV)
    loc = torch.randn(MVN_BATCH, MVN_DIM, device=DEV, generator=gen)
    mvns = _dist_pair(torch, lambda l, c: D.MultivariateNormal(
        l, covariance_matrix=c), [loc, cov])
    val = torch.randn(MVN_BATCH, MVN_DIM, device=DEV, generator=gen)
    res["MVN log_prob"] = f64_held(torch, "MVN log_prob", *[
        d.log_prob(val.to(d.loc.device, d.loc.dtype)) for d in mvns])
    res["MVN entropy"] = f64_held(torch, "MVN entropy",
                                  *[d.entropy() for d in mvns])
    qs = _dist_pair(torch, lambda l, c: D.MultivariateNormal(
        l, covariance_matrix=c), [loc.flip(0), cov + torch.eye(
            MVN_DIM, device=DEV)])
    res["MVN KL"] = f64_held(torch, "MVN KL", *[
        D.kl_divergence(p, q) for p, q in zip(mvns, qs)])
    mvn = mvns[0]
    x = mvn.rsample((16,))
    z = torch.linalg.solve_triangular(
        mvn.scale_tril, (x - loc)[..., None], upper=False)[..., 0]
    moment_check("MVN rsample, whitened", z.double().cpu().numpy(), 0.0, 1.0)
    res["mvn_ms"] = {
        "log_prob": time_ms(torch, lambda: mvn.log_prob(val), iters=10,
                            warmup=2),
        "rsample": time_ms(torch, lambda: mvn.rsample(), iters=10, warmup=2),
        "entropy": time_ms(torch, lambda: mvn.entropy(), iters=10, warmup=2),
        "kl": time_ms(torch, lambda: D.kl_divergence(mvn, qs[0]), iters=10,
                      warmup=2)}
    log(f"  MultivariateNormal dim {MVN_DIM} batch {MVN_BATCH}: "
        f"{res['mvn_ms']} ms ({smi})")
    del mvns, qs, mvn, x, z

    # the gamma-based samplers' reparameterised gradients: the card's
    # draws replayed through the port's map and backward on the CPU in
    # fp32 and fp64 (the gradients held by phase 8's rule), and the draws
    # standardised by the family's mean and variance (a Dirichlet's first
    # coordinate, independent across the batch)
    import paddle_tpu_torch.distribution.families as families
    grads = {}
    for name, build, n_par, loss in (
            ("Gamma", lambda c, r: D.Gamma(c, r), 2, lambda s: s.sum()),
            ("Beta", lambda a, b: D.Beta(a, b), 2, lambda s: s.sum()),
            ("Dirichlet", lambda c: D.Dirichlet(c), 1,
             lambda s: s[..., 0].sum())):
        params = [(0.3 + 4 * torch.rand(GAMMA_SHAPE, device=DEV,
                                        generator=gen)).requires_grad_()
                  for _ in range(n_par)]
        s, card_g, draws = gamma_run(torch, families, build, params, loss)
        cpu_g, f64_g = [gamma_run(
            torch, families, build,
            [p.detach().to("cpu", dt).requires_grad_() for p in params],
            loss, [g.to("cpu", dt) for g in draws])[1]
            for dt in (torch.float32, torch.float64)]
        grads[name] = {f"gradient {i}": f64_held(
            torch, f"{name} rsample gradient in parameter {i}", *g)
            for i, g in enumerate(zip(card_g, cpu_g, f64_g))}
        d = build(*[p.detach() for p in params])
        z = (s - d.mean) / d.variance.sqrt()
        moment_check(f"{name} rsample, standardised",
                     (z[..., 0] if name == "Dirichlet" else z)
                     .double().cpu().numpy(), 0.0, 1.0)
        ms = time_ms(torch, lambda: build(*params).rsample(), iters=10,
                     warmup=2)
        grads[name]["rsample_ms"] = ms
        log(f"  {name} rsample at {list(GAMMA_SHAPE)} (its gradient "
            f"held against the CPU's at the card's draws): {ms:.4f} ms "
            f"({smi})")
    res["reparameterised"] = grads

    # a SAC policy head: Normal over the actions squashed by tanh
    mu = 0.5 * torch.randn(SAC_BATCH, SAC_ACTIONS, device=DEV, generator=gen)
    sig = 0.2 + torch.rand(SAC_BATCH, SAC_ACTIONS, device=DEV, generator=gen)
    heads = _dist_pair(torch, lambda m, s: D.TransformedDistribution(
        D.Normal(m, s), [D.TanhTransform()]), [mu, sig])
    act = torch.tanh(torch.randn(SAC_BATCH, SAC_ACTIONS, device=DEV,
                                 generator=gen))
    res["SAC tanh-Normal log_prob"] = f64_held(
        torch, "SAC tanh-Normal log_prob", *[d.log_prob(act.to(
            d.base.loc.device, d.base.loc.dtype)).sum(-1) for d in heads])
    policy = heads[0]
    acts = policy.rsample((64,))
    if not (acts.abs() < 1).all():
        raise AssertionError("tanh-squashed actions outside (-1, 1)")
    res["sac_ms"] = time_ms(torch, lambda: policy.log_prob(
        policy.rsample()).sum(-1), iters=10, warmup=2)
    log(f"  SAC head [{SAC_BATCH}, {SAC_ACTIONS}] rsample + log_prob: "
        f"{res['sac_ms']:.4f} ms ({smi})")

    # every registered KL pair
    kls = {}
    for name, (cls, p_args, q_args) in kl_pairs(torch, D, gen).items():
        ps = _dist_pair(torch, cls, p_args)
        qs = _dist_pair(torch, cls, q_args)
        kls[name] = f64_held(torch, f"KL {name}", *[
            D.kl_divergence(p, q) for p, q in zip(ps, qs)])
        kls[name]["ms"] = time_ms(torch, lambda: D.kl_divergence(
            ps[0], qs[0]), iters=10, warmup=2)
    res["kl"] = kls
    log(f"  KL pairs at batch {KL_BATCH}: "
        + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in kls.items())
        + f" ({smi})")
    return res


def phase14(torch, pt, smi):
    """14(a)-(d); prints a ``{"graph_sparse_distribution": ...}`` line."""
    out = {}
    for key, fn in (("gcn", gcn_phase), ("bigbird", bigbird_phase),
                    ("second", second_phase),
                    ("distribution", distribution_phase)):
        t0 = time.perf_counter()
        out[key] = fn(torch, pt, smi)
        out[key]["seconds"] = time.perf_counter() - t0
        log(f"  14 {key}: {out[key]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def llama_phases(torch, pt, amp, gen, nn_functional, fa, fused, ost,
                 quant_mod, pa, qm, rpa, kern, none):
    """Phases 2 to 6: the kernels at Llama-3-8B's shapes, the serving and
    training paths on one Llama-3-8B, the paths against each other, the
    timing of every kernel on the inputs those runs captured, and the
    kernel rows. Returns the rows."""
    dev = torch.device("cuda")
    phase("phase 2: kernel parity at Llama-3-8B attention shapes")
    q, kp, vp, tbl, desc = parity_layout(torch, rpa, dev)
    compare_kernels(torch, rpa, q, kp, vp, tbl, desc, "synthetic")
    flash_errs = compare_flash(torch, fa, dev)
    bwd_errs = compare_flash_bwd(torch, fa, dev)
    paged_errs = compare_paged(torch, pa, *paged_layout(torch, dev),
                               "synthetic")
    # the int8 kernels on the same layouts, pages quantised by the cache's
    # own codec
    (kq, ks), (vq, vs) = gen.quantize_kv_rows(kp), gen.quantize_kv_rows(vp)
    q8_errs, _ = compare_kernels_q8(torch, rpa, q, kq, vq, ks, vs, tbl, desc,
                                    "synthetic int8")
    pq, pkp, pvp, ptbl, pctx = paged_layout(torch, dev)
    (kq, ks), (vq, vs) = gen.quantize_kv_rows(pkp), gen.quantize_kv_rows(pvp)
    paged_q8_errs = compare_paged(torch, pa, pq, kq, vq, ptbl, pctx,
                                  "synthetic int8", ks, vs)
    # B4 and B5 on the context split's edge cases, int8 pages by the
    # cache's codec
    for label, (eq, ekp, evp, etbl, ectx) in paged_edge_layouts(torch, dev):
        paged_errs = worst_of(paged_errs, compare_paged(
            torch, pa, eq, ekp, evp, etbl, ectx, label))
        (kq, ks), (vq, vs) = (gen.quantize_kv_rows(ekp),
                              gen.quantize_kv_rows(evp))
        paged_q8_errs = worst_of(paged_q8_errs, compare_paged(
            torch, pa, eq, kq, vq, etbl, ectx, f"{label} int8", ks, vs))
    # kernel 8 and B9's context split (the cluster kernel) on its edge
    # cases, int8 pages by the cache's codec, and at every split count
    for label, (eq, ekp, evp, etbl, edesc) in ragged_edge_layouts(torch,
                                                                  dev):
        compare_kernels(torch, rpa, eq, ekp, evp, etbl, edesc, label)
        (kq, ks), (vq, vs) = (gen.quantize_kv_rows(ekp),
                              gen.quantize_kv_rows(evp))
        compare_kernels_q8(torch, rpa, eq, kq, vq, ks, vs, etbl, edesc,
                           f"{label} int8")
    compare_token_splits(torch, rpa, *decode_layout(torch, dev),
                         "decode layout")
    mm_errs = compare_int8_matmul(torch, qm, dev)
    del q, kp, vp, pq, pkp, pvp, kq, vq, eq, ekp, evp
    torch.cuda.empty_cache()
    phase("phase 2(a): kernel 6 and B7 at pages of 4, 8, 12, 32, 64, head_dim "
        "72, misaligned pools and pages of 128 at head_dim 256")
    page_rows = page_shapes(torch, rpa, gen)

    phase("phase 3: serving Llama-3-8B (32 layers, bf16, random weights)")
    cfg = pt.llama3_8b()
    t0 = time.perf_counter()
    # fp32 parameters, as the reference creates them, cast to bf16 before
    # any pool exists (the fp32 copy is 32 GB)
    model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0).to(
        torch.bfloat16)
    torch.cuda.empty_cache()
    log(f"  model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    prompts, warm = make_prompts()

    phase(" 3a: ContinuousServingEngine, ragged ticks")
    # one uncounted pass fills cuBLAS's choices for every tick shape, so
    # the two counted runs below are timed warm and alike
    serve(torch, pt, kern, model, prompts, warm)
    runs = {}
    for impl in rpa.IMPLS:
        outs, st = serve(torch, pt, kern, model, prompts, warm, impl=impl)
        runs[impl] = (outs, st)
        log(f"  {impl}: {st['steps']} ticks, {st['hits']} prefix hits, "
            f"wall {st['wall']:.3f} s")
        check_outputs(prompts, outs, cfg.vocab_size, impl)
        check_c25(f"ragged {impl} engine", st["pool_dtypes"],
                  st["logits_dtypes"])
        if st["steps"] <= 0 or st["hits"] <= 0:
            raise AssertionError(f"{impl}: no ticks or no prefix hits")
        # every per-token launch on the cluster kernel, by its own count
        want = {impl: N_LAYERS * st["steps"]}
        if impl == "token":
            want["token_cluster"] = want["token"]
        else:
            want["qblock_unit"] = want["qblock"]
        check_launches(f"ragged {impl} engine", st["launches"],
                       dict(none, **want))
    for a, b in zip(runs["qblock"][0], runs["token"][0]):
        if not np.array_equal(a, b):
            raise AssertionError("q-block and per-token engines disagree")
    log("  greedy streams identical under both kernels")
    # one instrumented pass per kernel: tick-by-tick forward, schedule
    # and attention times; the q-block pass also keeps one real tick's
    # layer-0 attention inputs
    probes = {}
    for impl in rpa.IMPLS:
        probes[impl] = TickProbe(torch, gen, model, N_LAYERS)
        serve(torch, pt, kern, model, prompts, warm, impl=impl,
              probes=[probes[impl]])
    cap = probes["qblock"]
    short = np.concatenate([prompts[1], runs["qblock"][0][1][0, 32:47]])

    phase(" 3b: static ServingEngine, one batch of 8 x 512-token prompts")
    static_prompts = list(np.random.RandomState(11).randint(
        0, cfg.vocab_size, (8, 512)).astype(np.int64))
    serve_static(torch, pt, kern, model, static_prompts)        # warm
    static_outs, static = serve_static(torch, pt, kern, model,
                                       static_prompts)
    check_outputs(static_prompts, static_outs, cfg.vocab_size, "static")
    if static["batches"] != 1:
        raise AssertionError(f"static engine ran {static['batches']} "
                             f"batches, expected 1")
    # C25: the prefill's SDPA gets the rope's fp32 q and k beside the bf16
    # v, which it computes in fp32 (the scalar B1); the decode steps read
    # fp32 pages
    check_launches("static engine", static["launches"],
                   dict(none, flash=N_LAYERS,
                        paged=N_LAYERS * (NEW_TOKENS - 1),
                        paged_cluster=N_LAYERS * (NEW_TOKENS - 1)))
    # an instrumented pass: every forward timed to a device sync, layer
    # 0's prefill and decode attention inputs kept
    static_cap = decode_capture(gen, N_LAYERS)
    static_flash = flash_capture(nn_functional, N_LAYERS)
    static_fwd = ForwardTimer(torch, model)
    serve_static(torch, pt, kern, model, static_prompts,
                 probes=[static_cap, static_flash, static_fwd])
    check_c25("static engine", [str(static_cap.best["kp"].dtype)],
              static_fwd.dtypes)
    log(f"  static: wall {static['wall']:.3f} s for one batch; "
        f"instrumented forwards (seq, ms): "
        + ", ".join(f"({n}, {ms:.2f})" for n, ms in static_fwd.times))

    phase(" 3c: ContinuousServingEngine(enable_ragged=False), legacy ticks")
    serve(torch, pt, kern, model, prompts, warm, enable_ragged=False)
    legacy_outs, legacy = serve(torch, pt, kern, model, prompts, warm,
                                enable_ragged=False)
    check_outputs(prompts, legacy_outs, cfg.vocab_size, "legacy")
    big_chunks = sum(n for size, n in legacy["chunk_buckets"].items()
                     if size >= 128)
    log(f"  legacy: {legacy['steps']} working ticks, "
        f"{legacy['decode_steps']} decode steps, prefill chunks by bucket "
        f"{dict(sorted(legacy['chunk_buckets'].items()))}, "
        f"{legacy['hits']} prefix hits, wall {legacy['wall']:.3f} s")
    if legacy["hits"] <= 0 or legacy["decode_steps"] <= 0 or not big_chunks:
        raise AssertionError("legacy: no prefix hits, decode steps or "
                             "flash-sized chunks")
    check_c25("legacy engine", legacy["pool_dtypes"], legacy["logits_dtypes"])
    # the chunks read fp32 pages back: the scalar B1 (C25)
    check_launches("legacy engine", legacy["launches"],
                   dict(none, flash=N_LAYERS * big_chunks,
                        paged=N_LAYERS * legacy["decode_steps"],
                        paged_cluster=N_LAYERS * legacy["decode_steps"]))
    same = sum(np.array_equal(a, b) for a, b in
               zip(legacy_outs, runs["qblock"][0]))
    log(f"  legacy vs ragged bf16 streams: {same} of {len(prompts)} "
        f"identical (bf16 paths round differently; phase 4 holds them "
        f"equal in fp32)")
    # an instrumented pass: every working tick timed to a device sync,
    # layer 0's inputs of a decode step and of a flash-sized chunk kept
    legacy_cap = decode_capture(gen, N_LAYERS)
    legacy_flash = flash_capture(nn_functional, N_LAYERS)
    legacy_ticks = []
    serve(torch, pt, kern, model, prompts, warm, enable_ragged=False,
          probes=[legacy_cap, legacy_flash], tick_ms=legacy_ticks)

    phase(" 3f: CUDA graphs against eager, bf16: the q-block, per-token and "
        "legacy engines on the load of (a) in order")
    off_bf16 = {}
    graph_bf16 = graphs_against_eager(torch, pt, gen, rpa, fused, quant_mod,
                                      kern, model, prompts, warm, int8=False,
                                      keep=off_bf16)
    sampled_and_abort(torch, pt, kern, model, prompts, warm)
    phase(f" 3h: speculative decoding, bf16: the load of (a) in order, "
        f"spec_k={SPEC_K}, the n-gram drafter and a two-layer draft model "
        f"at full width")
    draft_cfg = pt.llama3_8b()
    draft_cfg.num_hidden_layers = 2
    draft = pt.LlamaForCausalLM(draft_cfg, device="cuda", seed=1).to(
        torch.bfloat16)
    spec = {"bf16": spec_full_width(torch, pt, kern, model, prompts, warm,
                                    False, N_LAYERS, draft, off_bf16)}
    gc.collect()
    torch.cuda.empty_cache()
    phase(" 3k: serving under amp.auto_cast(level='O2', dtype='bfloat16'): "
          "the q-block, per-token, legacy and static engines, the q-block "
          "engine under O1, the replayed ticks and the graph keys")
    amp_srv = amp_serving(torch, pt, amp, gen, rpa, pa, kern, none, model,
                          prompts, warm, static_prompts)
    gc.collect()
    torch.cuda.empty_cache()

    phase(" 3e: ContinuousServingEngine(kv_dtype='int8', weight_dtype='int8'),"
        " the load of (a) on all three schedulers")
    int8_kw = dict(kv_dtype="int8", weight_dtype="int8")
    # one uncounted pass, as in (a) and (c): its engine quantises the
    # model's Linears in place, and the three counted runs find none left
    _, st = serve(torch, pt, kern, model, prompts, warm, **int8_kw)
    log(f"  int8 warm pass (q-block, uncounted): {st['steps']} ticks, "
        f"wall {st['wall']:.3f} s, {st['quantized']} Linears quantised")
    if st["quantized"] != N_LINEARS:
        raise AssertionError(f"int8: {st['quantized']} Linears quantised")
    int8_runs, mm_hist, b10_fp32 = {}, {}, {}
    for name, kw in INT8_PATHS.items():
        kw = dict(kw)
        kw["impl"] = kw.pop("ragged_impl", "qblock")
        outs, st = serve(torch, pt, kern, model, prompts, warm, **kw,
                         **int8_kw)
        int8_runs[name] = (outs, st)
        # B10's launches by M as its wrapper counted them in this run
        # (replays credited); 225 a forward of each token count
        mm_hist[name] = Counter(st["b10_by_m"])
        derived = {m: N_LINEARS * n for m, n in
                   sorted(st["forwards_by_m"].items())}
        if dict(mm_hist[name]) != derived:
            raise AssertionError(f"int8 {name}: B10 launches by M "
                                 f"{st['b10_by_m']}, 225 x the forwards "
                                 f"by M {derived}")
        check_outputs(prompts, outs, cfg.vocab_size, f"int8 {name}")
        if st["quantized"]:
            raise AssertionError(f"int8 {name}: {st['quantized']} Linears "
                                 f"quantised again")
        # C25: only layer 0's q, k and v projections see bf16 x (the first
        # norm's output); each takes the tensor-core variant its M names.
        # Every later Linear sees fp32 x and takes the fp32 variant its M
        # names; none takes the scalar kernel (every K is a multiple of 16)
        check_c25(f"int8 {name} engine", st["pool_dtypes"],
                  st["logits_dtypes"], quant=True)
        stream = BF16_LINEARS * sum(
            n for m, n in st["forwards_by_m"].items()
            if qm.matmul_variant(torch.bfloat16, m, 1, 4096)
            == "wgmma_stream")
        fp32_calls = N_LINEARS - BF16_LINEARS
        fp32_stream = fp32_calls * sum(
            n for m, n in st["forwards_by_m"].items()
            if qm.matmul_variant(torch.float32, m, 1, 4096)
            == "fp32_stream")
        want = dict(none, int8_matmul=N_LINEARS * st["forwards"],
                    int8_matmul_stream=stream,
                    int8_matmul_gemm=BF16_LINEARS * st["forwards"] - stream,
                    int8_matmul_fp32_stream=fp32_stream,
                    int8_matmul_fp32_gemm=fp32_calls * st["forwards"]
                    - fp32_stream)
        b10_fp32[f"int8 {name}"] = {
            "fp32_stream": fp32_stream,
            "fp32_gemm": fp32_calls * st["forwards"] - fp32_stream}
        log(f"  int8 {name}: B10 launches by M {st['b10_by_m']}")
        if sum(mm_hist[name].values()) != N_LINEARS * st["forwards"]:
            raise AssertionError(f"int8 {name}: B10 histogram "
                                 f"{mm_hist[name]} misses calls")
        if name == "legacy":
            big = sum(n for size, n in st["chunk_buckets"].items()
                      if size >= 128)
            if not big or st["decode_steps"] <= 0:
                raise AssertionError("int8 legacy: no flash-sized chunks or "
                                     "no decode steps")
            want.update(paged_q8=N_LAYERS * st["decode_steps"],
                        paged_q8_cluster=N_LAYERS * st["decode_steps"],
                        flash=N_LAYERS * big)
        else:
            want[f"{name}_q8"] = N_LAYERS * st["steps"]
            if name == "token":
                want["token_q8_cluster"] = want["token_q8"]
            else:
                want["qblock_q8_unit"] = want["qblock_q8"]
        log(f"  int8 {name}: {st['steps']} ticks, {st['forwards']} forwards,"
            f" {st['hits']} prefix hits, wall {st['wall']:.3f} s")
        if st["hits"] <= 0:
            raise AssertionError(f"int8 {name}: no prefix hits")
        check_launches(f"int8 {name} engine", st["launches"], want)
    for a, b in zip(int8_runs["qblock"][0], int8_runs["token"][0]):
        if not np.array_equal(a, b):
            raise AssertionError("int8 q-block and per-token engines "
                                 "disagree")
    # native pages are fp32 in the bf16 model (k's dtype, C25)
    nbytes = {"native fp32": runs["qblock"][1]["page_nbytes"],
              "int8": int8_runs["qblock"][1]["page_nbytes"]}
    want_nbytes = {"native fp32": gen.kv_page_nbytes(
        N_KV, HEAD_DIM, PAGE, "native", "float32", N_LAYERS),
        "int8": gen.kv_page_nbytes(N_KV, HEAD_DIM, PAGE, "int8",
                                   num_layers=N_LAYERS)}
    if nbytes != want_nbytes:
        raise AssertionError(f"page_nbytes {nbytes}, expected {want_nbytes}")
    log(f"  page_nbytes (32 layers, K and V): native fp32 "
        f"{nbytes['native fp32']}, int8 {nbytes['int8']}, ratio "
        f"{nbytes['native fp32'] / nbytes['int8']:.4f}")
    # instrumented passes: the q-block one times every tick and keeps
    # layer 0's attention inputs of one tick and B10's inputs at M = 8
    # and 256; the legacy one times every working tick and keeps layer
    # 0's inputs of a decode step
    int8_probe = TickProbe(torch, gen, model, N_LAYERS)
    mm_cap = MatmulCapture(quant_mod, model)
    serve(torch, pt, kern, model, prompts, warm, impl="qblock",
          probes=[int8_probe, mm_cap], **int8_kw)
    if len(mm_cap.best) != 2 * len(MATMUL_SHAPES):
        raise AssertionError(f"B10 captured {sorted(mm_cap.best)}")
    int8_decode = decode_capture(gen, N_LAYERS)
    int8_legacy_ticks = []
    serve(torch, pt, kern, model, prompts, warm, enable_ragged=False,
          probes=[int8_decode], tick_ms=int8_legacy_ticks, **int8_kw)
    phase(" 3g: CUDA graphs against eager, fully int8: the three engines on "
        "the load of (a) in order")
    off_int8 = {}
    graph_int8 = graphs_against_eager(torch, pt, gen, rpa, fused, quant_mod,
                                      kern, model, prompts, warm, int8=True,
                                      keep=off_int8)
    phase(f" 3i: speculative decoding, fully int8: the load of (a) in order, "
        f"spec_k={SPEC_K}, the n-gram drafter and the draft model of 3h")
    spec["int8"] = spec_full_width(torch, pt, kern, model, prompts, warm,
                                   True, N_LAYERS, draft, off_int8)
    phase(" 3k (int8): the fully-int8 engines under amp.auto_cast(level="
          "'O2', dtype='bfloat16')")
    amp_srv["int8"] = amp_serving_int8(torch, pt, amp, qm, kern, none, model,
                                       prompts, warm)
    del model, draft
    gc.collect()              # engines and their threads may hold it in cycles
    torch.cuda.empty_cache()

    phase(f" 3d: training, Llama-3-8B widths cut to {TRAIN_LAYERS} layers, "
        f"bf16, AdamW(multi_precision) + global-norm clip + warmup/cosine")
    trained = train(torch, pt, kern, fa, none, ost)
    phase(" 3j: paddle.amp on the training step: O2 fp16 and O1 fp16 with "
          "GradScaler, bf16 without AMP, the dtype trace and the scaler's "
          "skips")
    amp_runs = amp_phase(torch, pt, kern, none)

    phase("phase 4: paths against each other (fp32, TF32 off, 2 layers, "
        "full width)")
    ref_cfg = pt.llama3_8b()
    ref_cfg.num_hidden_layers = 2
    ref_model = pt.LlamaForCausalLM(ref_cfg, device="cuda", seed=0)
    with torch.inference_mode():
        ref = ref_model(short[None])[0]
        cache = gen.SlotPagedKVCache(1, page_size=PAGE, max_len=2048,
                                     device=dev)
        cache.assign(0, short)
        cache.begin_ragged([(0, 0, short.shape[0])])
        got = ref_model(short[None], cache=cache,
                        position_ids=np.arange(short.shape[0]))[0]
    if not (torch.isfinite(got).all() and got.shape == (47, cfg.vocab_size)):
        raise AssertionError("ragged logits not finite or mis-shaped")
    rel = float((got - ref).abs().max() / ref.abs().max())
    check("ragged vs cache-free logits (relative, fp32, 2 layers)", rel,
          1e-4)
    del cache, ref, got
    rng = np.random.RandomState(13)
    cross_prompts = [short, rng.randint(0, cfg.vocab_size, 300),
                     rng.randint(0, cfg.vocab_size, 160)]
    # the fp32 paths run B1 on the scalar kernel only: with the counts
    # zeroed before each run, its launches are that variant's main-path
    # count and the tensor-core count stays 0
    zero_counts(kern)
    cross_outs = cross_paths(pt, ref_model, cross_prompts)
    rel = paged_logits_rel_err(torch, gen, ref_model, cross_outs[1][0], 300)
    check("generate's paged cache vs cache-free logits (relative, fp32, "
          "2 layers, prefill of 300 then 7 decode steps)", rel, 1e-4)
    simt_by_path = {"fp32 cross paths": read_counts(kern)}
    phase("  4(b): the q-block engine at pages of 16, 8 and 32, native and "
        "int8 KV pages")
    page_launches = page_engines(torch, pt, kern, ref_model, prompts, warm)
    phase("  4(d), 4(e): speculative decoding, fp32: self-speculation and an "
        "always-wrong drafter")
    spec["fp32 cross paths"] = spec_cross_paths(torch, pt, kern, ref_model)
    zero_counts(kern)
    cross_paths_int8(pt, ref_model, cross_prompts)     # quantises ref_model
    for key in ("qblock_q8", "token_q8", "paged_q8", "int8_matmul"):
        if not kern[key].launches:
            raise AssertionError(f"int8 cross paths never launched {key}")
    b10_tc = kern["int8_matmul_stream"].launches \
        + kern["int8_matmul_gemm"].launches
    cross_fp32 = {v: kern[f"int8_matmul_{v}"].launches
                  for v in FP32_VARIANTS}
    log(f"  fp32 int8 cross paths: B10 launches "
        f"{kern['int8_matmul'].launches}, tensor-core {b10_tc}, fp32 "
        f"{cross_fp32}")
    scalar = kern["int8_matmul"].launches - sum(cross_fp32.values())
    if b10_tc or scalar:
        raise AssertionError(f"fp32 B10 took the tensor-core kernels "
                             f"{b10_tc} times, fp32 variants "
                             f"{cross_fp32} of {kern['int8_matmul'].launches}")
    b10_fp32["fp32 int8 cross paths"] = cross_fp32
    simt_by_path["fp32 int8 cross paths"] = read_counts(kern)
    for name, counts in simt_by_path.items():
        log(f"  {name}: B1 launches {counts['flash']}, tensor-core "
            f"{counts['flash_wgmma']}")
        if counts["flash_wgmma"]:
            raise AssertionError(f"{name}: fp32 B1 took the tensor-core "
                                 f"kernel {counts['flash_wgmma']} times")
    simt_by_path = {k: v["flash"] for k, v in simt_by_path.items()}
    if not simt_by_path["fp32 cross paths"]:
        raise AssertionError("the fp32 cross paths never launched B1")
    del ref_model
    torch.cuda.empty_cache()
    train_grad_err = train_cross_check(torch, pt, fa, kern, none)
    # B1, B2 and B3 launch twice each on the scalar kernels there, and the
    # tensor-core ones never (checked exactly inside)
    simt_by_path["fp32 training step"] = bwd_simt_launches = 2

    log("  captured tick: " + json.dumps(
        {k: np.asarray(v).tolist() for k, v in
         zip(("slots", "q_starts", "q_lens", "ctx"), cap.best["desc"])}))
    c = cap.best
    cerrs, plans = compare_kernels(torch, rpa, c["q"], c["kp"], c["vp"],
                                   c["tbl"], c["desc"], "captured")
    dcap = cap.decode
    log("  captured pure-decode tick: " + json.dumps(
        {k: np.asarray(v).tolist() for k, v in
         zip(("slots", "q_starts", "q_lens", "ctx"), dcap["desc"])}))
    dcerrs, dplans = compare_kernels(torch, rpa, dcap["q"], dcap["kp"],
                                     dcap["vp"], dcap["tbl"], dcap["desc"],
                                     "captured decode")
    decode_caps = {"static": static_cap.best, "legacy": legacy_cap.best}
    for name, dc in decode_caps.items():
        log(f"  captured {name} decode step: ctx "
            f"{dc['ctx'].cpu().numpy().tolist()}")
        e = compare_paged(torch, pa, dc["q"], dc["kp"], dc["vp"],
                          dc["tables"], dc["ctx"], f"captured {name}")
        paged_errs = worst_of(paged_errs, e)
    flash_caps = {"static prefill": static_flash.best,
                  "legacy chunk": legacy_flash.best}
    for name, fc in flash_caps.items():
        q, k, v = (fc[x].transpose(1, 2) for x in "qkv")
        label = (f"captured {name} B1 b={q.shape[0]} sq={q.shape[2]} "
                 f"sk={k.shape[2]} q_off={fc['q_offset']}")
        flash_errs = worst_of(flash_errs, compare_flash_case(
            torch, fa, q, k, v, fc["causal"], fc["q_offset"], 0, label))
    tc = trained["capture"]
    q, k, v, dout = (tc[x].transpose(1, 2) for x in ("q", "k", "v", "dout"))
    label = (f"captured train step B1 b={q.shape[0]} sq={q.shape[2]} "
             f"sk={k.shape[2]}")
    flash_errs = worst_of(flash_errs, compare_flash_case(
        torch, fa, q, k, v, True, tc["q_offset"], 0, label))
    bwd_errs = worst_of(bwd_errs, compare_flash_bwd_case(
        torch, fa, q, k, v, dout, None, True, tc["q_offset"], 0,
        label.replace("B1", "B2/B3")))
    del q, k, v, dout
    ic = int8_probe.best
    log("  captured int8 tick: " + json.dumps(
        {k: np.asarray(v).tolist() for k, v in
         zip(("slots", "q_starts", "q_lens", "ctx"), ic["desc"])}))
    q8_cerrs, q8_plans = compare_kernels_q8(
        torch, rpa, ic["q"], ic["kp"], ic["vp"], ic["ks"], ic["vs"],
        ic["tbl"], ic["desc"], "captured int8")
    idc = int8_probe.decode
    log("  captured int8 pure-decode tick: " + json.dumps(
        {k: np.asarray(v).tolist() for k, v in
         zip(("slots", "q_starts", "q_lens", "ctx"), idc["desc"])}))
    q8_dcerrs, q8_dplans = compare_kernels_q8(
        torch, rpa, idc["q"], idc["kp"], idc["vp"], idc["ks"], idc["vs"],
        idc["tbl"], idc["desc"], "captured int8 decode")
    dc = int8_decode.best
    log(f"  captured int8 legacy decode step: ctx "
        f"{dc['ctx'].cpu().numpy().tolist()}")
    paged_q8_errs = worst_of(paged_q8_errs, compare_paged(
        torch, pa, dc["q"], dc["kp"], dc["vp"], dc["tables"], dc["ctx"],
        "captured int8 legacy", dc["ks"], dc["vs"]))
    for (k, n, m), mc in sorted(mm_cap.best.items()):
        merge_mm_errs(mm_errs, compare_int8_matmul_case(
            torch, qm, mc["x"], mc["wq"], mc["ws"],
            f"captured B10 M={m} K={k} N={n}"), f"{k}x{n}")
    log(f"  B10 worst C20 ratio by (K, N), captured inputs included: "
        f"{mm_errs['ratio_by_shape']}")

    phase("phase 5: timing (the bf16 model: fp32 pages and activations "
          "after layer 0's attention, C25)")
    scale = HEAD_DIM ** -0.5
    plain = {"qblock": rpa.qblock_attention_plain,
             "token": rpa.token_attention_plain}
    rows = []
    timed = time_ragged(torch, rpa, {impl: kern[impl] for impl in rpa.IMPLS},
                        plain, (
        ("captured mixed tick", c, plans, cerrs),
        ("captured pure-decode tick", dcap, dplans, dcerrs)), scale)
    first, *other = timed["qblock"]
    q_paths = {"3a q-block engine": runs["qblock"][1]["launches"],
               "3h spec on, draft model": spec["bf16"]["draft model"]
               ["launches"],
               "4b page 8": page_launches[8, "native"],
               "4b page 32": page_launches[32, "native"]}
    rows.append({"name": "ragged_qblock", "route": "cuda",
                 "source": QBLOCK_SOURCE,
                 "replaces": f"{REF}:215", "variant": "unit",
                 "kernel": "qblock_unit_kernel",
                 "launches": runs["qblock"][1]["launches"]["qblock"],
                 "launches_by_path": {
                     k: {v: c.get(f"qblock_{v}", 0)
                         for v in rpa.QBLOCK_VARIANTS}
                     for k, c in q_paths.items()},
                 **first, "library_ms": None, "library": RAGGED_LIBRARY,
                 "other_shapes": other,
                 "page_shapes": [dict(r["bf16"], shape=r["shape"])
                                 for r in page_rows]})
    rt = next(r for r in page_rows if r["shape"].startswith("page 64,"))
    rows.append({"name": "ragged_qblock_runtime", "route": "cuda",
                 "source": QBLOCK_SOURCE, "replaces": f"{REF}:215",
                 "variant": "runtime", "kernel": "qblock_runtime_kernel",
                 "launches": page_launches[32, "native"]["qblock_runtime"],
                 **rt["bf16"],
                 "shape": "phase 2(a) layout at page 64, head_dim 128, bf16",
                 "library_ms": None, "library": RAGGED_LIBRARY,
                 "other_shapes": [dict(r["bf16"], shape=r["shape"])
                                  for r in page_rows
                                  if r["bf16"]["variant"] == "runtime"
                                  and r is not rt]})
    token_launches = {v: runs["token"][1]["launches"][f"token_{v}"]
                      for v in rpa.TOKEN_VARIANTS}
    rows.append(token_row("ragged_token", 389, timed["token"],
                          token_launches,
                          worst_of(cerrs["token_variants"],
                                   dcerrs["token_variants"])))
    # the serving paths' B1 calls take the scalar kernel since C25 (the
    # rope's fp32 q and k; fp32 pages read back): timed on their captured
    # fp32 inputs; the tensor-core B1 at the training step, and on bf16
    # copies of the serving captures for comparison with earlier runs
    serving_flash = [time_flash(torch, fa, fc, name)
                     for name, fc in flash_caps.items()]
    train_rows = time_flash_train(torch, fa, tc)
    flash_rows = [train_rows["fwd"]] + [
        time_flash(torch, fa, {k: v.bfloat16() if k in ("q", "k", "v")
                               else v for k, v in fc.items()},
                   f"{name} (bf16 copies)")
        for name, fc in flash_caps.items()]
    simt_row = serving_flash[0]
    # the scalar B1 on the training step's inputs, where O1 and a bf16
    # model without AMP take it (3j(b), 3j(c): the rope's fp32 q and k
    # beside a 16-bit v)
    simt_train = time_flash(torch, fa, dict(
        {x: tc[x].float() for x in "qkv"}, causal=True,
        q_offset=tc["q_offset"]),
        "scalar B1 on the training step's inputs in fp32")
    paged_rows = [time_paged(torch, pa, decode_caps["static"],
                             "static engine decode step, fp32 pages"),
                  time_paged(torch, pa, decode_caps["legacy"],
                             "legacy engine decode step, fp32 pages")]
    for r in paged_rows:
        log_paged(r)
    for r in flash_rows + serving_flash + [simt_train]:
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"  {r['shape']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}: "
            f"{r['bytes']} bytes at 3.35 TB/s, {r['flops']} FLOPs at "
            f"{r['peak_tflops']:g} TFLOP/s), library {lib} ({r['library']})"
            + (f", max abs diff to the kernel "
               f"{r['library_vs_kernel_max_abs_diff']:.3e}"
               if r["library_ms"] is not None else "")
            + (f"; {r['tflops']:.1f} TFLOP/s over visible pairs, host "
               f"{r['host_us']:.1f} us a call, {r['ms_no_spin']:.4f} ms "
               f"timed without the spin" if "tflops" in r else ""))
    by_path = {"static": static["launches"], "legacy": legacy["launches"],
               "int8_legacy": int8_runs["legacy"][1]["launches"],
               "train": trained["launches"],
               "train_recompute": trained["recompute"],
               "train_eager": trained["eager"]["launches"],
               "train_amp_O2_fp16": amp_runs["O2 fp16"]["launches"],
               "train_amp_O1_fp16": amp_runs["O1 fp16"]["launches"],
               "train_bf16_no_amp": amp_runs["bf16 no AMP"]["launches"],
               "train_amp_checks_fused": amp_runs["checks"]["runs"]["fused"]
               ["launches"],
               "train_amp_checks_eager": amp_runs["checks"]["runs"]["eager"]
               ["launches"],
               **amp_paths(amp_srv)}
    # the paths whose flash calls take the scalar fp32 kernels: the
    # serving paths (C25) and 3j's O1 and bf16 model without AMP
    for name in ("static", "legacy", "int8_legacy", "train_amp_O1_fp16",
                 "train_bf16_no_amp"):
        simt_by_path[name] = by_path[name]["flash"]
    bwd_simt_by_path = {
        "fp32 training step": {"dq": bwd_simt_launches,
                               "dkv": bwd_simt_launches},
        **{name: {"dq": by_path[name]["flash_bwd_dq"],
                  "dkv": by_path[name]["flash_bwd_dkv"]}
           for name in ("train_amp_O1_fp16", "train_bf16_no_amp")}}
    timed_keys = ("ms", "ms_no_spin", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "library", "shape", "bytes", "flops",
                  "tflops", "host_us")
    b1 = {"source": CSRC + "flash_attention.cu", "route": "cuda",
          "replaces": "paddle_tpu/ops/pallas/flash_attention.py:110"}
    rows.append({"name": "flash_fwd_wgmma", **b1,
                 "kernel": "flash_fwd_wgmma_kernel",
                 "dtypes": "bf16 and fp16 at head_dim 64 and 128",
                 "launches": sum(v["flash_wgmma"] for v in by_path.values()),
                 "launches_by_path": {k: v["flash_wgmma"]
                                      for k, v in by_path.items()},
                 "max_abs_err": flash_errs["bf16"],
                 **{f"{key}_{dt}": flash_errs[f"{dt}{suffix}"]
                    for dt in ("bf16", "fp16")
                    for key, suffix in (("max_abs_err", ""),
                                        ("rule_ratio", "_rule"),
                                        ("model_ratio", "_tight"),
                                        ("model_ratio_no_slack",
                                         "_no_slack"),
                                        ("one_ulp_ratio", "_one_ulp"),
                                        ("sdpa_rule_ratio", "_sdpa_rule"),
                                        ("sdpa_model_ratio", "_sdpa_tight"),
                                        ("sdpa_one_ulp_ratio",
                                         "_sdpa_one_ulp"))},
                 **{f"max_rel_err_lse_{dt}": flash_errs[f"lse_{dt}"]
                    for dt in ("bf16", "fp16")},
                 **{k: flash_rows[0][k] for k in timed_keys},
                 "other_shapes": flash_rows[1:]})
    rows.append({"name": "flash_fwd_simt", **b1, "kernel": "flash_fwd_kernel",
                 "dtypes": "fp32 at head_dim 64, 128, 192 and 256; bf16 and "
                           "fp16 at 192 and 256",
                 "launches": sum(simt_by_path.values()),
                 "launches_by_path": simt_by_path,
                 "max_abs_err": flash_errs["fp32"],
                 "max_rel_err_lse": flash_errs["lse"],
                 **{k: simt_row[k] for k in timed_keys},
                 "other_shapes": serving_flash[1:] + [simt_train]})
    rows.append(paged_row("paged_decode", 55, paged_errs, paged_rows,
                          "paged", by_path))
    # B2 and B3, each as its two variants: the tensor-core kernels (bf16
    # and fp16 at head_dim 64, 128; the training step) and the scalar ones
    # (fp32; phase 4's training step)
    bwd = {"source": CSRC + "flash_attention_bwd.cu", "route": "cuda"}
    bwd_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library", "library_kernels", "shape", "bytes", "flops")
    for name, key, line, errs_of in (
            ("flash_bwd_dq", "dq", 232, ("dq",)),
            ("flash_bwd_dkv", "dkv", 277, ("dk", "dv"))):
        ref_at = f"paddle_tpu/ops/pallas/flash_attention.py:{line}"
        r, rs = train_rows[key], train_rows[f"{key}_simt"]
        rs["shape"] = r["shape"].replace("bf16", "fp32 copies")
        for row, variant in ((r, "tensor cores"), (rs, "scalar")):
            log(f"  {name} ({variant}) at {row['shape']}: {row['ms']:.4f} "
                f"ms" + (f" ({row['tflops']:.1f} TFLOP/s over visible "
                         f"pairs)" if "tflops" in row else "")
                + f", plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}: "
                f"{row['bytes']} bytes, {row['flops']} FLOPs at "
                f"{row['peak_tflops']:g} TFLOP/s), library "
                f"{row['library_ms']:.4f} ms ({row['library']}; kernels "
                f"{row['library_kernels']}; max abs diff to the kernels "
                f"{row['library_vs_kernel_max_abs_diff']})")
        wkey = f"flash_bwd_{key}_wgmma"
        rows.append({"name": f"{name}_wgmma", **bwd,
                     "replaces": ref_at,
                     "kernel": f"flash_bwd_{key}_wgmma_kernel",
                     "dtypes": "bf16 and fp16 at head_dim 64 and 128",
                     "launches": sum(v[wkey] for v in by_path.values()),
                     "launches_by_path": {k: v[wkey]
                                          for k, v in by_path.items()},
                     "max_abs_err": max(bwd_errs[f"{e}_bf16"]
                                        for e in errs_of),
                     **{f"{what}_{dt}": max(bwd_errs[f"{e}_{dt}{suffix}"]
                                            for e in errs_of)
                        for dt in ("bf16", "fp16")
                        for what, suffix in (("max_abs_err", ""),
                                             ("rule_ratio", "_rule"),
                                             ("model_ratio", "_tight"),
                                             ("model_ratio_no_slack",
                                              "_no_slack"),
                                             ("one_ulp_ratio", "_one_ulp"))},
                     "tflops": r["tflops"],
                     **{k: r[k] for k in bwd_keys}})
        rows.append({"name": f"{name}_simt", **bwd, "replaces": ref_at,
                     "kernel": f"flash_bwd_{key}_kernel",
                     "dtypes": "fp32 at head_dim 64, 128, 192 and 256; "
                               "bf16 and fp16 at 192 and 256",
                     "launches": sum(v[key]
                                     for v in bwd_simt_by_path.values()),
                     "launches_by_path": {k: v[key] for k, v in
                                          bwd_simt_by_path.items()},
                     "max_abs_err": max(bwd_errs[f"{e}_fp32_abs"]
                                        for e in errs_of),
                     "max_rel_err_fp32": max(bwd_errs[f"{e}_fp32"]
                                             for e in errs_of),
                     **{k: rs[k] for k in bwd_keys}})

    # the int8 kernels, on the inputs captured in phase 3(e)
    q8_kern = {"qblock": rpa.qblock_attention_q8,
               "token": rpa.token_attention_q8}
    timed = time_ragged(torch, rpa, q8_kern, plain, (
        ("captured int8 mixed tick", ic, q8_plans, q8_cerrs),
        ("captured int8 pure-decode tick", idc, q8_dplans, q8_dcerrs)),
        scale, quant=True)
    first, *other = timed["qblock"]
    q8_paths = {"3e int8 q-block engine": int8_runs["qblock"][1]["launches"],
                "3i spec on, draft model": spec["int8"]["draft model"]
                ["launches"],
                "4b page 8 int8": page_launches[8, "int8"],
                "4b page 64 int8": page_launches[64, "int8"],
                "3k O2 int8 q-block engine": amp_srv["int8"]["runs"]["qblock"]
                ["launches"]}
    rows.append({"name": "ragged_qblock_q8", "route": "cuda",
                 "source": QBLOCK_SOURCE, "replaces": f"{REF}:258",
                 "variant": "unit", "kernel": "qblock_unit_kernel",
                 "launches": int8_runs["qblock"][1]["launches"]["qblock_q8"],
                 "launches_by_path": {
                     k: {v: c.get(f"qblock_q8_{v}", 0)
                         for v in rpa.QBLOCK_VARIANTS}
                     for k, c in q8_paths.items()},
                 **first, "library_ms": None, "library": RAGGED_LIBRARY,
                 "other_shapes": other,
                 "page_shapes": [dict(r["int8"], shape=r["shape"])
                                 for r in page_rows]})
    rows.append({"name": "ragged_qblock_q8_runtime", "route": "cuda",
                 "source": QBLOCK_SOURCE, "replaces": f"{REF}:258",
                 "variant": "runtime", "kernel": "qblock_runtime_kernel",
                 "launches": page_launches[64, "int8"]["qblock_q8_runtime"],
                 **rt["int8"],
                 "shape": "phase 2(a) layout at page 64, head_dim 128, bf16 "
                          "q, int8 pages",
                 "library_ms": None, "library": RAGGED_LIBRARY,
                 "other_shapes": [dict(r["int8"], shape=r["shape"])
                                  for r in page_rows
                                  if r["int8"]["variant"] == "runtime"
                                  and r is not rt]})
    token_launches = {v: int8_runs["token"][1]["launches"][f"token_q8_{v}"]
                      for v in rpa.TOKEN_VARIANTS}
    rows.append(token_row("ragged_token_q8", 431, timed["token"],
                          token_launches,
                          worst_of(q8_cerrs["token_variants"],
                                   q8_dcerrs["token_variants"])))
    r = time_paged(torch, pa, dc, "int8 legacy engine decode step, fp32 q, "
                                  "int8 pages")
    log_paged(r)
    rows.append(paged_row("paged_decode_q8", 97, paged_q8_errs, [r],
                          "paged_q8", by_path))
    rows += mixed_rows(amp_srv)
    mm_rows = {key: time_int8_matmul(torch, qm, mc, "layer 0" if key[1]
                                     != cfg.vocab_size else "lm_head")
               for key, mc in sorted(mm_cap.best.items())}
    for r in mm_rows.values():
        rate = (f"{r['gb_per_s']:.1f} GB/s" if "gb_per_s" in r
                else f"{r['tflops']:.1f} TFLOP/s")
        f32 = r["fp32"]
        log(f"  int8_matmul at {r['shape']}: {r['variant']} {r['plan']}, "
            f"{r['ms']:.4f} ms ({rate}), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}: {r['bytes']} "
            f"bytes, {r['flops']} FLOPs), library {r['library_ms']:.4f} ms "
            f"({r['library']}; max abs diff "
            f"{r['library_vs_kernel_max_abs_diff']:.3e}); host per call "
            f"{r['host_us']:.1f} us, torch.matmul {r['library_host_us']:.1f}"
            f" us; on fp32 x: {f32['variant']} {f32['plan']} "
            f"{f32['ms']:.4f} ms, plain {f32['plain_ms']:.4f} ms, bound "
            f"{f32['bound_ms']:.6f} ms ({f32['bound_by']}), fp32 library "
            f"{f32['library_ms']:.4f} ms, scalar kernel {f32['simt_ms']:.4f}"
            f" ms")
    # one forward's B10 calls at M = 8 and 256: layer 0's q, k and v on
    # their captured bf16 inputs, every other call (o, gate, up, down of
    # every layer, q, k, v after layer 0, lm_head) in fp32 (C25), on the
    # fp32 variants and, for the record, on the scalar kernel
    per_layer = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2,
                 (14336, 4096): 1}
    bf16_calls = {(4096, 4096): 1, (4096, 1024): 2}
    b10_forward = {}
    for m in (8, 256):
        for key in ("ms", "simt_ms"):
            def fp32_ms(k, n):
                return mm_rows[(k, n, m)]["fp32"][key]
            total = fp32_ms(4096, cfg.vocab_size) + sum(
                c * (mm_rows[(k, n, m)]["ms"]
                     + (N_LAYERS - 1) * fp32_ms(k, n))
                for (k, n), c in bf16_calls.items()) + N_LAYERS * sum(
                (c - bf16_calls.get((k, n), 0)) * fp32_ms(k, n)
                for (k, n), c in per_layer.items())
            kind = "variants" if key == "ms" else "scalar"
            b10_forward[f"M={m} fp32 {kind}"] = total
    log(f"  B10 over one forward (225 calls: 3 tensor-core, 222 fp32): "
        f"{b10_forward} ms")
    for (k, n), by_m in time_crossover(torch, qm, mm_cap.best).items():
        log(f"  B10 crossover K={k} N={n}: " + ", ".join(
            f"M={m} " + "/".join(f"{v} {t:.4f}" for v, t in ts.items())
            for m, ts in by_m.items()) + " ms")
    for (k, n), by_m in time_crossover(torch, qm, mm_cap.best,
                                       (48, 64, 80, 96),
                                       FP32_VARIANTS).items():
        log(f"  B10 fp32 crossover K={k} N={n}: " + ", ".join(
            f"M={m} " + "/".join(f"{v} {t:.4f}" for v, t in ts.items())
            for m, ts in by_m.items()) + " ms")
    for (k, n), by_sms in time_split_plan(torch, qm, mm_cap.best).items():
        log(f"  B10 split plan K={k} N={n} M=8: " + ", ".join(
            f"PLAN_SMS {s}: {parts} parts {t:.4f} ms"
            for s, (parts, t) in by_sms.items()))
    mm_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "library", "shape", "bytes", "flops")
    b10 = {"route": "cuda", "source": CSRC + "quant_matmul.cu",
           "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:65"}
    # the tensor-core variants' paths: 3e's engines (layer 0's q, k, v)
    # and 3k's under O2 (every call)
    b10_paths = {**{k: st["launches"] for k, (_, st) in int8_runs.items()},
                 **{f"3k O2 int8 {k}": v["launches"]
                    for k, v in amp_srv["int8"]["runs"].items()}}
    # the tensor-core variants on layer 0's q_proj inputs (bf16: the only
    # Linears that see bf16 x since C25 are layer 0's q, k and v)
    for variant, key, first_key, dtypes in (
            ("wgmma_stream", "int8_matmul_stream", (4096, 4096, 8),
             f"bf16 and fp16 at M <= {qm.STREAM_MAX_M}, K % 16 == 0"),
            ("wgmma_gemm", "int8_matmul_gemm", (4096, 4096, 256),
             f"bf16 and fp16 at M > {qm.STREAM_MAX_M}, K % 16 == 0")):
        first = mm_rows[first_key]
        rows.append({"name": f"int8_matmul_{variant}", **b10,
                     "kernel": "int8_matmul_wgmma_kernel (+ "
                               "int8_matmul_reduce_kernel where K is split)",
                     "dtypes": dtypes,
                     "launches": sum(c[key] for c in b10_paths.values()),
                     "launches_by_path": {k: c[key]
                                          for k, c in b10_paths.items()},
                     "calls_by_m": {k: dict(sorted(h.items()))
                                    for k, h in mm_hist.items()},
                     "max_abs_err": mm_errs["bf16"],
                     "max_abs_err_fp16": mm_errs["fp16"],
                     "c20_ratio_bf16": mm_errs["bf16_ratio"],
                     "c20_ratio_fp16": mm_errs["fp16_ratio"],
                     "c20_ratio_by_shape": mm_errs["ratio_by_shape"],
                     **{k: first[k] for k in mm_keys + (
                         "variant", "plan", "gb_per_s", "tflops")
                        if k in first},
                     "other_shapes": [r for key2, r in mm_rows.items()
                                      if r["variant"] == variant
                                      and key2 != first_key]})
    # the fp32 variants: every serving Linear after layer 0's q, k and v
    # (C25) and phase 4's fp32 int8 cross paths; on layer 0's captured
    # gate/up inputs (fp32), at M = 8 and 256 by the rule, the other
    # shapes beside
    fp32_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library", "bytes", "flops", "variant", "plan", "simt_ms")
    for variant, m in (("fp32_stream", 8), ("fp32_gemm", 256)):
        first = mm_rows[(4096, 14336, m)]
        rows.append({"name": f"int8_matmul_{variant}", **b10,
                     "kernel": f"int8_matmul_{variant}_kernel (+ "
                               "int8_matmul_reduce_kernel where K is split)",
                     "dtypes": f"fp32 at M {'<=' if m == 8 else '>'} "
                               f"{qm.FP32_STREAM_MAX_M}, K % 16 == 0",
                     "launches": sum(v[variant] for v in b10_fp32.values()),
                     "launches_by_path": {k: v[variant]
                                          for k, v in b10_fp32.items()},
                     "max_abs_err": mm_errs[f"{variant}_abs"],
                     "max_rel_err": mm_errs[variant],
                     "shape": f"layer 0 gate/up: M={m} K=4096 N=14336, fp32 "
                              f"x, int8 w",
                     **{k: first["fp32"][k] for k in fp32_keys},
                     "forward_ms": b10_forward,
                     "other_shapes": [dict(r["fp32"], shape=r["shape"])
                                      for key, r in mm_rows.items()
                                      if r["fp32"]["variant"] == variant
                                      and key != (4096, 14336, m)]})
    # the scalar kernel: K % 16 != 0 in every dtype (none on the main
    # path, whose K are 4096 and 14336); timed on the gate/up decode
    # inputs in fp32, the calls it took before the fp32 variants
    simt = mm_rows[(4096, 14336, 8)]["fp32"]
    rows.append({"name": "int8_matmul_simt", **b10,
                 "kernel": "int8_matmul_kernel",
                 "dtypes": "fp32, bf16 and fp16 at K % 16 != 0",
                 "launches": 0, "on_main_path": False,
                 "max_abs_err": mm_errs["simt_abs"],
                 "max_rel_err": mm_errs["simt"],
                 "shape": "layer 0 gate/up: M=8 K=4096 N=14336, fp32 x, "
                          "int8 w (timed for the record)",
                 "ms": simt["simt_ms"],
                 **{k: simt[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library", "bytes",
                                         "flops")}})

    # the fused optimizer step's kernels (no Pallas counterpart), timed
    # over the training step's whole state in phase 3d
    opt_src = CSRC + "optimizer_step.cu"
    for name, key, counter, ref_at, kernels in (
            ("adam_step_multi_tensor", "adam", "adam_step",
             "paddle_tpu/optimizer/fused.py:65", "adam_step_kernel"),
            ("sum_squares_multi_tensor", "sumsq", "sum_squares",
             "paddle_tpu/nn/clip_grad.py:52",
             "sumsq_partial_kernel + sumsq_finish_kernel")):
        r = trained["optimizer_rows"][key]
        rows.append({"name": name, "route": "cuda", "source": opt_src,
                     "replaces": ref_at, "pallas": False, "kernel": kernels,
                     "launches": sum(v[counter] for v in by_path.values()),
                     "launches_by_path": {k: v[counter]
                                          for k, v in by_path.items()},
                     **r, "shape": f"the training step's {r['elements']} "
                                   f"parameters, bf16 with fp32 masters"})

    tick_breakdown(torch, rpa, gen, probes, scale, N_LAYERS)
    for impl in rpa.IMPLS:
        st = runs[impl][1]
        gen_tokens = NEW_TOKENS * len(prompts)
        log(f"  serving[{impl}]: tick {st['wall'] / st['steps'] * 1e3:.2f} ms"
            f" ({st['steps']} ticks), {gen_tokens / st['wall']:.1f} "
            f"generated tokens/s, {st['useful']} useful / {st['padded']} "
            f"padded tokens over the engine's life")
    decode_ms = [ms for n, ms in static_fwd.times if n == 1]
    log(f"  serving[static]: {NEW_TOKENS * len(static_prompts) / static['wall']:.1f}"
        f" generated tokens/s ({static['wall']:.3f} s for the batch); "
        f"instrumented: prefill forward "
        f"{[ms for n, ms in static_fwd.times if n > 1][0]:.2f} ms, decode "
        f"step median {np.median(decode_ms):.2f} ms over {len(decode_ms)}")
    for name, (_, st) in int8_runs.items():
        native = legacy if name == "legacy" else runs[name][1]
        log(f"  serving[int8 {name}]: tick {st['wall'] / st['steps'] * 1e3:.2f}"
            f" ms ({st['steps']} ticks), "
            f"{NEW_TOKENS * len(prompts) / st['wall']:.1f} generated tokens/s"
            f"; native bf16 {native['wall'] / native['steps'] * 1e3:.2f} ms, "
            f"{NEW_TOKENS * len(prompts) / native['wall']:.1f} tokens/s")
    int8_ticks = int8_probe.summary()
    log(f"  serving[int8 qblock] instrumented: forward "
        f"{sum(t['fwd_ms'] for t in int8_ticks):.1f} ms over "
        f"{len(int8_ticks)} ticks, attention (B7) "
        f"{sum(t['attn_ms'] for t in int8_ticks):.1f} ms of it; int8 "
        f"legacy instrumented tick mean {np.mean(int8_legacy_ticks):.2f} ms, "
        f"median {np.median(int8_legacy_ticks):.2f} ms")
    log(f"  serving[legacy]: tick {legacy['wall'] / legacy['steps'] * 1e3:.2f}"
        f" ms ({legacy['steps']} working ticks), "
        f"{NEW_TOKENS * len(prompts) / legacy['wall']:.1f} generated "
        f"tokens/s, {legacy['useful']} useful / {legacy['padded']} padded "
        f"tokens over the engine's life; instrumented (a device sync per "
        f"tick): tick mean {np.mean(legacy_ticks):.2f} ms, median "
        f"{np.median(legacy_ticks):.2f} ms over {len(legacy_ticks)}")

    log(json.dumps({"graph_breakdown": {"bf16": graph_bf16,
                                        "int8": graph_int8}}))
    log(json.dumps({"spec": spec}))
    med, emed = trained["median"], trained["eager"]["median"]
    log(f"  training (O2 bf16: decorate + auto_cast): losses "
        f"{trained['losses']}; steady step "
        f"{med['step']:.2f} ms (forward {med['forward']:.2f}, backward "
        f"{med['backward']:.2f}, optimizer {med['optimizer']:.2f}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / med['step'] * 1e3:.1f} tokens/s, peak "
        f"memory {trained['memory']['peak'] / 2**30:.2f} GiB; eager "
        f"optimizer: step {emed['step']:.2f} ms, optimizer "
        f"{emed['optimizer']:.2f} ms, peak "
        f"{trained['eager']['memory']['peak'] / 2**30:.2f} GiB; fused vs "
        f"eager: losses {trained['fused_vs_eager']['loss_rel']:.3e}, "
        f"masters {trained['fused_vs_eager']['master_rel']:.3e} (relative)"
        f"; recompute step "
        f"{trained['recompute_ms']['step']:.2f} ms; fp32 2-layer gradients "
        f"within {train_grad_err:.3e} of dense attention")
    amp_line = {}
    for name in ("O2 fp16", "O1 fp16", "bf16 no AMP"):
        st = amp_runs[name]["steps"]
        timed = st[1:] or st
        med = {k: float(np.median([r["ms"][k] for r in timed]))
               for k in timed[0]["ms"]}
        amp_line[name] = dict(
            losses=[r["loss"] for r in st],
            skipped=[i for i, r in enumerate(st) if r.get("skipped")],
            scales=[r.get("scale") for r in st], step_ms=med,
            peak_gib=max(max(r["peak"].values()) for r in st) / 2**30,
            flash_kernels="scalar fp32" if name != "O2 fp16"
            else "tensor cores")
        log(f"  amp[{name}]: median step {med['step']:.2f} ms (forward "
            f"{med['forward']:.2f}, backward {med['backward']:.2f}, "
            f"optimizer {med['optimizer']:.2f}), peak "
            f"{amp_line[name]['peak_gib']:.2f} GiB, skipped steps "
            f"{amp_line[name]['skipped']}, scales {amp_line[name]['scales']}")
    ck = amp_runs["checks"]
    amp_line["checks"] = dict(
        traces=amp_runs["traces"], planted=ck["planted"],
        skipped={k: [i for i, r in enumerate(v["steps"]) if r["skipped"]]
                 for k, v in ck["runs"].items()},
        fused_vs_eager_loss_rel=ck["loss_rel"],
        fused_vs_eager_master_rel=ck["master_rel"],
        masters_bit_equal=ck["masters_equal"])
    log(json.dumps({"amp": amp_line}))
    log(json.dumps({"amp_serving": amp_serving_line(amp_srv, runs, static,
                                                    legacy, prompts,
                                                    static_prompts)}))
    return rows


#: the phases after the build that a run may select, in the order they
#: run; 2 to 6 share one Llama-3-8B, its runs and its captures, so they
#: run as one unit
PHASES = ("2-6", "7", "8", "9", "10", "11", "12", "13", "14")


def selected_phases(argv):
    """The phases to run after the build: all of them with no arguments;
    with ``--phases 7,11`` only those (PHASES' names; 2 to 6 each name
    the unit "2-6"), for a development run, which ends on a
    ``{"partial": ...}`` line instead of the result line."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Smoke run of the port on one GPU (see the module's "
                    "docstring).")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after the "
                             f"build, of {', '.join(PHASES)} (default: "
                             f"all)")
    names = parser.parse_args(argv).phases.split(",")
    unit = {str(n): "2-6" for n in range(2, 7)}
    chosen = {unit.get(n.strip(), n.strip()) for n in names}
    if chosen - set(PHASES):
        parser.error(f"unknown phases {sorted(chosen - set(PHASES))}")
    return [n for n in PHASES if n in chosen]


def main(argv=None):
    run = selected_phases(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import generation as gen
    # SDPA (``nn/functional/common.py``) looks up ``flash_attention`` in
    # its own module: the flash captures wrap it there
    from paddle_tpu_torch.nn.functional import common as nn_functional
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.ops import optimizer_step as ost
    from paddle_tpu_torch import quantization as quant_mod
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import ring_attention as ra

    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}")
    kern = kernel_counters(rpa, fa, pa, qm, ost)
    none = {name: 0 for name in kern}

    phase("phase 1: build")
    _, build_s = _build.build()
    _build.load_kernels()
    log(f"  build_seconds {build_s:.2f} ({len(_build.SOURCES)} sources)")
    ptxas_summary(_build)
    qblock_notes(_build, rpa)
    token_notes(_build, rpa)
    paged_notes(_build, pa)
    b1_notes(_build)
    bwd_notes(_build)
    b10_notes(_build)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    rows = None
    if "2-6" in run:
        rows = llama_phases(torch, pt, amp, gen, nn_functional, fa, fused,
                            ost, quant_mod, pa, qm, rpa, kern, none)
    if "7" in run:
        phase("phase 7: the ops layer on the card: creation and random "
              "ops, and a sample of the five op modules against the CPU")
        log(json.dumps({"ops": ops_phase(torch, pt)}))
    if "8" in run:
        phase("phase 8: the nn surface (the functional case table against "
              "the CPU) and PaddleClas ResNet-50 on CIFAR-10-sized images")
        log(json.dumps({"nn": nn_phase(torch, pt, kern,
                                       smi.stdout.strip())}))
    if "9" in run:
        phase("phase 9: the training-loop surface: a compiled "
              "Llama-3-8B-width step on paddle.io batches, and ResNet-50 "
              f"({HAPI_BLOCKS} blocks a stage) through paddle.Model.fit")
        loop = loop_phase(torch, pt, kern, none, smi.stdout.strip())
        if rows is not None:
            add_compiled_launches(rows, loop)
        log(json.dumps({"loop": loop}))
    if "10" in run:
        phase("phase 10: long context (sep prefill in stripes over B1), "
              "the host KV tier and the handoff, quantization (PTQ, QAT)")
        prompts, warm = make_prompts()
        p10 = phase10(torch, pt, amp, fa, ra, gen, kern, prompts, warm)
        if rows is not None:
            add_sep_launches(rows, p10)
        gc.collect()
        torch.cuda.empty_cache()
    if "11" in run:
        phase("phase 11: the language-model zoo: GPT-3-1.3B, Mixtral-8x7B "
              "widths, BERT-base and T5 on the ported kernels")
        zoo = zoo_phase(torch, pt, amp, fa, pa, rpa, gen, nn_functional,
                        kern)
        if rows is not None:
            add_zoo_launches(rows, zoo)
        log(json.dumps({"zoo": zoo}, default=str))
    if "12" in run:
        phase("phase 12: the vision zoo, PP-YOLOE and the RNNs: ViT-B/16 "
              "on B1-B3, PP-YOLOE at 640 through DataLoader workers, the "
              "conv zoo, LSTM/GRU/SimpleRNN and the vision ops")
        vis = vision_phase(torch, pt, amp, fa, pa, rpa, kern,
                           smi.stdout.strip())
        if rows is not None:
            add_vision_launches(rows, vis)
        log(json.dumps({"vision": vis}, default=str))
        gc.collect()
        torch.cuda.empty_cache()
    if "13" in run:
        phase("phase 13: Hugging Face checkpoints loaded and served, the "
              "audio features and fft, CIFAR-10 through the data pipeline, "
              "Viterbi decoding")
        p13 = pretrained_phase(torch, pt, amp, fa, pa, rpa, gen,
                               nn_functional, kern, smi.stdout.strip())
        if rows is not None:
            add_pretrained_launches(rows, p13)
        log(json.dumps({"pretrained": p13}, default=str))
        gc.collect()
        torch.cuda.empty_cache()
    if "14" in run:
        phase("phase 14: geometric, sparse and distribution: GCN on an "
              "ogbn-arxiv-sized graph, BigBird-pattern sparse attention, "
              "SECOND's sparse convolutions, the distributions")
        log(json.dumps({"graph_sparse_distribution": phase14(
            torch, pt, smi.stdout.strip())}, default=str))
    if rows is not None:
        log(json.dumps({"kernels": rows}))
    log(smi.stdout.strip())
    if run != list(PHASES):
        # a development run: no result line
        print(json.dumps({"partial": {"phases": run, "passed": True}}),
              flush=True)
        return 0
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
