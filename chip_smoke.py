#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phase slice | serve_swa | moe_kernels |
                           train_moe | serve_moe | ssm_kernels |
                           train_ssm | serve_ssm | hybrid | vlm | audio |
                           train_kernels | autotune | train_cli]

With ``--phase`` it runs the build and that phase alone and prints no ok
line.  Phases, each printing one line (a failed phase raises: no ok line, exit
code 1):

1. build   — nvcc builds the five CUDA kernels of
   ``src/repro_torch/kernels/csrc`` for sm_90a, all at once.  For
   ``qmm_stream``, ``tiled_mm`` and ``flash_attention`` it counts the
   HGMMA instructions in ``cuobjdump -sass`` (gate: > 0, the products run
   on wgmma) and reads registers and spills of their tensor-core kernels
   from ptxas, one entry per instantiation (trans flags, SR / stats, and
   the (bm, bn) tiling: 128 x 128, 128 x 256, 256 x 128) (gate: no
   spill, no serialized wgmma).
2. kernels — each kernel against its plain PyTorch version on the card,
   bf16, with CUDA-event times (L2 flushed before every launch) beside
   the plain version, the bound and ``torch.matmul`` / SDPA on the same
   inputs.  Serving shapes (M in {8, 16, 128, 512}, (K, N) in {(768, 768),
   (768, 3072), (3072, 768)}) and, in a second line (``train_kernels``),
   the training step's shapes at 8192 tokens: the FFN forward, its dgrad
   (w read transposed, pass x pass) and wgrad (x read transposed, K =
   8192, fp8 blocks), the attention linears' two-pass route forward,
   dgrad and wgrad (token modes, both trans flags), and flash attention
   at (96, 1024, 64) and (48, 1024, 128), causal, and non-causal (an
   encoder's) at (64, 1536, 64) (whisper-base's 8 heads x batch 8, its
   1500 frames rounded up to a multiple of 128) and (48, 1024, 128),
   SDPA's time beside each (``is_causal`` as the row); and llama3.2-3b's
   (phase 8a) at the same 8192 tokens: the FFN forward 3072 -> 8192, the
   wq (3072 -> 3072) and wk (-> 1024, wv's shape) forwards, flash at
   (96, 2048, 128) causal.  QDQ panels
   bitwise, GEMM outputs within one bf16 ulp (+1e-5 max|y|), the stream
   kernel bitwise against quantize_rows + tiled_mm in the same layout,
   attention within
   one bf16 ulp + 1e-5 (and, at D = 128 on the card tests' inputs, the
   tensor-core kernel within the same bar of an f64 softmax, beside the
   plain version and the reference's own f32 score order: the
   ``flash_precision_d128`` record).  Each ``quantize_rows`` row gives
   the blocks of its kernels from a profiler trace (gate: more than the
   card's 132 SMs at 8192 x 768); each flash row its route, TFLOP/s and
   share of bound.
   Each ``qmm_stream`` / ``tiled_mm`` row names the route its launch took
   (``tensor_core`` for bf16 with M > 16, else ``fma``), its TFLOP/s and
   its share of the bound; rows 0-16 of the FFN forward and of the
   attention forward ``tiled_mm`` at M = 8192 must equal the same calls on
   the first 17 and the first 128 rows bit for bit.
3. slice   — serves gpt2-125m at full width (12 layers, d 768, d_ff 3072,
   vocab 50257; seeded init) through the packed-FP4 ``ContinuousBatcher``
   (fp8 KV, paper_fp4, linear_impl "pallas", ``jit=True``: every stage a
   captured CUDA graph): 8 slots, max_len 1024, 16 requests with prompt
   lengths drawn with seed 0 in [16, 512] and 64 new tokens each, after
   an untimed warm-up that captures each stage and each prompt bucket.
   Prints the captures and replays per stage (gate: the timed run
   captures nothing) and launches per kernel under replay (gate: every
   GEMM kernel launched).  The eager engine (``jit=False``) serves the
   first 4 requests again: its tokens must equal the captured engine's,
   and its decode p50 is printed beside the captured one.  Checks 2
   requests token-exact against the sequential ``generate`` (captured),
   and one request's teacher-forced forward on the card
   against the same port on the CPU, in f32 and bf16: every linear and
   attention call replayed on the CPU on the card's inputs, and the bf16
   logits end to end beside a control that must miss (see OP_BOUND).  A
   ``profile`` line splits 5 batched decode steps by kernel from a
   ``torch.profiler`` trace.
3b. serve_swa — serves h2o-danube-3-4b at full width and a third of its
   depth (8 of its 24 layers, SWA_LAYERS: cut to 12 so that the whole
   run stays near half its time limit with the MoE phases, then to 8 to
   make room for ``train_cli``; d 3840, 32 heads and
   8 KV heads of 120, d_ff 10240, vocab 32000, sliding window 4096;
   seeded init drawn on the card) through the packed-FP4
   ``ContinuousBatcher`` (fp8 KV, paper_fp4, linear_impl "pallas",
   captured insert and decode step, exact-length eager prefill): 4
   slots, max_len 8192 (a ring of 4096 positions a layer), 8 requests
   with prompt lengths drawn with seed 0 in [3840, 4096] and 384 new
   tokens each, so every request decodes past the window.  Prints the
   decode p50, each exact-length prefill, tokens/s, peak memory, packed
   bytes a parameter, the KV cache's bytes at max_len 4096 and 8192
   (gate: equal, and equal to the cache the engine holds) and launches
   per kernel.  Gates: every request served in full; request 0 token-
   exact against the sequential ``generate``; a kernel replay: every
   ``quantize_rows``, ``tiled_mm`` and ``qmm_stream`` call of the first
   and the last layer in one exact-length prefill (M = request 0's
   prompt) and one batched decode step (M = 4) of an eager engine,
   again through the plain versions on the card on the same inputs
   (quantize passes bitwise, products within OP_BOUND: K 3840 and
   10240, the ragged N = 960 of wk / wv, both routes), beside a
   control that must miss (layer 0's first FFN product with its
   activation unquantized); the ring check: request 0's tokens
   teacher-forced past the window through an f32 engine (bf16 recipe,
   packed weights, bf16 KV) within RING_BOUND of the windowed no-cache
   forward, and the forward with no window (the control) beyond it.
   A ``serve_swa_profile`` line splits 5 batched decode steps by
   kernel.
4. train   — trains gpt2-125m at full width and depth (seeded init,
   ``SyntheticLM``, global batch 8 x 1024, 8 steps, paper_fp4, linear and
   attention impl "pallas", ``remat=False``: every activation kept; the
   §3.3 switch to bf16 at step 7) through ``Trainer``, with a checkpoint
   every 4 steps.  Prints per-step loss and plan, the step-time p50 over
   the steps after the first, tokens/s, peak memory and each kernel's
   launches per step (transposed and tensor-core launches apart), then a
   ``train_profile`` line splitting one paper_fp4 step by kernel.  Gates:
   finite losses with step 6 below step 0; every kernel launched (the
   three GEMM kernels also in a transposed layout); every ``qmm_stream``,
   ``tiled_mm`` and ``flash_attention`` launch on the tensor-core route
   (bf16 throughout); an op replay of step
   0 — every fwd, dgrad and wgrad matmul and every flash call of layers 0
   and 11 again on the CPU on the card's own inputs, quantized operands
   bitwise and outputs within OP_BOUND — and a control (layer 0's wq
   dgrad replayed with trans_b off) that must miss it.  A
   ``train_resume`` line: a second ``Trainer`` resumes from the step-4
   checkpoint and runs steps 4-7 across the switch; gate: its per-step
   losses, grad norms and plans and its final parameters and AdamW
   moments equal the uninterrupted run's bit for bit (save and restore
   times printed).
5. train_telemetry — the instrumented training step: gpt2-125m at full
   width and depth (seeded init, ``SyntheticLM``, 8 x 1024 tokens, 4
   steps), ``fine_grained_fp4`` (its FFN wgrad gradient operand rounds
   stochastically in ``qmm_stream``), both impls "pallas",
   ``telemetry=True`` every step with a JSONL log in a temporary
   directory, ``profiler_warmup=1``.  Prints per-step loss and plan, step
   p50 and tokens/s beside the same recipe with telemetry off and the
   paper_fp4 step of phase 4, peak memory and launches per kernel per
   step (SR, stats and tensor-core launches apart).  Gates: finite
   losses; every ``qmm_stream``, ``tiled_mm`` and ``flash_attention``
   launch on the tensor-core route; every stats
   key of the reference's schema present and finite for all 12 layers and
   the head, with 4 / 2 taps per layer; one JSONL row per step; an op
   replay of step 0 for layers 0 and 11 (every fwd, dgrad and wgrad call,
   the SR wgrad included: quantized operands bitwise with their SR seeds,
   outputs within OP_BOUND, the forward stats vectors to STATS_RTOL) and a
   control (layer 0's SR wgrad replayed with salt 5 for 4) that must miss.
   Two ``train_telemetry_profile`` lines split one step of the recipe
   without and with telemetry by kernel.
6. speed_factors — the card's cost calibration (the reference's
   ``measure_speed_factors``): every distinct operand-spec pair of the
   fwd, dgrad and wgrad matmuls of bf16, fp8, paper_fp4 and
   fine_grained_fp4 (keyed by ``cost_model._cal_key``), timed through the
   route the trainer takes under ``linear_impl="pallas"`` at the FFN
   forward shape 8192 x 768 x 3072 (bf16, nn layout, L2 flushed) and
   divided into ``torch.matmul``'s time at that shape.  Prints each
   pair's time, factor, route and paper factor, and the paper and the
   calibrated cost of gpt2-125m's uniform paper_fp4, first_last_k and
   bf16 plans; writes the ``speed_factors.v1`` JSON to a temporary
   directory.  Gates: every factor finite and > 0, the JSON read back to
   the same table.
7. train_adaptive — gpt2-125m at full width and depth (seeded init,
   ``SyntheticLM``, 8 x 1024 tokens, paper_fp4, both impls "pallas",
   ``remat=False``, telemetry every step with a JSONL log) for 12 steps
   (the §3.3 switch at 11) under the adaptive controller (plan search
   every 2 steps, at most 3 edits, priced by phase 6's JSON through
   ``TrainConfig.cost_calibration``; spike factor 2, replay 2 steps, LR
   backoff 0.5 recovering over 4 steps), a checkpoint every 3 steps.
   After step 6 a rollback is injected as the reference's tests inject
   it: the restore goes back to step 6, steps 6-7 replay at bf16 with
   the LR halved, steps 8-10 run the searcher-edited FP4 plan, step 11
   bf16.  Each step runs under ``routing.capture()``.  Prints per step
   the loss, plan, lr, controller events, the census's FFN route per
   layer, launches per kernel and the controller's host time; the
   searcher's edits and frontier with paper and calibrated cost; restore
   seconds, step p50, peak memory.  Gates: each step ran the plan the
   controller chose and its census (fwd, dgrad and wgrad events for all
   12 layers; fwd ``dot`` events for a bf16 plan) has the plan's spec
   strings, kernel modes and ``resolve_pipeline`` for every event; at
   least one FFN promote, the promoted cell's forward on the fp8
   two-pass route (quantize_rows + tiled_mm) in every later quantized
   step, qmm_stream launched less and tiled_mm more there than in step
   0; every frontier point's cost equal to ``plan_cost`` recomputed, the
   frontier monotone; the restored params and AdamW moments equal a host
   copy of the step-6 checkpoint bit for bit; steps 6-7 on bf16, step
   6's lr the scheduled f32 LR times f32(0.5) and the later ones the
   reference's recovery rule; every GEMM and flash launch on the
   tensor-core route; an op replay of step 8 (a promoted layer and an
   FP4 layer, control: the FP4 layer's wq dgrad without trans_b); a
   fresh ``Trainer`` resumed from the step-9 checkpoint equals steps
   9-11 bit for bit (rows, final params and moments, controller state).
   A ``train_adaptive_profile`` line splits one step of the
   searcher-edited plan, telemetry on, by kernel.
8. train_large — trains llama-1b at full published width and depth (48
   layers, d 1280, 20 heads of 64, d_ff 3392, vocab 32000, rope, swiglu,
   rmsnorm, untied head; seeded init), ``SyntheticLM`` (seed 0), global
   batch 4 x 2048, paper_fp4 under the ``first_last_k`` plan (k = 2:
   layers 0, 1, 46, 47 on the protected FP8 row), both impls "pallas",
   ``remat=True`` / "full", AdamW, 7 steps with the §3.3 switch on the
   last.  Prints per-step loss and plan, step p50 after the first,
   tokens/s, peak memory per step and launches per kernel per step
   (recompute launches apart), then a ``train_large_profile`` line.
   Gates: finite losses, step 5 below step 0; every ``qmm_stream``,
   ``tiled_mm`` and ``flash_attention`` launch on the tensor-core route,
   each also in a recompute; each step's plan (read from the plan the
   step ran) FP8 in the protected layers, FP4 elsewhere, bf16 after the
   switch; an op replay of step 0's layers 0 (FP8) and 24 (FP4), as in
   phase 4, with its control.
8a0. autotune — the tuning table (``kernels/autotune.py``) on the card,
   within AUTOTUNE_BUDGET_S (45 s; its seconds printed): the committed
   ``src/repro_torch/kernels/tuning_table.json`` validated (gate: no
   error, every entry a tiling the kernels are built for); two keys of
   llama3.2-3b's training step (AUTOTUNE_JOBS: the FFN forward 8192 x
   3072 -> 8192, block:tile nn; the FFN wgrad 3072 x 8192 x 8192, fp8
   block:block tn, SR on its gradient operand, stats) swept again into a
   temporary table, each candidate's time printed beside the committed
   winner (timing noise makes equality no gate; gate: the key is in the
   committed table); at each built tiling both calls bitwise equal to
   128 x 128, values and stats lanes; gpt2-125m (8 x 1024, paper_fp4,
   both impls "pallas") trained AUTOTUNE_STEPS steps on an empty table
   and on the committed one: losses, gradient norms and the parameters
   after the last step bitwise equal (gate), each run's step p50, table
   hits and misses (gate: no miss on the committed table) and
   ``qmm_stream``'s launches by tiling printed.
8a. train_cli — the training CLI, ``repro_torch.launch.train.main``,
   called in process (CLI_ARGV): llama3.2-3b at full published width and
   depth (28 layers, d 3072, 24 query and 8 KV heads of 128, d_ff 8192,
   vocab 128256, tied embeddings; 3,212,749,824 parameters drawn on the
   card), ``--recipe paper_fp4 --linear-impl pallas --attention-impl
   pallas --batch 4 --seq 2048``, 5 AdamW steps (all before the §3.3
   switch), remat "full" as the config has it.  Prints the CLI's lines
   (per-step log, ``eval:``, ``step-time:``, ``roofline[...]``), then
   one line: losses, step times, the CLI's step-time summary and
   roofline terms, peak memory per step and launches per kernel per
   step, the tuning table's hits and misses over the run (``fused_qmm``
   consults the committed table, as the reference's does) and the
   GEMM kernels' launches by tiling, then a ``train_cli_profile`` line
   splitting one more step by kernel.  Gates: the model at full size;
   finite losses; no key of the run missed the table; every GEMM
   kernel and flash launched, each also in a recompute, every one on
   the tensor-core route; flash at (96, 2048, 128); the CLI's eval,
   step-time and roofline lines; step 0's calls of layers 0 and 27
   (fwd, dgrad, wgrad of the seven projections, flash; copied to the
   host as they run) replayed through the plain versions on the card
   (d 3072 x 8192-token products would take minutes on the CPU) within
   OP_BOUND, with a control (layer 0's wq dgrad with its transposes
   off) that must miss it.  Then the qlint CLI (QLINT_ARGV: tiny,
   fine_grained_fp4, pallas, with the decode step) on the card against
   ``tests/qlint_expected_tiny_torch.json``: exit code 0, no violation,
   no fallback, no drift, and under each pallas role a port kernel in
   the profiler trace (the trace's kernels matched to the markers' calls
   in launch order; calls not found are counted on the line).
8b. train_moe — trains olmoe-1b-7b at full published width and depth
   (16 layers, d 2048, 16 heads of 128, 64 experts of d_ff 1024, top-8,
   router groups of 1024, vocab 50304; 6,919,096,320 parameters drawn
   on the card), ``SyntheticLM`` (seed 0), 4 x 2048 tokens, paper_fp4,
   both impls "pallas", ``remat_policy="full"``, ``optimizer=
   "adafactor"`` (AdamW's f32 moments would not fit beside 55 GB of f32
   params and grads), ``scan_layers=False``, 6 steps.  Prints per-step
   loss, the three MoE metrics, step p50 after the first, tokens/s, peak
   memory per step and launches per kernel per step (batched and
   recompute launches apart), then a ``train_moe_profile`` line.  Gates:
   finite losses; the loss on step 0's batch lower after the run than
   before; each step 12 batched ``qmm_stream`` launches a layer (fwd,
   recompute, dgrad, wgrad of w_gate, w_up, w_down); every GEMM and
   flash launch on the tensor-core route, each also in a recompute; the
   MoE metrics in every row; an op replay of layer 0's nine expert calls
   on the CPU (their first MOE_REPLAY_EXPERTS experts) within OP_BOUND,
   and a control (the w_up forward with its activation unquantized) that
   must miss it.
8c. serve_moe — olmoe-1b-7b at full width, its depth cut to 8 of its
   16 layers (MOE_SERVE_LAYERS: at 16 it took 133.0 s of an 840.8 s
   run, at 12 91.4 s and at 8 61.8 s; 8 since the autotune phase and
   the larger build of the tiled GEMM kernels came in, which keeps the
   whole run within 840.8 s; weights drawn on the card in
   bf16, experts packed to FP4 matrix by matrix, the f32 router dense)
   through the ``ContinuousBatcher``: fp8 KV, paper_fp4, every stage
   captured, 8 slots, max_len 2048, 16 requests of 16-512 prompt tokens (requests 0
   and 1 of 128 and 256: a bucket's length) and 64 new tokens each,
   after an untimed warm-up per bucket.  Prints
   decode p50 captured and eager, prefill ms per bucket, tokens/s, peak
   memory, packed B/param, the KV cache's bytes and the batched
   launches, then a ``serve_moe_profile`` line.  Gates: the timed run
   captures nothing; the captured engine token-exact to the eager one on
   4 requests and, on requests 0 and 1, to the sequential ``generate``
   (its cache of prompt + 64 positions gives the cached attention the
   bits of the engine's 2048: chunks of ``attention_chunk`` keys
   whatever the cache's length) and to a one-slot engine of the same
   max_len (no pad rows in their router groups, so bucketed routing
   equals exact-length routing, and a decode step's expert products run
   64 x 8 rows for 1 slot as for 8); every GEMM-kernel call of layer 0 in
   an eager prefill (request 2) and one batched decode step replayed
   through the plain versions on the card (quantize passes bitwise,
   products within OP_BOUND, the expert calls among them), with a
   control that must miss.
8d. train_ssm — trains mamba2-780m at full published width and depth
   (48 mamba layers, d 1536, d_inner 3072, 48 heads of 64, d_state 128,
   chunk 256, vocab 50280, tied embeddings; 780,148,992 parameters drawn
   on the card), ``SyntheticLM`` (seed 0), 4 x 2048 tokens, paper_fp4
   (every projection FFN-class: FP4 forward, FP8 wgrad), linear_impl
   "pallas", remat "full", AdamW, 6 steps.  Prints per-step loss and
   gradient norm, step p50 after the first, tokens/s, peak memory, the
   launches per step, one layer's SSD forward and forward + backward ms
   at the training shape, and the heads of step 0 whose chunk sum of dt
   |A| passes 88 (where the reference's SSD gradient is NaN), then a
   ``train_ssm_profile`` line with the ``ssd`` span named.  Gates: every
   loss and gradient norm finite; the loss on step 0's batch lower after
   the run; 24 ``qmm_stream`` launches a layer-step (6 projections x
   forward, recompute, dgrad, wgrad), all on the tensor cores; layer 0's
   18 projection calls replayed on the CPU within OP_BOUND, and a
   control (in_x's forward with its activation unquantized) that must
   miss it.
8e. serve_ssm — mamba2-780m at full width and depth (bf16 weights drawn
   on the card, the projections packed to FP4, the conv weights and f32
   leaves dense) through the ``ContinuousBatcher``: paper_fp4, 8 slots,
   max_len 1024, exact-length eager prefill, captured insert and decode
   (the conv history and state updated in place), 16 requests of 16-512
   prompt tokens x 64 new.  Prints decode p50 captured and eager, the
   prefill ms, tokens/s, peak memory, packed B/param and the state
   cache's bytes at max_len 1024 and 4096 (gate: equal, and equal to
   the cache the engine holds), then a ``serve_ssm_profile`` line.
   Gates: the timed run captures nothing; the captured engine token-
   exact to the eager one on 4 requests and to the sequential
   ``generate`` on requests 0 and 1; a kernel replay of layers 0 and
   47's six projection calls in an eager prefill (request 2) and one
   batched decode step (in_dt's N = 48 among them) through the plain
   version on the card, within OP_BOUND, with a control that must miss.
8f. hybrid — jamba-1.5-large-398b at ``REDUCED`` size (398 B parameters
   need many cards): 8 layers, attention at layer 4 and mamba mixers
   elsewhere, MoE FFNs on the odd layers.  A correctness check, not a
   measurement: at d 64 its times say nothing of jamba's, and none is
   printed.  One captured engine (packed fp4, fp8 KV, paper_fp4, 2
   slots, max_len 256, 6 requests x 24 new) whose decode graph holds
   attention KV, mamba state and MoE; gates: token-exact to the eager
   engine and to ``generate`` (requests 0-1), expert launches batched,
   and a kernel replay of layers 3 (mamba + MoE: 6 projections and 3
   batched expert products) and 4 (attention: 4 two-pass linears, and
   the dense FFN) in an eager prefill and one batched decode step
   through the plain versions on the card, within OP_BOUND, with a
   control that must miss.  Then 2 training steps (2 x 256 tokens,
   paper_fp4, both impls "pallas"): finite losses and norms, every
   kernel launched, and step 0's calls of layers 3 and 4 (fwd, dgrad,
   wgrad, and layer 4's flash forward) replayed on the CPU within
   OP_BOUND, with a control (layer 4's wq dgrad with its transposes off)
   that must miss.
8g. vlm — llama-3.2-vision-90b at full width (d 8192, 64 heads and 8
   KV heads of 128, d_ff 28672, vocab 128256, 1601 vision patches), its
   depth cut to its first VLM_LAYERS = 5 layers (layers 0-4, the cross
   sublayer on layer 3; 6,530,629,633 parameters: the full model's
   90.7 B need many cards), weights drawn on the card in bf16 with every
   ``cross_gate`` at 1.0 (at the init's 0, ``tanh(0) = 0``, no logit
   would see the vision), packed to FP4; fp8 KV, paper_fp4,
   linear_impl "pallas", captured stages.  One batched ``generate`` of 4
   prompts of 128 tokens with seeded vision states (4, 1601, 8192) bf16
   and 32 new tokens (a warm-up run captures; the counted run replays;
   a third run through ``make_prefill_fn`` / ``make_decode_fn`` times
   each stage).  Prints prefill ms, decode p50, tokens/s, peak memory,
   packed B/param, the cross cache's bytes and launches per kernel.
   Gates: the three runs' tokens equal; rows 0 and 1 token-exact to the
   same requests generated alone; the cross control (other vision
   states move the last logits beyond OP_BOUND); layer 3's
   ``quantize_rows`` / ``tiled_mm`` / ``qmm_stream`` calls (self-
   attention, cross-attention with its K/V projection at M = 6404, FFN)
   in an eager prefill and decode step through the plain versions on the
   card within OP_BOUND, with a control that must miss.  Then
   llama-3.2-vision ``REDUCED`` trains 2 steps at 2 x 256 (flash causal,
   a vision pipeline) as a correctness check with no time kept: finite
   losses, every kernel launched, the gate moved, layer 3's step-0 calls
   (self, cross, FFN: fwd, dgrad but of the cross K/V, wgrad, flash)
   replayed on the CPU within OP_BOUND, with a control that must miss.
8h. audio — whisper-base at full width and depth (6 + 6 layers, d 512,
   8 heads of 64, d_ff 2048, vocab 51865; 81,111,552 parameters drawn on
   the card).  Its decoder has no cross sublayer (the reference's
   placement, ``i % 1 == -1``, never holds), so no layer reads the
   encoder: training and serving do not run it, and its leaves get zero
   gradients.  Trains 6 paper_fp4 steps (both impls "pallas") on 16 x
   448 tokens with 16 x 1500 frames: step p50, tokens/s, peak; gates:
   finite losses, step 0's calls of decoder layers 0 and 5 replayed on
   the CPU within OP_BOUND (control must miss), the encoder's AdamW
   moments exactly 0 and its leaves bit for bit the same AdamW update on
   zero gradients (weight decay alone).  Runs ``_encode`` on 8 x 1500
   frames (its time; layers 0 and 5's kernel calls through the plain
   versions on the card, with a control).  Serves packed FP4 with fp8 KV
   from captured stages: one batched ``generate`` of 8 start-of-
   transcript prompts (4 tokens) with frames and 220 new tokens; row 0
   token-exact to the request alone, every row equal (the frames differ,
   and nothing reads them).
9. blockwise — ``kernels.ops.quantize_blockwise`` (the standalone QDQ,
   ``_q_kernel``'s port) over every 2-D weight of a seeded gpt2-125m, fp4
   tiles and fp8 rows, each output bitwise against the plain version.
10. the launch counts of each path's run, ``serve_swa``'s and the SSM
   paths' among them
   (every kernel of a path must have run in it), the seconds at the end
   of each phase, and the ``{"kernels": [...]}`` line (launches from the
   adaptive train path of phase 7, ``quantize_blockwise``'s from phase 9,
   every path's in ``launches_by_path``, the MoE paths' batched ones in
   ``batched_launches_by_path``; times at the gpt2-125m training shapes,
   the expert shapes' in ``batched_rows``, mamba2's in ``ssm_rows``,
   flash's non-causal ones in ``noncausal_rows``); the card line; the ok
   line last.

Phase 2 has a fifth line, ``ssm_kernels``: ``qmm_stream`` at
mamba2-780m's projection shapes, bf16, 8192 tokens: the forward (fp4
block x tile), dgrad (pass x pass, w read transposed) and wgrad (fp8
blocks, x read transposed, K = 8192) of in_x (N 3072), in_b (N 128),
in_dt (N 48, below one 128-wide tile: its dgrad's K is 48) and out_proj
(3072 -> 1536), and the packed decode shape (M = 8, FMA route) of in_x
and in_dt.  Each within one bf16 ulp + 1e-5 max|y| of the plain version,
its QDQ panels bitwise, the stream kernel bitwise the two-pass pipeline;
its time, the plain version's, ``torch.matmul``'s, the bound and its
share.

Phase 2 has a fourth line, ``moe_kernels``: the batched (expert)
launches at olmoe-1b-7b's shapes, 64 experts, bf16: the expert forward
of w_up (64 x 1280 x 2048 -> 1024) and w_down (64 x 1280 x 1024 ->
2048), their dgrad (pass x pass, w read transposed) and wgrad (fp8
blocks, x read transposed, K = 1280), the decode shape (64 x 8 rows, the
FMA route), and the two-pass kernels batched (fp8 token rows).  Each
batched call is one launch (counted as batched), within one bf16 ulp +
1e-5 max|y| of the plain version (a loop over the experts), bitwise
equal to the same kernel launched once per expert, its QDQ panels
bitwise the plain version's and the stream kernel bitwise the two-pass
pipeline.  Beside each: its time with L2 flushed, the plain version's,
64 per-expert launches', ``torch.bmm``'s at the same shape, the bound
(operations at 989 TFLOP/s) and its share of it.

Phase 2 has a third line, ``telemetry_kernels``, at the training shapes:
stochastic rounding in ``quantize_rows`` (token and block, both trans
settings) and in ``qmm_stream`` (the wgrad call: ``b_sr``, ``trans_a``),
bitwise against the plain versions and the stream kernel against
quantize_rows + tiled_mm; SR unbiasedness on the card (the mean over 64
seeds within the bounds of ``tests/test_rounding.py``); the stats
epilogue of both kernels against the plain versions (lanes 0-2 and 5-7
bitwise, 3-4 within STATS_RTOL) and stream stats bitwise equal to
two-pass stats; ``quantize_blockwise`` tile and per-row, f32 and bf16,
bitwise at 8192 x 768, llama-1b's ragged 1280 x 3392 and 1000 x 300;
each mode's time beside its mode-off time, its plain time and its bound
(``quantize_blockwise``: its time, plain time and bound, and the blocks
of its tile launch at each shape from a profiler trace).

Every phase keeps the full depth of its model but ``serve_swa``, cut to
8 of 24 layers (SWA_LAYERS), ``serve_moe``, cut to 8 of 16 layers
(MOE_SERVE_LAYERS), and ``vlm``, cut to its first 5 layers (VLM_LAYERS).
Exits non-zero without a result when there is no CUDA device or when
the port is not beside this script.
"""
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12          # dense bf16 tensor cores
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
CARD_SMS = 132                    # H100 SXM streaming multiprocessors
SHAPES_M = (8, 16, 128, 512)
SHAPES_KN = ((768, 768), (768, 3072), (3072, 768))
# Card vs CPU, teacher-forced logits of one request (256 tokens).
# End to end the two sides cannot agree closely: an FP4 (or FP8) rounding
# is a step function, so a last-bit difference of summation order (the
# kernels and cuBLAS vs the plain versions and MKL) moves an element by a
# whole grid step once in a while, and depth and attention carry each
# such flip on to every later layer and position.  In bf16 most inputs of
# a quantizer are bitwise equal on both sides and a few differ by a bf16
# ulp; in f32 every input differs by an f32 ulp or so: the flips start at
# a similar rate and both settle at the distance of two FP4 noise draws
# (rel L2 ~0.15).  So the gate is op by op: every linear and attention
# call of the card's forward is replayed on the CPU on the card's own
# inputs, quantized activations must match bitwise and outputs within
# OP_BOUND (relative L2; measured <= 8.7e-7 in f32 and <= 7e-5 in bf16 on
# an H100).  End to end, bf16 is held within TF_BOUND, and a control
# (layer 0's w_up scales off by one binade) must land beyond it.
OP_BOUND = {"float32": 1e-5, "bfloat16": 1e-3}
TF_BOUND = 0.25
TF_TOKENS = 256
# The train phase: gpt2-125m, global batch 8 x 1024 tokens, 8 steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 8
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ
REPLAY_LAYERS = (0, 11)
# The train phase saves at step 4; a second Trainer resumes there.
RESUME_AT = 4
# The train_large phase: llama-1b, global batch 4 x 2048 tokens, 7 steps
# (round(7 x (1 - 0.075)) = 6: the §3.3 switch on the last one),
# first_last_k with k = 2; op replay of a protected and a middle layer.
LARGE_BATCH, LARGE_SEQ, LARGE_STEPS, LARGE_K = 4, 2048, 7, 2
LARGE_REPLAY_LAYERS = (0, 24)
# The train_cli phase: launch/train.py run in process on llama3.2-3b at
# full width and depth, 4 x 2048 tokens, 5 AdamW steps of paper_fp4 with
# both impls "pallas" (round(5 x 0.925) = 5: no §3.3 switch); op replay of layers
# 0 and 27 through the plain versions on the card.  Then the qlint CLI on
# tiny on the card against the port's committed expectations.
CLI_ARCH, CLI_BATCH, CLI_SEQ, CLI_STEPS = "llama3.2-3b", 4, 2048, 5
CLI_PARAMS = 3_212_749_824
# (layers, d_model, d_ff, vocab, head_dim) of the full model
CLI_DIMS = (28, 3072, 8192, 128256, 128)
CLI_REPLAY_LAYERS = (0, 27)
CLI_ARGV = ("--arch", CLI_ARCH, "--recipe", "paper_fp4", "--linear-impl",
            "pallas", "--attention-impl", "pallas", "--batch",
            str(CLI_BATCH), "--seq", str(CLI_SEQ), "--steps", str(CLI_STEPS),
            "--device", "cuda")
# The autotune phase: two keys of llama3.2-3b's training step swept again
# (the FFN forward 8192 x 3072 -> 8192, and the FFN wgrad, with SR on its
# gradient operand and the stats epilogue), every built tiling held
# bitwise against 128 x 128 on them, and gpt2-125m trained AUTOTUNE_STEPS
# paper_fp4 steps on an empty table, then on the committed one.
AUTOTUNE_JOBS = (
    dict(m=8192, n=8192, k=3072, a_mode="block", b_mode="tile",
         a_fmt="fp4_e2m1", b_fmt="fp4_e2m1"),
    dict(m=3072, n=8192, k=8192, a_mode="block", b_mode="block",
         a_fmt="fp8_e4m3", b_fmt="fp8_e5m2", trans_a=True, b_sr=True,
         seed_b=-1253433917, collect_stats=True))
AUTOTUNE_STEPS, AUTOTUNE_BUDGET_S = 4, 45.0
QLINT_ARGV = ("--config", "tiny", "--plan", "fine_grained_fp4", "--impl",
              "pallas", "--decode", "--device", "cuda", "--expect",
              os.path.join(ROOT, "tests", "qlint_expected_tiny_torch.json"))
# The stats epilogue against its plain version: lanes 0-2 and 5-7 (counts
# and scale extrema) bitwise, lanes 3-4 (sums of squares) within this
# relative bound (both fold in one canonical order, so they are expected
# bitwise as well; the line reports whether they were).
STATS_RTOL = 1e-6
# The train_telemetry phase: 4 instrumented steps of an 8-step schedule
# (the switch to bf16 comes after them).
TEL_STEPS, TEL_SCHEDULE = 4, 8
# The speed_factors phase: the recipes whose operand-spec pairs it times
# (the reference's measure_speed_factors set), at the FFN forward shape.
SPEED_RECIPES = ("bf16", "fp8", "paper_fp4", "fine_grained_fp4")
SPEED_SHAPE = (TRAIN_TOKENS, 768, 3072)
# The train_adaptive phase: 12 steps (round(12 x 0.925) = 11: the §3.3
# switch on the last), a checkpoint every 3; after step 6 a rollback is
# injected, which restores step 6 and replays steps 6-7 at bf16 with the
# LR halved; a second Trainer resumes from the step-9 checkpoint.
ADAPT_STEPS, ADAPT_CKPT, ADAPT_RESTORE, ADAPT_RESUME_AT = 12, 3, 6, 9
ADAPT_CONTROLLER = dict(plan_search=True, plan_search_every=2,
                        plan_search_max_edits=3, spike_factor=2.0,
                        replay_steps=2, lr_backoff=0.5, lr_recovery_steps=4)
ADAPT_REPLAY_STEP = 8     # the op replay's step: the searcher-edited plan
# The slice phase: the eager engine (jit=False) serves the first
# SLICE_EAGER requests again beside the captured one.
SLICE_EAGER = 4
# The serve_swa phase: h2o-danube-3-4b at full width and SWA_LAYERS of
# its 24 layers, 4 slots over a cache of max_len 8192 (a ring of 4096
# positions a layer), 8 requests of 3840-4096 prompt tokens and 384 new
# tokens each: every one decodes past the window.
SWA_LAYERS = 8
SWA_SLOTS, SWA_MAX_LEN, SWA_REQUESTS, SWA_NEW = 4, 8192, 8, 384
SWA_PROMPT = (3840, 4096)
# The ring check: request 0's tokens teacher-forced through an f32 engine
# (bf16 recipe, packed weights, bf16 KV) past the window against the
# windowed no-cache forward, relative L2 of the logits over every decoded
# position.  The bf16 KV rounding is the only difference on the engine's
# side (a CPU rehearsal at d 960, 24 layers, window 1024: 3.6e-3); the
# control, the forward with no window, sees up to 9% more keys (the same
# rehearsal: 0.126).
RING_BOUND = 0.03
# The serve_swa kernel replay: every GEMM-kernel call of these layers in
# one exact-length prefill (request 0's prompt) and one batched decode
# step (M = 4) of an eager engine, again through the plain versions on
# the card on the same inputs (quantize_rows bitwise, the products within
# OP_BOUND); the control, layer 0's first FFN product with its
# activation left unquantized, must miss it.  Each layer runs 4
# quantize_rows + 4 tiled_mm (wq, wk, wv, wo: fp8 token rows) and 3
# qmm_stream (w_gate, w_up, w_down: fp4 blocks) a stage.
SWA_REPLAY_LAYERS = (0, SWA_LAYERS - 1)
SWA_CALLS_PER_LAYER = {"quantize_rows": 4, "tiled_mm": 4, "qmm_stream": 3}
# olmoe-1b-7b's expert shapes: 64 experts, d 2048, d_ff 1024; a training
# step of 4 x 2048 tokens in router groups of 1024 gives each expert
# 8 groups x 160 slots (capacity ceil(1024 x 8 x 1.25 / 64)) = 1280 rows;
# a decode step of 8 slots, 8 rows (capacity max(2, top_k)).
MOE_EXPERTS, MOE_ROWS, MOE_D, MOE_FF = 64, 1280, 2048, 1024
# The train_moe phase: olmoe-1b-7b at full width and depth, 4 x 2048
# tokens, 6 steps, adafactor; the op replay of layer 0's expert calls on
# the CPU takes the first MOE_REPLAY_EXPERTS experts of each batched call
# (each expert's result is its own: a batched launch equals one launch per
# expert bit for bit, which moe_kernels gates).
MOE_BATCH, MOE_SEQ, MOE_STEPS = 4, 2048, 6
MOE_REPLAY_EXPERTS = 2
# The serve_moe phase: 8 slots, max_len 2048, 16 requests of 16-512
# prompt tokens and 64 new tokens; requests 0 and 1 have prompts of
# MOE_EXACT_PROMPTS tokens, a bucket's own length (no pad row in the
# router groups), for the check against the sequential generate.
MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS, MOE_NEW = 8, 2048, 16, 64
MOE_EXACT_PROMPTS = (128, 256)
# serve_moe's depth: 8 of olmoe's 16 layers, cut so that the whole run
# with the autotune phase stays within the 840.8 s it took before
MOE_SERVE_LAYERS = 8
# mamba2-780m's projection shapes: d 1536 -> d_inner 3072 (in_z, in_x),
# n_groups x d_state 128 (in_b, in_c), 48 heads (in_dt: N below one
# 128-wide tile), and out_proj 3072 -> 1536.
SSM_D, SSM_INNER, SSM_GN, SSM_HEADS = 1536, 3072, 128, 48
# The train_ssm phase: mamba2-780m at full width and depth, 4 x 2048
# tokens (chunk 256: 8 chunks a row), 6 steps, AdamW, remat.  The SSD's
# reference NaN condition: a head whose chunk sum of dt * |A| passes 88
# (exp overflows f32 above ~88.7).
SSM_BATCH, SSM_SEQ, SSM_STEPS = 4, 2048, 6
SSM_TOKENS = SSM_BATCH * SSM_SEQ
SSM_EXP_OVERFLOW = 88.0
SSM_PROJ = ("in_z", "in_x", "in_b", "in_c", "in_dt", "out_proj")
# The serve_ssm phase: 8 slots, 16 requests of 16-512 prompt tokens and
# 64 new tokens, exact-length prefill; the state cache's bytes at two
# max_lens (constant in max_len); the kernel replay's layers.
SSM_SLOTS, SSM_MAX_LEN, SSM_REQUESTS, SSM_NEW = 8, 1024, 16, 64
SSM_REPLAY_LAYERS = (0, 47)
# The hybrid phase: jamba-1.5-large-398b REDUCED (8 layers: attention at
# layer 4, MoE on the odd ones), 2 slots (MoE capacity 2 an expert at
# decode: no token dropped, and 1 and 2 slots run one expert shape), 6
# requests x 24 new tokens; two training steps of 2 x 256 tokens.
HYB_SLOTS, HYB_MAX_LEN, HYB_REQUESTS, HYB_NEW = 2, 256, 6, 24
HYB_TRAIN_BATCH, HYB_TRAIN_SEQ = 2, 256
# Its kernel replays' layers: 3 (mamba + MoE) and 4 (attention + dense
# FFN), and each one's GEMM-kernel calls a serving stage.
HYB_REPLAY_LAYERS = (3, 4)
HYB_CALLS_PER_LAYER = {3: {"qmm_stream": 9},
                       4: {"quantize_rows": 4, "tiled_mm": 4,
                           "qmm_stream": 3}}
# The vlm phase: llama-3.2-vision-90b at full width, depth cut to its
# first VLM_LAYERS layers (the cross sublayer on layer 3); one batched
# generate of VLM_PROMPTS prompts of VLM_PROMPT_LEN tokens with seeded
# vision states, VLM_NEW new tokens; rows 0-1 again alone.  Its kernel
# replay: layer 3's GEMM-kernel calls in an eager prefill and decode step
# (self-attention, cross-attention and FFN; a decode step projects no
# cross K / V: they are cached).  Then 2 REDUCED training steps.
VLM_LAYERS, VLM_CROSS_LAYER = 5, 3
VLM_PROMPTS, VLM_PROMPT_LEN, VLM_NEW = 4, 128, 32
VLM_CALLS = {"prefill": {"quantize_rows": 8, "tiled_mm": 8, "qmm_stream": 3},
             "decode": {"quantize_rows": 6, "tiled_mm": 6, "qmm_stream": 3}}
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 2, 256
# Layer 3's products in order (the cross sublayer's as x*), for the
# training replay
VLM_NAMES = ("wq", "wk", "wv", "wo", "xq", "xk", "xv", "xo", "w_gate",
             "w_up", "w_down")
# The audio phase: whisper-base at full width and depth; AUD_STEPS
# training steps of AUD_BATCH x AUD_SEQ tokens (its text context) with
# frames; the encoder alone on AUD_ENC_BATCH x 1500 frames; one batched
# generate of AUD_SERVE start-of-transcript prompts with frames,
# AUD_NEW new tokens (its default sample_len, 448 // 2, less the
# prompt).  Replays: decoder layers 0 and 5 of training step 0, encoder
# layers 0 and 5.
AUD_BATCH, AUD_SEQ, AUD_STEPS = 16, 448, 6
AUD_ENC_BATCH, AUD_SERVE, AUD_NEW = 8, 8, 220
AUD_SOT = (50258, 50259, 50359, 50363)   # <|startoftranscript|><|en|>...
AUD_REPLAY_LAYERS = (0, 5)
AUD_ENC_CALLS = {"quantize_rows": 8, "tiled_mm": 4, "qmm_stream": 2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Mean device time of a callable with CUDA events around each call,
    L2 flushed before every call, as the serving step finds its weights
    cold (it streams ~200 MB of weights through the 50 MB L2).

    The flush is a 512 MB write (~0.16 ms on the card), long enough that
    the host enqueues the call while the flush runs: the events then time
    the device work of the call, not the Python that launches it.  A
    plain version of many small ops can still outrun that margin, so its
    time may include host gaps."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(512 << 20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


# The libraries with a tensor-core route (kernels named *_tc_kernel): the
# GEMM kernels' bf16 calls with M > 16 run gemm_sm90.cuh's wgmma main
# loop, flash attention's bf16 calls flash_fwd_tc_kernel.
TC_SOURCES = ("qmm_stream", "tiled_mm", "flash_attention")


def tc_kernel_report(log):
    """Per tensor-core kernel of a ``-Xptxas -v`` log (entry functions
    named ``*_tc_kernel*``): registers and spill bytes (stores + loads);
    and ptxas' wgmma lines (e.g. serialized products)."""
    report, cur = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            base = re.search(r"([a-z_]+_tc_kernel)I(.*?)EEv", name)
            # e.g. qmm_stream_tc_kernel<1,0,0>: its bool template flags;
            # flash_fwd_tc_kernel<64>: its head dimension
            cur = base and "{}<{}>".format(base.group(1), ",".join(
                re.findall(r"L[bi](\d+)E?", base.group(2) + "E")))
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            report.setdefault(cur, {})["spill_bytes"] = nums[1] + nums[2]
        elif cur and "Used" in ln and "registers" in ln:
            words = ln.split()
            report.setdefault(cur, {})["registers"] = int(
                words[words.index("Used") + 1])
    wgmma = [ln.strip() for ln in log.splitlines() if "wgmma" in ln]
    return report, wgmma


def phase_build(card):
    """Build every kernel; show that the tensor-core kernels issue HGMMA
    (``cuobjdump -sass``: products on wgmma, not mma.sync or FMA) and that
    ptxas spilled nothing in them."""
    from repro_torch.kernels import build
    seconds, logs = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    hgmma, tc_kernels, wgmma_notes = {}, {}, {}
    for name in TC_SOURCES:
        hgmma[name] = sum("HGMMA" in ln
                          for ln in build.sass(name).splitlines())
        tc_kernels[name], wgmma_notes[name] = tc_kernel_report(
            logs.get(name, ""))
    emit({"phase": "build", "card": card, "seconds": seconds,
          "sources": list(build.SOURCES), "hgmma_instructions": hgmma,
          "tc_kernels": tc_kernels, "ptxas_wgmma": wgmma_notes,
          "ptxas": ptxas})
    spilled = {k: v for name in TC_SOURCES
               for k, v in tc_kernels[name].items() if v.get("spill_bytes")}
    serialized = [ln for name in TC_SOURCES for ln in wgmma_notes[name]
                  if "serialized" in ln]
    if min(hgmma.values()) <= 0 or not all(tc_kernels.values()) or \
            spilled or serialized:
        raise AssertionError(f"tensor-core kernels: HGMMA {hgmma}, ptxas "
                             f"{tc_kernels}, spilled {spilled}, serialized "
                             f"{serialized[:2]}")


def _bound(nbytes, flops, peak):
    """(least ms, "bytes" | "operations") of a call on the card."""
    t_b, t_o = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def routed(kern, fn):
    """Call ``fn`` (one call of a GEMM kernel); return (its result, the
    route its launch took by the kernel's counters: "tensor_core" or
    "fma")."""
    tc = kern.tc_launches
    y = fn()
    return y, "tensor_core" if kern.tc_launches > tc else "fma"


def gemm_fields(route, m, k, n, ms, bound_ms):
    """A GEMM row's route, achieved TFLOP/s (2 M N K over its time) and
    share of its bound."""
    return {"route": route, "tflops": 2 * m * n * k / (ms * 1e-3) / 1e12,
            "bound_share": bound_ms / ms}


def phase_kernels(torch, card):
    """Hold each kernel against its plain version; return per-kernel
    records of the main-path shapes."""
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels import tiled_mm as tm
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    rows = []

    def rand(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 2).to(torch.bfloat16)

    def gemm_err(y, ref):
        y, ref = y.float(), ref.float()
        err = (y - ref).abs()
        bound = 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"GEMM out of tolerance: max err {err.max().item()}")
        return err.max().item()

    for m in SHAPES_M:
        for k in sorted({k for k, _ in SHAPES_KN}):
            x = rand(m, k)
            y = qr.quantize_rows(x, mode="token", fmt_name="fp8_e4m3")
            ref = qr.quantize_rows_plain(x, mode="token",
                                         fmt_name="fp8_e4m3")
            torch.cuda.synchronize()
            if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"quantize_rows ({m}, {k}) not bitwise")
            # abs, max, divide, round (~4 ops), multiply per element
            b_ms, b_by = _bound(4 * m * k, 8 * m * k, H100_F32_FLOPS)
            rows.append({
                "name": "quantize_rows", "shape": [m, k],
                "max_abs_err": 0.0,
                "ms": timer.ms(lambda: qr.quantize_rows(
                    x, mode="token", fmt_name="fp8_e4m3")),
                "plain_ms": timer.ms(lambda: qr.quantize_rows_plain(
                    x, mode="token", fmt_name="fp8_e4m3")),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        for k, n in SHAPES_KN:
            a, w = rand(m, k), rand(k, n) * 0.05
            kw = dict(a_mode="block", b_mode="pass", a_fmt="fp4_e2m1",
                      b_fmt="bf16")
            y, route = routed(qs.KERNEL, lambda: qs.qmm_stream(a, w, **kw))
            err = gemm_err(y, qs.qmm_stream_plain(a, w, **kw))
            aq = qr.quantize_rows(a, mode="block", fmt_name="fp4_e2m1")
            if not torch.equal(y.view(torch.int16),
                               tm.tiled_mm(aq, w).view(torch.int16)):
                raise AssertionError(
                    f"qmm_stream ({m}, {k}, {n}) != quantize_rows + "
                    "tiled_mm bitwise")
            b_ms, b_by = _bound(2 * (m * k + k * n + m * n), 2 * m * n * k,
                               H100_BF16_FLOPS)
            ms = timer.ms(lambda: qs.qmm_stream(a, w, **kw))
            rows.append({
                "name": "qmm_stream", "shape": [m, k, n],
                "max_abs_err": err, "ms": ms,
                "plain_ms": timer.ms(lambda: qs.qmm_stream_plain(a, w,
                                                                 **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timer.ms(lambda: torch.matmul(aq, w)),
                **gemm_fields(route, m, k, n, ms, b_ms)})
            if (k, n) == (768, 768):
                xq = qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3")
                y, route = routed(tm.KERNEL, lambda: tm.tiled_mm(xq, w))
                err = gemm_err(y, tm.tiled_mm_plain(xq, w))
                ms = timer.ms(lambda: tm.tiled_mm(xq, w))
                rows.append({
                    "name": "tiled_mm", "shape": [m, k, n],
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": timer.ms(lambda: tm.tiled_mm_plain(xq, w)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": timer.ms(lambda: torch.matmul(xq, w)),
                    **gemm_fields(route, m, k, n, ms, b_ms)})
    torch.cuda.synchronize()
    emit({"phase": "kernels", "card": card, "dtype": "bfloat16",
          "ok": True, "table": rows})
    return rows


def row_independence(torch, what, call, y):
    """Rows 0-16 of a training-shape call (``y``, M = 8192) bitwise equal
    to the same call on the first 17 and the first 128 rows (``call(n)``):
    a row's result does not depend on M."""
    for n in (17, 128):
        part = call(n)
        torch.cuda.synchronize()
        if not torch.equal(y[:17].view(torch.int16),
                           part[:17].view(torch.int16)):
            raise AssertionError(f"{what}: rows 0-16 at M = {y.shape[0]} "
                                 f"differ from the call on {n} rows")


# The kernels of csrc/quantize_rows.cu (the stats fold's are codec.cuh's).
QUANTIZE_ROWS_KERNELS = ("quantize_rows_kernel", "quantize_tok_kernel",
                         "quantize_cols_kernel", "col_amax_kernel",
                         "tensor_amax_kernel")


def kernel_blocks(torch, fn, attempts: int = 3):
    """The blocks of each kernel one call of ``fn`` launches, from the
    grid that a ``torch.profiler`` trace records: {kernel: x * y * z}.
    A trace now and then comes back with no kernel record at all (no
    measurement, not a wrong one): it is taken again, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    blocks = {}
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        for ev in events:
            grid = ev.get("args", {}).get("grid")
            name = re.search(r"(\w+_kernel)", ev.get("name", ""))
            if ev.get("cat") == "kernel" and grid and name:
                blocks[name.group(1)] = int(np.prod(grid))
        if blocks:
            break
    return blocks


def flash_precision(torch, fa):
    """The flash yardstick at D = 128 on the card tests' inputs (q, k, v ~
    3 N(0, 1) bf16, 4 heads x 1024 x 128, GQA 2): the tensor-core kernel,
    the plain version (exact bf16 scores) and the reference's own score
    order (q cast to f32 and scaled, one f32 dot) against the causal
    softmax in f64.  Per output: max over outputs of the excess over the
    gate (one bf16 ulp + 1e-5) and the count beyond it."""
    def rand(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.randn(*shape, generator=g, device="cuda")
                * 3).to(torch.bfloat16)
    q = rand((4, 1024, 128), 17)
    k, v = rand((2, 1024, 128), 18), rand((2, 1024, 128), 19)
    kk, vv = (t.repeat_interleave(2, 0).double() for t in (k, v))
    scores = torch.matmul(q.double(), kk.transpose(1, 2)) * fa._scale(128)
    above = torch.ones(1024, 1024, dtype=torch.bool, device="cuda").triu(1)
    truth = torch.matmul(torch.softmax(
        scores.masked_fill(above, float("-inf")), dim=-1), vv)
    outs = {"kernel": fa.flash_attention_fwd(q, k, v),
            "plain": fa.flash_attention_fwd_plain(q, k, v),
            "reference_order": fa.flash_attention_fwd_plain(
                q.float(), k.float(), v.float()).to(torch.bfloat16)}
    result = {}
    for name, o in outs.items():
        e = (o.double() - truth).abs() - (2.0 ** -7 * truth.abs() + 1e-5)
        result[name] = {"max_excess": e.max().item(),
                        "outputs_beyond_gate": int((e > 0).sum())}
    if result["kernel"]["outputs_beyond_gate"]:
        raise AssertionError(f"flash_attention d128 off the f64 softmax: "
                             f"{result}")
    return result


def phase_train_kernels(torch, card):
    """The training step's kernel calls at gpt2-125m's shapes (8192
    tokens, bf16), each against its plain version on the same inputs;
    return per-call records."""
    import torch.nn.functional as F_nn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels import tiled_mm as tm
    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = Timer(torch)
    rows = []
    t, d, f = TRAIN_TOKENS, 768, 3072

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def bitwise(y, ref, what):
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"{what} not bitwise equal to its plain "
                                 "version")

    def gemm_err(y, ref, what):
        y, ref = y.float(), ref.float()
        err = (y - ref).abs()
        if not bool((err <= 2.0 ** -7 * ref.abs()
                     + 1e-5 * ref.abs().max()).all()):
            raise AssertionError(f"{what} out of tolerance: max err "
                                 f"{err.max().item()}")
        return err.max().item()

    def gemm_bound(m, k, n):
        return _bound(2 * (m * k + k * n + m * n), 2 * m * n * k,
                      H100_BF16_FLOPS)

    def quant(role, x, mode, fmt, trans):
        """quantize_rows as the two-pass route runs it (result in the
        stored layout); returns the quantized panel."""
        kw = dict(mode=mode, fmt_name=fmt, trans=trans, emit_trans=trans)
        y = qr.quantize_rows(x, **kw)
        bitwise(y, qr.quantize_rows_plain(x, **kw), f"quantize_rows {role}")
        n = x.numel()
        b_ms, b_by = _bound(4 * n, 8 * n, H100_F32_FLOPS)
        blocks = {k: n for k, n in kernel_blocks(
            torch, lambda: qr.quantize_rows(x, **kw)).items()
            if k in QUANTIZE_ROWS_KERNELS}
        if x.numel() >= TRAIN_TOKENS * d and \
                min(blocks.values(), default=0) <= CARD_SMS:
            raise AssertionError(f"quantize_rows {role}: a kernel runs on "
                                 f"{CARD_SMS} blocks or fewer: {blocks}")
        rows.append({
            "name": "quantize_rows", "role": role, "shape": list(x.shape),
            "trans": trans, "max_abs_err": 0.0, "blocks": blocks,
            "ms": timer.ms(lambda: qr.quantize_rows(x, **kw), iters=10),
            "plain_ms": timer.ms(lambda: qr.quantize_rows_plain(x, **kw),
                                 iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        return y

    # FFN (qmm_stream): fwd fp4 block x fp4 tile; dgrad pass x pass with
    # w read transposed; wgrad fp8 blocks with x read transposed.
    x, h = rand(t, d, scale=2), rand(t, f, scale=2)
    g_d, g_f = rand(t, d, scale=0.01), rand(t, f, scale=0.01)
    w_up, w_down = rand(d, f, scale=0.05), rand(f, d, scale=0.05)
    fp4 = dict(a_fmt="fp4_e2m1", b_fmt="fp4_e2m1")
    fp8 = dict(a_fmt="fp8_e4m3", b_fmt="fp8_e5m2")
    stream_calls = [
        ("fwd w_up", x, w_up, dict(a_mode="block", b_mode="tile", **fp4)),
        ("fwd w_down", h, w_down, dict(a_mode="block", b_mode="tile",
                                       **fp4)),
        ("dgrad w_up", g_f, w_up, dict(a_mode="pass", b_mode="pass",
                                       a_fmt="bf16", b_fmt="bf16",
                                       trans_b=True)),
        ("dgrad w_down", g_d, w_down, dict(a_mode="pass", b_mode="pass",
                                           a_fmt="bf16", b_fmt="bf16",
                                           trans_b=True)),
        ("wgrad w_up", x, g_f, dict(a_mode="block", b_mode="block",
                                    trans_a=True, **fp8)),
        ("wgrad w_down", h, g_d, dict(a_mode="block", b_mode="block",
                                      trans_a=True, **fp8)),
    ]
    # llama3.2-3b's FFN forward (train_cli): 8192 x 3072 -> 8192
    d3, f3 = 3072, 8192
    x3 = rand(t, d3, scale=2)
    stream_calls.append(("llama3.2-3b fwd w_up", x3,
                         rand(d3, f3, scale=0.05),
                         dict(a_mode="block", b_mode="tile", **fp4)))
    for role, a, b, kw in stream_calls:
        ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
        y, route = routed(qs.KERNEL, lambda: qs.qmm_stream(a, b, **kw))
        err = gemm_err(y, qs.qmm_stream_plain(a, b, **kw),
                       f"qmm_stream {role}")
        aq = (a if kw["a_mode"] == "pass" else qr.quantize_rows(
            a, mode=kw["a_mode"], fmt_name=kw["a_fmt"], trans=ta,
            emit_trans=ta))
        bq = (b if kw["b_mode"] == "pass" else qr.quantize_rows(
            b, mode=kw["b_mode"], fmt_name=kw["b_fmt"], trans=not tb,
            emit_trans=not tb))
        two = tm.tiled_mm(aq, bq, trans_a=ta, trans_b=tb)
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), two.view(torch.int16)):
            raise AssertionError(f"qmm_stream {role} != quantize_rows + "
                                 "tiled_mm bitwise")
        ae, be = (aq.T if ta else aq), (bq.T if tb else bq)
        (m, k), n = ae.shape, be.shape[1]
        b_ms, b_by = gemm_bound(m, k, n)
        ms = timer.ms(lambda: qs.qmm_stream(a, b, **kw), iters=5)
        rows.append({
            "name": "qmm_stream", "role": role, "shape": [m, k, n],
            "trans": ta or tb, "max_abs_err": err, "ms": ms,
            "plain_ms": timer.ms(lambda: qs.qmm_stream_plain(a, b, **kw),
                                 iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.matmul(ae, be), iters=5),
            **gemm_fields(route, m, k, n, ms, b_ms)})
        if role == "fwd w_up":
            row_independence(torch, "qmm_stream fwd w_up",
                             lambda rows_: qs.qmm_stream(a[:rows_], b, **kw),
                             y)

    # Attention linears (two-pass, token modes): fwd x . w; dgrad
    # g . w^T; wgrad x^T . g.
    w = rand(d, d, scale=0.05)
    # and llama3.2-3b's (train_cli): wq 3072 -> 3072, wk / wv -> 1024
    # (8 KV heads of 128)
    tok = [
        ("fwd wq", x, w, ("fp8_e4m3", "fp8_e4m3"), False, False),
        ("dgrad wq", g_d, w, ("fp8_e5m2", "fp8_e4m3"), False, True),
        ("wgrad wq", x, g_d, ("fp8_e4m3", "fp8_e5m2"), True, False),
        ("llama3.2-3b fwd wq", x3, rand(d3, d3, scale=0.05),
         ("fp8_e4m3", "fp8_e4m3"), False, False),
        ("llama3.2-3b fwd wk", x3, rand(d3, 1024, scale=0.05),
         ("fp8_e4m3", "fp8_e4m3"), False, False),
    ]
    for role, a, b, (fa_, fb_), ta, tb in tok:
        aq = quant(f"{role} lhs", a, "token", fa_, ta)
        bq = quant(f"{role} rhs", b, "token", fb_, not tb)
        kw = dict(trans_a=ta, trans_b=tb)
        y, route = routed(tm.KERNEL, lambda: tm.tiled_mm(aq, bq, **kw))
        err = gemm_err(y, tm.tiled_mm_plain(aq, bq, **kw), f"tiled_mm {role}")
        ae, be = (aq.T if ta else aq), (bq.T if tb else bq)
        (m, k), n = ae.shape, be.shape[1]
        b_ms, b_by = gemm_bound(m, k, n)
        ms = timer.ms(lambda: tm.tiled_mm(aq, bq, **kw), iters=5)
        rows.append({
            "name": "tiled_mm", "role": role, "shape": [m, k, n],
            "trans": ta or tb, "max_abs_err": err, "ms": ms,
            "plain_ms": timer.ms(lambda: tm.tiled_mm_plain(aq, bq, **kw),
                                 iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.matmul(ae, be), iters=5),
            **gemm_fields(route, m, k, n, ms, b_ms)})
        if role == "fwd wq":
            row_independence(torch, "tiled_mm fwd wq",
                             lambda rows_: tm.tiled_mm(aq[:rows_], bq, **kw),
                             y)

    # Flash attention forward, causal: (B*H, S, D) = (96, 1024, 64), the
    # training step's; and (48, 1024, 128), the head dimension whose scale
    # is not a power of two, at the same bytes.  Non-causal (an encoder's
    # attention): whisper-base's 8 heads x batch 8 over its 1500 frames
    # rounded up to a multiple of 128, (64, 1536, 64), and (48, 1024, 128).
    for role, batch, heads, s_, dh, causal in (
            ("fwd", TRAIN_BATCH, 12, TRAIN_SEQ, 64, True),
            ("fwd d128", TRAIN_BATCH, 6, TRAIN_SEQ, 128, True),
            ("fwd noncausal", 8, 8, 1536, 64, False),
            ("fwd noncausal d128", TRAIN_BATCH, 6, TRAIN_SEQ, 128, False),
            ("llama3.2-3b fwd", CLI_BATCH, 24, CLI_SEQ, 128, True)):
        bh = batch * heads
        q, k, v = (rand(bh, s_, dh) for _ in range(3))
        kw = dict(causal=causal)
        o, route = routed(fa.KERNEL,
                          lambda: fa.flash_attention_fwd(q, k, v, **kw))
        ref = fa.flash_attention_fwd_plain(q, k, v, **kw)
        err = (o.float() - ref.float()).abs()
        if not bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all()):
            raise AssertionError(f"flash_attention {role} out of tolerance: "
                                 f"max err {err.max().item()}")
        q4, k4, v4 = (x_.view(batch, heads, s_, dh) for x_ in (q, k, v))
        # QK^T and PV over the keys each query sees
        keys = s_ * (s_ + 1) // 2 if causal else s_ * s_
        flops = 4 * dh * keys * bh
        b_ms, b_by = _bound(2 * 4 * bh * s_ * dh, flops, H100_BF16_FLOPS)
        ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                      iters=10)
        rows.append({
            "name": "flash_attention", "role": role, "shape": [bh, s_, dh],
            "causal": causal, "trans": False,
            "max_abs_err": err.max().item(), "ms": ms,
            "plain_ms": timer.ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(
                lambda: F_nn.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal), iters=10),
            "route": route, "tflops": flops / (ms * 1e-3) / 1e12,
            "bound_share": b_ms / ms})
    precision = flash_precision(torch, fa)
    torch.cuda.synchronize()
    emit({"phase": "train_kernels", "card": card, "dtype": "bfloat16",
          "tokens": t, "ok": True, "table": rows,
          "flash_precision_d128": precision})
    return rows


def phase_moe_kernels(torch, card):
    """The batched (expert) launches of the GEMM kernels at olmoe-1b-7b's
    shapes (module docstring, phase 2's ``moe_kernels`` line); return
    per-call records."""
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels import tiled_mm as tm
    gen = torch.Generator(device="cuda").manual_seed(5)
    timer = Timer(torch)
    rows = []
    e, c, d, f = MOE_EXPERTS, MOE_ROWS, MOE_D, MOE_FF

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def same_bits(y, ref, what):
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"{what} not bitwise equal")

    x, h = rand(e, c, d, scale=2), rand(e, c, f, scale=2)
    g_d, g_f = rand(e, c, d, scale=0.01), rand(e, c, f, scale=0.01)
    w_up, w_down = rand(e, d, f, scale=0.05), rand(e, f, d, scale=0.05)
    xd, hd = rand(e, 8, d, scale=2), rand(e, 8, f, scale=2)
    fp4 = dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
               b_fmt="fp4_e2m1")
    dgrad = dict(a_mode="pass", b_mode="pass", a_fmt="bf16", b_fmt="bf16",
                 trans_b=True)
    wgrad = dict(a_mode="block", b_mode="block", a_fmt="fp8_e4m3",
                 b_fmt="fp8_e5m2", trans_a=True)
    calls = [("fwd w_up", x, w_up, fp4), ("fwd w_down", h, w_down, fp4),
             ("dgrad w_up", g_f, w_up, dgrad),
             ("dgrad w_down", g_d, w_down, dgrad),
             ("wgrad w_up", x, g_f, wgrad), ("wgrad w_down", h, g_d, wgrad),
             ("decode w_up", xd, w_up, fp4),
             ("decode w_down", hd, w_down, fp4)]
    for role, a, b, kw in calls:
        ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
        before = qs.KERNEL.counts()
        y, route = routed(qs.KERNEL, lambda: qs.qmm_stream(a, b, **kw))
        after = qs.KERNEL.counts()
        if after["launches"] - before["launches"] != 1 or \
                after["batched"] - before["batched"] != 1:
            raise AssertionError(f"qmm_stream {role}: not one batched "
                                 f"launch: {before} -> {after}")
        ref = qs.qmm_stream_plain(a, b, **kw)
        yf, rf = y.float(), ref.float()
        err = (yf - rf).abs()
        if not bool((err <= 2.0 ** -7 * rf.abs()
                     + 1e-5 * rf.abs().max()).all()):
            raise AssertionError(f"qmm_stream {role} out of tolerance: max "
                                 f"err {err.max().item()}")
        # the batched launch against the same kernel once per expert
        one = torch.stack([qs.qmm_stream(a[i], b[i], **kw)
                           for i in range(e)])
        same_bits(y, one, f"qmm_stream {role} batched vs per expert")
        # the QDQ panels (batched quantize pass) against the plain
        # version, and the stream kernel against two-pass, per expert
        aq = a if kw["a_mode"] == "pass" else qr.quantize_rows(
            a, mode=kw["a_mode"], fmt_name=kw["a_fmt"], trans=ta,
            emit_trans=ta)
        bq = b if kw["b_mode"] == "pass" else qr.quantize_rows(
            b, mode=kw["b_mode"], fmt_name=kw["b_fmt"], trans=not tb,
            emit_trans=not tb)
        for op, stored, q, mode, fmt, trans in (
                ("A", a, aq, kw["a_mode"], kw["a_fmt"], ta),
                ("B", b, bq, kw["b_mode"], kw["b_fmt"], not tb)):
            if mode != "pass":
                same_bits(q, qr.quantize_rows_plain(
                    stored, mode=mode, fmt_name=fmt, trans=trans,
                    emit_trans=trans), f"quantize_rows {role} {op}")
        two = tm.tiled_mm(aq, bq, trans_a=ta, trans_b=tb)
        same_bits(y, two, f"qmm_stream {role} vs quantize_rows + tiled_mm")
        same_bits(y, fm.fused_qmm(a, b, pipeline="two_pass", **kw),
                  f"qmm_stream {role} vs the two-pass pipeline")
        ae = aq.transpose(1, 2) if ta else aq
        be = bq.transpose(1, 2) if tb else bq
        _, m, k = ae.shape
        n = be.shape[2]
        flops = 2 * e * m * n * k
        b_ms, b_by = _bound(2 * e * (m * k + k * n + m * n), flops,
                            H100_BF16_FLOPS)
        ms = timer.ms(lambda: qs.qmm_stream(a, b, **kw), iters=5)
        rows.append({
            "name": "qmm_stream", "role": role, "shape": [e, m, k, n],
            "trans": ta or tb, "batched": True,
            "max_abs_err": err.max().item(), "ms": ms,
            "plain_ms": timer.ms(lambda: qs.qmm_stream_plain(a, b, **kw),
                                 iters=2),
            "per_expert_launches_ms": timer.ms(
                lambda: [qs.qmm_stream(a[i], b[i], **kw) for i in range(e)],
                iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.bmm(ae, be), iters=5),
            "route": route, "tflops": flops / (ms * 1e-3) / 1e12,
            "bound_share": b_ms / ms})
    # the two-pass kernels batched (the route of a promoted expert cell:
    # fp8 tokens): quantize_rows and tiled_mm against their plain
    # versions and against one launch per expert
    for role, a, b in (("fwd w_up fp8 token", x, w_up),):
        before = {k_.name: k_.counts()["batched"]
                  for k_ in (qr.KERNEL, tm.KERNEL)}
        aq = qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3")
        bq = qr.quantize_rows(b, mode="token", fmt_name="fp8_e4m3",
                              trans=True, emit_trans=True)
        same_bits(aq, qr.quantize_rows_plain(a, mode="token",
                                             fmt_name="fp8_e4m3"),
                  f"quantize_rows {role} A")
        same_bits(bq, torch.stack([qr.quantize_rows(
            b[i], mode="token", fmt_name="fp8_e4m3", trans=True,
            emit_trans=True) for i in range(e)]),
            f"quantize_rows {role} B batched vs per expert")
        y, route = routed(tm.KERNEL, lambda: tm.tiled_mm(aq, bq))
        ref = tm.tiled_mm_plain(aq, bq)
        err = (y.float() - ref.float()).abs()
        if not bool((err <= 2.0 ** -7 * ref.float().abs()
                     + 1e-5 * ref.float().abs().max()).all()):
            raise AssertionError(f"tiled_mm {role} out of tolerance")
        same_bits(y, torch.stack([tm.tiled_mm(aq[i], bq[i])
                                  for i in range(e)]),
                  f"tiled_mm {role} batched vs per expert")
        if any(k_.counts()["batched"] <= before[k_.name]
               for k_ in (qr.KERNEL, tm.KERNEL)):
            raise AssertionError(f"{role}: a batched launch not counted")
        _, m, k = aq.shape
        n = bq.shape[2]
        flops = 2 * e * m * n * k
        b_ms, b_by = _bound(2 * e * (m * k + k * n + m * n), flops,
                            H100_BF16_FLOPS)
        ms = timer.ms(lambda: tm.tiled_mm(aq, bq), iters=5)
        rows.append({
            "name": "tiled_mm", "role": role, "shape": [e, m, k, n],
            "trans": False, "batched": True,
            "max_abs_err": err.max().item(), "ms": ms,
            "plain_ms": timer.ms(lambda: tm.tiled_mm_plain(aq, bq),
                                 iters=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.bmm(aq, bq), iters=5),
            "route": route, "tflops": flops / (ms * 1e-3) / 1e12,
            "bound_share": b_ms / ms})
        n_el = a.numel()
        q_ms, q_by = _bound(4 * n_el, 8 * n_el, H100_F32_FLOPS)
        rows.append({
            "name": "quantize_rows", "role": f"{role} A",
            "shape": list(a.shape), "trans": False, "batched": True,
            "max_abs_err": 0.0,
            "ms": timer.ms(lambda: qr.quantize_rows(
                a, mode="token", fmt_name="fp8_e4m3"), iters=5),
            "plain_ms": timer.ms(lambda: qr.quantize_rows_plain(
                a, mode="token", fmt_name="fp8_e4m3"), iters=2),
            "bound_ms": q_ms, "bound_by": q_by, "library_ms": None})
    torch.cuda.synchronize()
    emit({"phase": "moe_kernels", "card": card, "dtype": "bfloat16",
          "experts": e, "rows_per_expert": c, "ok": True, "table": rows})
    return rows


def phase_ssm_kernels(torch, card):
    """``qmm_stream`` at mamba2-780m's projection shapes (module
    docstring, phase 2's ``ssm_kernels`` line): the training step's
    forward, dgrad and wgrad of in_x (N 3072), in_b (N 128), in_dt (N 48,
    below one tile) and out_proj at 8192 tokens, and the packed decode
    shape (M = 8) of in_x and in_dt.  Each against its plain version, its
    QDQ panels bitwise, the stream kernel bitwise the two-pass pipeline;
    return per-call records."""
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels import tiled_mm as tm
    gen = torch.Generator(device="cuda").manual_seed(7)
    timer = Timer(torch)
    rows = []
    t, d, di = SSM_TOKENS, SSM_D, SSM_INNER

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def same_bits(y, ref, what):
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"{what} not bitwise equal")

    fp4 = dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
               b_fmt="fp4_e2m1")
    dgrad = dict(a_mode="pass", b_mode="pass", a_fmt="bf16", b_fmt="bf16",
                 trans_b=True)
    wgrad = dict(a_mode="block", b_mode="block", a_fmt="fp8_e4m3",
                 b_fmt="fp8_e5m2", trans_a=True)
    # a packed weight is expanded and fed through as a pass operand
    packed = dict(a_mode="block", b_mode="pass", a_fmt="fp4_e2m1",
                  b_fmt="bf16")
    x, h = rand(t, d, scale=2), rand(t, di, scale=2)
    xd = rand(SSM_SLOTS, d, scale=2)
    calls, weights = [], {}
    for name, n in (("in_x", di), ("in_b", SSM_GN), ("in_dt", SSM_HEADS)):
        w, g = rand(d, n, scale=0.05), rand(t, n, scale=0.01)
        weights[name] = w
        calls += [(f"fwd {name}", x, w, fp4), (f"dgrad {name}", g, w, dgrad),
                  (f"wgrad {name}", x, g, wgrad)]
    w_out, g_out = rand(di, d, scale=0.05), rand(t, d, scale=0.01)
    calls += [("fwd out_proj", h, w_out, fp4),
              ("dgrad out_proj", g_out, w_out, dgrad),
              ("wgrad out_proj", h, g_out, wgrad)]
    calls += [(f"decode {name}", xd, weights[name], packed)
              for name in ("in_x", "in_dt")]
    for role, a, b, kw in calls:
        ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
        y, route = routed(qs.KERNEL, lambda: qs.qmm_stream(a, b, **kw))
        ref = qs.qmm_stream_plain(a, b, **kw)
        yf, rf = y.float(), ref.float()
        err = (yf - rf).abs()
        if not bool((err <= 2.0 ** -7 * rf.abs()
                     + 1e-5 * rf.abs().max()).all()):
            raise AssertionError(f"qmm_stream {role} out of tolerance: max "
                                 f"err {err.max().item()}")
        aq = a if kw["a_mode"] == "pass" else qr.quantize_rows(
            a, mode=kw["a_mode"], fmt_name=kw["a_fmt"], trans=ta,
            emit_trans=ta)
        bq = b if kw["b_mode"] == "pass" else qr.quantize_rows(
            b, mode=kw["b_mode"], fmt_name=kw["b_fmt"], trans=not tb,
            emit_trans=not tb)
        for op, stored, q, mode, fmt, trans in (
                ("A", a, aq, kw["a_mode"], kw["a_fmt"], ta),
                ("B", b, bq, kw["b_mode"], kw["b_fmt"], not tb)):
            if mode != "pass":
                same_bits(q, qr.quantize_rows_plain(
                    stored, mode=mode, fmt_name=fmt, trans=trans,
                    emit_trans=trans), f"quantize_rows {role} {op}")
        same_bits(y, tm.tiled_mm(aq, bq, trans_a=ta, trans_b=tb),
                  f"qmm_stream {role} vs quantize_rows + tiled_mm")
        ae, be = (aq.T if ta else aq), (bq.T if tb else bq)
        (m, k), n = ae.shape, be.shape[1]
        b_ms, b_by = _bound(2 * (m * k + k * n + m * n), 2 * m * n * k,
                            H100_BF16_FLOPS)
        ms = timer.ms(lambda: qs.qmm_stream(a, b, **kw), iters=5)
        rows.append({
            "name": "qmm_stream", "role": role, "shape": [m, k, n],
            "trans": ta or tb, "max_abs_err": err.max().item(), "ms": ms,
            "plain_ms": timer.ms(lambda: qs.qmm_stream_plain(a, b, **kw),
                                 iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.matmul(ae, be), iters=5),
            **gemm_fields(route, m, k, n, ms, b_ms)})
    torch.cuda.synchronize()
    emit({"phase": "ssm_kernels", "card": card, "dtype": "bfloat16",
          "tokens": t, "ok": True, "table": rows})
    return rows


def check_stats(torch, got, ref, what):
    """A stats vector against its plain version: lanes 0-2 and 5-7
    bitwise, 3-4 within STATS_RTOL.  Returns (worst relative difference of
    lanes 3-4, whether all eight lanes are bitwise equal)."""
    got, ref = got.cpu(), ref.cpu()
    lanes = [0, 1, 2, 5, 6, 7]
    if not torch.equal(got[lanes], ref[lanes]):
        raise AssertionError(f"{what}: stats lanes 0-2 / 5-7 differ: "
                             f"{got.tolist()} vs {ref.tolist()}")
    rel = float(((got[3:5] - ref[3:5]).abs()
                 / ref[3:5].abs().clamp_min(1e-30)).max())
    if not rel <= STATS_RTOL:
        raise AssertionError(f"{what}: stats lanes 3-4 off by {rel}")
    return rel, bool(torch.equal(got, ref))


def phase_telemetry_kernels(torch, card):
    """Stochastic rounding, the stats epilogue and quantize_blockwise at
    the training shapes (8192 tokens, bf16), each against its plain
    version, with its time beside the same kernel with the mode off."""
    from repro_torch.core.qlinear import ZERO_KEY
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize as qb
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels import tiled_mm as tm
    from repro_torch.kernels.rounding import fold_seed
    gen = torch.Generator(device="cuda").manual_seed(2)
    timer = Timer(torch)
    rows, checks = [], {}
    t, d, f = TRAIN_TOKENS, 768, 3072
    seed = fold_seed(ZERO_KEY, 4, 1)      # the FFN wgrad's B operand

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def bitwise(y, ref, what):
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"{what} not bitwise equal")

    def gemm_err(y, ref, what):
        y, ref = y.float(), ref.float()
        err = (y - ref).abs()
        if not bool((err <= 2.0 ** -7 * ref.abs()
                     + 1e-5 * ref.abs().max()).all()):
            raise AssertionError(f"{what} out of tolerance: max err "
                                 f"{err.max().item()}")
        return err.max().item()

    def row(name, mode, shape, fn, off_fn, plain_fn, bound, err=0.0,
            iters=10, **extra):
        b_ms, b_by = bound
        rows.append({"name": name, "mode": mode, "shape": list(shape),
                     "max_abs_err": err, "ms": timer.ms(fn, iters=iters),
                     "mode_off_ms": timer.ms(off_fn, iters=iters),
                     "plain_ms": timer.ms(plain_fn, iters=3),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     **extra})

    x, g_f = rand(t, d, scale=2), rand(t, f, scale=0.01)
    w_up = rand(d, f, scale=0.05)
    n = x.numel()
    # element ops: QDQ ~8, the counter hash ~16 more, the stats ~12 more
    qdq_bound = {"rtn": _bound(4 * n, 8 * n, H100_F32_FLOPS),
                 "sr": _bound(4 * n, 24 * n, H100_F32_FLOPS),
                 "stats": _bound(4 * n, 20 * n, H100_F32_FLOPS)}

    # quantize_rows with SR: token and block, read in place or transposed
    for mode, fmt in (("token", "fp8_e5m2"), ("block", "fp4_e2m1")):
        for trans in (False, True):
            kw = dict(mode=mode, fmt_name=fmt, trans=trans, emit_trans=trans)
            y = qr.quantize_rows(x, sr=True, seed=seed, **kw)
            bitwise(y, qr.quantize_rows_plain(x, seed=seed, **kw),
                    f"quantize_rows {mode} sr trans={trans}")
            if torch.equal(y, qr.quantize_rows(x, **kw)):
                raise AssertionError("SR equals RTN")
            row("quantize_rows", f"{mode} sr", x.shape,
                lambda: qr.quantize_rows(x, sr=True, seed=seed, **kw),
                lambda: qr.quantize_rows(x, **kw),
                lambda: qr.quantize_rows_plain(x, seed=seed, **kw),
                qdq_bound["sr"], trans=trans)
    # the stats epilogue of quantize_rows: the attention forward's x
    kw = dict(mode="token", fmt_name="fp8_e4m3")
    y, st = qr.quantize_rows(x, collect_stats=True, **kw)
    y_ref, st_ref = qr.quantize_rows_plain(x, collect_stats=True, **kw)
    bitwise(y, y_ref, "quantize_rows token with stats")
    checks["quantize_rows_stats"] = check_stats(torch, st, st_ref,
                                                "quantize_rows token")
    row("quantize_rows", "token stats", x.shape,
        lambda: qr.quantize_rows(x, collect_stats=True, **kw),
        lambda: qr.quantize_rows(x, **kw),
        lambda: qr.quantize_rows_plain(x, collect_stats=True, **kw),
        qdq_bound["stats"], trans=False)

    # qmm_stream, the FFN wgrad of fine_grained_fp4: x read transposed,
    # the gradient operand rounded stochastically (b_sr)
    fp4 = dict(a_fmt="fp4_e2m1", b_fmt="fp4_e2m1")
    kw = dict(a_mode="block", b_mode="block", trans_a=True, **fp4)
    y = qs.qmm_stream(x, g_f, b_sr=True, seed_b=seed, **kw)
    err = gemm_err(y, qs.qmm_stream_plain(x, g_f, seed_b=seed, **kw),
                   "qmm_stream wgrad b_sr")
    aq = qr.quantize_rows(x, mode="block", fmt_name="fp4_e2m1", trans=True,
                          emit_trans=True)
    bkw = dict(mode="block", fmt_name="fp4_e2m1", trans=True,
               emit_trans=True)
    bq = qr.quantize_rows(g_f, sr=True, seed=seed, **bkw)
    bitwise(bq, qr.quantize_rows_plain(g_f, seed=seed, **bkw),
            "the wgrad's SR gradient panel")
    bitwise(y, tm.tiled_mm(aq, bq, trans_a=True),
            "qmm_stream wgrad b_sr vs quantize_rows + tiled_mm")
    row("qmm_stream", "wgrad b_sr", (d, t, f),
        lambda: qs.qmm_stream(x, g_f, b_sr=True, seed_b=seed, **kw),
        lambda: qs.qmm_stream(x, g_f, **kw),
        lambda: qs.qmm_stream_plain(x, g_f, seed_b=seed, **kw),
        _bound(2 * (t * d + t * f + d * f), 2 * t * d * f, H100_BF16_FLOPS),
        err, iters=5, trans=True)
    # the stats epilogue of qmm_stream: the FFN forward, both operands
    kw = dict(a_mode="block", b_mode="tile", **fp4)
    y, st = qs.qmm_stream(x, w_up, collect_stats=True, **kw)
    y_ref, st_ref = qs.qmm_stream_plain(x, w_up, collect_stats=True, **kw)
    err = gemm_err(y, y_ref, "qmm_stream fwd with stats")
    y2, st2 = fm.fused_qmm(x, w_up, pipeline="two_pass", collect_stats=True,
                           **kw)
    bitwise(y, y2, "qmm_stream fwd with stats vs two-pass")
    for i, op in enumerate("ab"):
        checks[f"qmm_stream_stats_{op}"] = check_stats(
            torch, st[i], st_ref[i], f"qmm_stream stats {op}")
        if not torch.equal(st[i], st2[i]):
            raise AssertionError(f"stream stats {op} != two-pass stats")
    checks["stream_stats_equal_two_pass"] = True
    row("qmm_stream", "fwd stats", (t, d, f),
        lambda: qs.qmm_stream(x, w_up, collect_stats=True, **kw),
        lambda: qs.qmm_stream(x, w_up, **kw),
        lambda: qs.qmm_stream_plain(x, w_up, collect_stats=True, **kw),
        _bound(2 * (t * d + d * f + t * f), 2 * t * d * f, H100_BF16_FLOPS),
        err, iters=5, trans=False)

    # SR is unbiased on the card: 64 rows of [0.01 .. 5.9, 6.0] (token
    # scale exactly 1, so the QDQ is the grid rounding itself), fp4, 64
    # seeds: 4096 draws a value (tests/test_rounding.py: 4000, 5 sigma)
    v = torch.cat([torch.linspace(0.01, 5.9, 97), torch.tensor([6.0])])
    xs = v.expand(64, 98).contiguous().cuda()
    acc = torch.zeros(97, dtype=torch.float64, device="cuda")
    for s_ in range(64):
        acc += qr.quantize_rows(xs, mode="token", fmt_name="fp4_e2m1",
                                sr=True, seed=s_)[:, :97].double().sum(0)
    dev = acc.cpu() / (64 * 64) - v[:97].double()
    sr_mean = {"max_abs_dev": float(dev.abs().max()),
               "mean_dev": float(dev.mean()), "bounds": [0.08, 0.01],
               "seeds": 64, "draws": 64 * 64}
    if not (sr_mean["max_abs_dev"] < 0.08 and abs(sr_mean["mean_dev"])
            < 0.01):
        raise AssertionError(f"SR is biased on the card: {sr_mean}")

    # quantize_blockwise (_q_kernel's port): tiles and rows, f32 and bf16,
    # at the training shape, llama-1b's ragged w_gate and a ragged shape
    for shape in ((t, d), (1280, 3392), (1000, 300)):
        for dt in (torch.bfloat16, torch.float32):
            xb = (torch.randn(*shape, generator=gen, device="cuda")
                  * 2).to(dt)
            nb = xb.numel()
            for per_row in (False, True):
                kw = dict(fmt_name="fp4_e2m1", per_row=per_row)
                y = qb.quantize_blockwise(xb, **kw)
                ref = qb.quantize_blockwise_plain(xb, **kw)
                torch.cuda.synchronize()
                if not torch.equal(y.view(torch.int16 if dt == torch.bfloat16
                                          else torch.int32),
                                   ref.view(torch.int16 if dt ==
                                            torch.bfloat16 else torch.int32)):
                    raise AssertionError(f"quantize_blockwise {shape} {dt} "
                                         f"per_row={per_row} not bitwise")
                if shape == (1000, 300):
                    continue
                # each element read once and written once; ~8 ops each
                b_ms, b_by = _bound(2 * nb * xb.element_size(), 8 * nb,
                                    H100_F32_FLOPS)
                rows.append({
                    "name": "quantize_blockwise",
                    "mode": "per_row" if per_row else "tile",
                    "shape": list(shape), "dtype": str(dt).split(".")[1],
                    "max_abs_err": 0.0,
                    "ms": timer.ms(lambda: qb.quantize_blockwise(xb, **kw),
                                   iters=50),
                    "plain_ms": timer.ms(
                        lambda: qb.quantize_blockwise_plain(xb, **kw),
                        iters=5),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                if dt == torch.bfloat16 and not per_row:
                    # one trace a shape (a per-row launch has the same
                    # grid); kept few: every profiler session raises the
                    # host cost of later launches (the decode p50)
                    rows[-1]["blocks"] = kernel_blocks(
                        torch, lambda: qb.quantize_blockwise(xb, **kw))
    torch.cuda.synchronize()
    emit({"phase": "telemetry_kernels", "card": card, "dtype": "bfloat16",
          "tokens": t, "ok": True, "stats_rtol": STATS_RTOL,
          "stats_checks": {k: (c if isinstance(c, bool) else
                               {"lanes_3_4_rel": c[0], "bitwise": c[1]})
                           for k, c in checks.items()},
          "sr_mean_on_card": sr_mean, "table": rows})
    return rows


def profile_decode(torch, engine, card, steps: int = 5,
                   phase: str = "profile") -> None:
    """Split of the batched decode step from a ``torch.profiler`` trace of
    ``steps`` steps: device time per step by kernel group, and the
    device's busy share (summed device time over the window's wall time).
    Prints "not measured" for the device numbers if the trace holds no
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.generate_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.generate_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    groups = (("qmm_stream", ("qmm_stream_kernel", "qmm_stream_tc_kernel")),
              ("quantize_rows", QUANTIZE_ROWS_KERNELS),
              ("tiled_mm", ("tiled_mm_kernel", "tiled_mm_tc_kernel")),
              ("cublas_gemm", ("gemm", "xmma", "cutlass", "Kernel2")),
              ("memcpy_memset", ("Memcpy", "Memset")))
    by_group, by_name = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        ms = ev.self_device_time_total / 1e3 / steps
        if ms <= 0:
            continue
        group = next((g for g, keys in groups
                      if any(k in ev.key for k in keys)), "other_torch")
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[ev.key[:80]] = ms
    busy = sum(by_group.values()) if by_group else None
    emit({"phase": phase, "card": card, "steps": steps,
          "wall_ms_per_step": wall_ms,
          "device_ms_per_step": busy if busy else "not measured",
          "device_busy_share": busy / wall_ms if busy else "not measured",
          "device_ms_per_step_by_group": by_group,
          "top_kernels_ms_per_step": dict(sorted(
              by_name.items(), key=lambda kv: -kv[1])[:8])})


class OpRecorder:
    """Records every ``qlinear`` and ``chunked_attention`` call of a
    forward (inputs and output) while it is entered, by wrapping the names
    the model's modules call them by."""

    def __enter__(self):
        from repro_torch.models import attention
        from repro_torch.nn import layers
        self.calls = []
        self._saved = [(layers, "qlinear", layers.qlinear),
                       (attention, "chunked_attention",
                        attention.chunked_attention)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kw):
            y = fn(*args, **kw)
            self.calls.append((name, fn, args, kw, y))
            return y
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def replay_on_cpu(torch, calls):
    """Each recorded card call again on the CPU on the card's inputs:
    (worst output relative L2, quantized activations that differ, calls).
    A linear's activation quantization is checked bitwise: the card's
    kernel against the plain version on the CPU."""
    from repro_torch.core.qlinear import kernel_quant_mode
    from repro_torch.kernels import quantize_rows as qr

    def cpu(t):
        return t.to("cpu") if hasattr(t, "to") else t
    worst, q_diff = 0.0, 0
    for name, fn, args, kw, y in calls:
        ref = fn(*[cpu(a) for a in args], **kw).double()
        err = float((y.cpu().double() - ref).norm()
                    / max(float(ref.norm()), 1e-30))
        worst = max(worst, err)
        spec = args[2].fwd_x if name == "qlinear" else None
        if spec is not None and not spec.is_passthrough:
            x = args[0].reshape(-1, args[0].shape[-1]).contiguous()
            kw_q = dict(mode=kernel_quant_mode(spec), fmt_name=spec.fmt)
            q_diff += int((qr.quantize_rows(x, **kw_q).cpu()
                           != qr.quantize_rows_plain(x.cpu(), **kw_q))
                          .sum())
    return worst, q_diff, len(calls)


def teacher_forced(torch, cfg, params, recipe, toks):
    """Teacher-forced logits of ``toks`` on the card against the same port
    on the CPU: op by op (gated by OP_BOUND, quantized activations
    bitwise) and end to end (bf16 gated by TF_BOUND, with a control that
    must fail it).  Raises on a miss."""
    from repro_torch.core.packed import PackedTensor
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_map
    cpu_params = tree_map(lambda p: p.to("cpu"), params)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    tf, failures = {}, []
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        ref = build_model(c, "cpu").forward(cpu_params, toks, recipe).float()
        with OpRecorder() as rec:
            card = build_model(c).forward(params, toks.cuda(), recipe)
        op_err, q_diff, n_ops = replay_on_cpu(torch, rec.calls)
        del rec
        card = card.float().cpu()
        per_pos = (card - ref).norm(dim=-1) / ref.norm(dim=-1)
        tf[dtype] = {"tokens": toks.shape[1], "ops_replayed": n_ops,
                     "op_rel_l2_max": op_err, "op_bound": OP_BOUND[dtype],
                     "quantized_activations_differing": q_diff,
                     "rel_l2": rel(card, ref),
                     "rel_l2_position_0": float(per_pos[0, 0]),
                     "argmax_agreement": float(
                         (card.argmax(-1) == ref.argmax(-1)).float().mean())}
        if not op_err <= OP_BOUND[dtype] or q_diff:
            failures.append(f"{dtype}: op replay rel L2 {op_err} (bound "
                            f"{OP_BOUND[dtype]}), {q_diff} quantized "
                            "activations differ")
        if dtype == "bfloat16":
            tf[dtype]["bound"] = TF_BOUND
            if not rel(card, ref) <= TF_BOUND:
                failures.append(f"bf16 rel L2 {rel(card, ref)} > {TF_BOUND}")
            # Control: layer 0's w_up with every scale doubled.
            bad = tree_map(lambda p: p, params)      # new dicts, same leaves
            stack = bad["stack"]
            if "layers" in stack:
                ffn = stack["layers"][0]["ffn"]
                w = ffn["w_up"]
                scale = w.scale * 2
            else:                                    # leading layers axis
                ffn = stack["groups"]["l00"]["ffn"]
                w = ffn["w_up"]
                scale = w.scale.clone()
                scale[0] *= 2
            ffn["w_up"] = PackedTensor(w.payload, scale, w.fmt, w.block,
                                       w.n_cols, w.ddtype)
            ctrl = build_model(c).forward(bad, toks.cuda(), recipe)
            tf[dtype]["control_rel_l2"] = rel(ctrl.float().cpu(), ref)
            if not tf[dtype]["control_rel_l2"] > TF_BOUND:
                failures.append("the control landed within the bound: "
                                f"{tf[dtype]['control_rel_l2']}")
    if failures:
        raise AssertionError("teacher-forced card vs CPU: "
                             + "; ".join(failures))
    return tf


def timed_stages(torch, engine, prefill_ms, step_ms):
    """Wrap ``engine``'s prefill (per bucket, to a device sync) and
    decode step (host clock; the step ends in a device -> host copy) in
    timers; returns a function that unwraps them."""
    orig_prefill, orig_step = engine.prefill, engine.generate_step

    def timed_prefill(prompt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms.setdefault(engine.bucket(len(prompt)), []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def timed_step():
        t0 = time.perf_counter()
        out = orig_step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.prefill, engine.generate_step = timed_prefill, timed_step

    def restore():
        engine.prefill, engine.generate_step = orig_prefill, orig_step
    return restore


def stage_counts(engine):
    """Captures and replays of each of the engine's stages (an eager
    stage, a plain method, has none)."""
    return {name: {"captures": getattr(st, "captures", 0),
                   "replays": getattr(st, "replays", 0)}
            for name, st in engine.stages.items()}


def serve_run(torch, batcher, prompts, new_tokens, kernels, idle=()):
    """Serve ``prompts`` through ``batcher`` with every counter of
    ``kernels`` set to 0 first; returns (tokens by request, launches by
    kernel, prefill ms by bucket, decode-step ms, wall s, peak bytes).
    Raises unless every request got ``new_tokens`` tokens and every
    kernel launched but those named in ``idle`` (counted all the same)."""
    prefill_ms, step_ms = {}, []
    restore = timed_stages(torch, batcher.engine, prefill_ms, step_ms)
    ids = [batcher.submit(p, new_tokens) for p in prompts]
    for kern in kernels:
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    restore()
    if any(len(out.get(i, ())) != new_tokens for i in ids):
        raise AssertionError("batcher did not serve every request in full")
    if any(n <= 0 for k, n in launches.items() if k not in idle):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    return [out[i] for i in ids], launches, prefill_ms, step_ms, wall, peak


def check_sequential(torch, engine, prompt, tokens, what):
    """``tokens`` (the engine's) against the sequential ``generate``
    (captured stages), token for token."""
    from repro_torch.train.serve import generate
    ref = generate(engine.model, engine.params, torch.from_numpy(prompt)[None],
                   max_new_tokens=len(tokens), recipe=engine.recipe)
    ref = ref[0, len(prompt):].tolist()
    if tokens != ref:
        first = next(i for i, (a, b) in enumerate(zip(tokens, ref))
                     if a != b)
        raise AssertionError(f"{what}: engine != sequential generate from "
                             f"token {first}")


def engine_checks(torch, engine, prompts, out, make, n_eager, kernels,
                  what, idle=()):
    """The captured ``engine``'s tokens (``out``) against an eager
    engine's (``make(jit=False)``, warmed up on one short request) on the
    first ``n_eager`` requests, and against the sequential ``generate``
    on requests 0 and 1.  Returns the eager run's (launches, prefill ms
    by bucket, decode-step ms); raises on a miss."""
    eager = make(jit=False)
    eager.submit(prompts[0][:16], 2)
    eager.run()
    eager_out, eager_launches, eager_prefill_ms, eager_step_ms, _, _ = \
        serve_run(torch, eager, prompts[:n_eager], len(out[0]), kernels,
                  idle)
    del eager
    if eager_out != out[:n_eager]:
        raise AssertionError(f"{what}: captured engine != eager engine")
    for i in range(2):
        check_sequential(torch, engine, prompts[i], out[i],
                         f"{what} request {i}")
    return eager_launches, eager_prefill_ms, eager_step_ms


def phase_slice(torch, card):
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, quantize_weights_for_serving,
        serving_memory_report)

    cfg = get_config("gpt2-125m").replace(linear_impl="pallas")
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    params = quantize_weights_for_serving(model, model.init(seed=0),
                                          "fp4_e2m1")
    mem = serving_memory_report(params)
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in lengths]
    new_tokens = 64
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)

    def make(jit):
        return ContinuousBatcher(model, params, n_slots=8, max_len=1024,
                                 recipe=recipe, kv_format="fp8_e4m3",
                                 jit=jit)

    # Warm-up, not timed: one request per prompt bucket of the run, so
    # the captured engine captures each stage (and each bucket's prefill)
    # here and the timed run only replays.
    batcher = make(jit=True)
    engine = batcher.engine
    buckets = sorted({engine.bucket(len(p)) for p in prompts})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in buckets:
        batcher.submit(np.arange(n) % cfg.vocab_size, 2)
    batcher.run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    warm_counts = stage_counts(engine)
    out, launches, prefill_ms, step_ms, wall, peak = serve_run(
        torch, batcher, prompts, new_tokens, kernels)
    counts = stage_counts(engine)
    run_counts = {name: {k: n - warm_counts[name][k] for k, n in c.items()}
                  for name, c in counts.items()}
    if any(c["captures"] for c in run_counts.values()):
        raise AssertionError(f"the timed run captured: {run_counts}")

    # The eager engine (jit=False) on the first SLICE_EAGER requests: the
    # same tokens, its decode p50 beside the captured one's; and the
    # sequential generate on 2 requests, token-exact.
    eager_launches, eager_prefill_ms, eager_step_ms = engine_checks(
        torch, engine, prompts, out, make, SLICE_EAGER, kernels, "slice")

    profile_decode(torch, engine, card)

    # Teacher-forced logits of request 0 (its prompt and generated
    # tokens, first TF_TOKENS), card vs CPU with the same packed weights;
    # the CPU runs the kernels' plain versions.
    seq = np.concatenate([prompts[0], np.asarray(out[0])])
    tf = teacher_forced(torch, cfg, params, recipe,
                        torch.from_numpy(seq[:TF_TOKENS])[None])

    n_gen = sum(len(v) for v in out)
    emit({"phase": "slice", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "requests": len(prompts), "new_tokens": new_tokens,
          "prompt_lengths": [int(n) for n in lengths],
          "jit": True, "capture_warmup_s": capture_s,
          "stages_warmup": warm_counts, "stages_run": run_counts,
          "prefill_ms_by_bucket": {
              str(b): float(np.median(v)) for b, v in
              sorted(prefill_ms.items())},
          "prefill_count_by_bucket": {
              str(b): len(v) for b, v in sorted(prefill_ms.items())},
          "decode_step_p50_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "eager": {"requests": SLICE_EAGER,
                    "decode_step_p50_ms": float(np.median(eager_step_ms)),
                    "decode_steps": len(eager_step_ms),
                    "prefill_ms_by_bucket": {
                        str(b): float(np.median(v)) for b, v in
                        sorted(eager_prefill_ms.items())},
                    "launches": eager_launches,
                    "tokens_vs_captured": "equal"},
          "launches": launches,
          "tokens_per_s": n_gen / wall, "wall_s": wall,
          "max_memory_allocated": int(peak),
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "engine_vs_sequential": "token-exact (2 requests)",
          "teacher_forced_card_vs_cpu": tf})
    return launches


def serve_cache_bytes(cfg, n_slots, max_len):
    """Bytes of the engine's per-slot serving cache (every layer of its
    kind, lengths included) from the cache specs, allocating nothing: an
    attention layer's K/V, a mamba layer's conv history and state."""
    import torch
    from repro_torch.models.attention import attn_cache_spec
    from repro_torch.models.ssm import mamba_cache_spec
    total = 4 * n_slots
    for spec in cfg.layer_specs():
        layer = (attn_cache_spec(cfg, n_slots, max_len, torch.bfloat16,
                                 per_slot=True) if spec.mixer == "attn"
                 else mamba_cache_spec(cfg, n_slots, torch.bfloat16))
        total += sum(int(np.prod(shape)) * torch.empty(
            (), dtype=dt).element_size() for shape, dt in layer.values())
    return total


def held_cache_bytes(cache):
    return sum(t.numel() * t.element_size()
               for layer in cache["stack"]["layers"]
               for t in layer["self"].values()) + \
        cache["length"].numel() * cache["length"].element_size()


def ring_check(torch, cfg, params, seq):
    """Request 0's tokens teacher-forced through an f32 engine (bf16
    recipe, packed weights, bf16 KV): the first ring's worth prefilled,
    every later token decoded one step at a time, past the window.  Its
    logits against the windowed no-cache forward on the same tokens
    (RING_BOUND), and the control, the forward with no window, which
    must miss it."""
    from repro_torch.core.recipe import RECIPES
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import DecodeEngine
    recipe = RECIPES["bf16"]
    c32 = cfg.replace(dtype="float32")
    ring = cfg.sliding_window
    engine = DecodeEngine(build_model(c32), params, n_slots=1,
                          max_len=SWA_MAX_LEN, recipe=recipe)
    tok, c1 = engine.prefill(seq[:ring])
    engine.insert(c1, int(seq[ring]), 0)
    got = []
    t0 = time.perf_counter()
    for p in range(ring, len(seq)):
        engine.last_tok[0] = seq[p]
        engine.generate_step()
        # A copy: the logits are the step graph's output buffer.
        got.append(engine.last_logits[0, 0].to(torch.float32, copy=True))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    got = torch.stack(got)
    del engine
    toks = torch.from_numpy(seq)[None].cuda()

    def forward(c):
        with torch.no_grad():
            return build_model(c).forward(params, toks, recipe)[
                0, ring:].float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    fwd = forward(c32)
    err = rel(got, fwd)
    ctrl = rel(forward(c32.replace(sliding_window=0)), fwd)
    out = {"dtype": "float32", "recipe": "bf16", "kv": "bfloat16",
           "prefilled": ring, "decoded_past_window": len(seq) - ring,
           "decode_s": decode_s, "rel_l2": err, "bound": RING_BOUND,
           "control_no_window_rel_l2": ctrl,
           "argmax_agreement": float(
               (got.argmax(-1) == fwd.argmax(-1)).float().mean())}
    if not err <= RING_BOUND < ctrl:
        raise AssertionError(f"ring check: {out}")
    return out


class KernelRecorder:
    """While entered, records every call of the three GEMM kernels'
    wrappers, as ``kernels.fp4_matmul`` makes them, in the layers
    ``layers`` (the stack's layer scope, ``core.routing``): a copy of the
    card's inputs and output, the plain version and the route the launch
    took (by the kernel's tensor-core counter), for ``replay_plain``."""

    def __init__(self, layers):
        self.layers = layers

    def __enter__(self):
        from repro_torch.kernels import fp4_matmul
        from repro_torch.kernels import qmm_stream as qs
        from repro_torch.kernels import quantize_rows as qr
        from repro_torch.kernels import tiled_mm as tm
        self.calls = []
        plain = {"quantize_rows": (qr.KERNEL, qr.quantize_rows_plain),
                 "tiled_mm": (tm.KERNEL, tm.tiled_mm_plain),
                 "qmm_stream": (qs.KERNEL, qs.qmm_stream_plain)}
        self._saved = [(fp4_matmul, name, getattr(fp4_matmul, name))
                       for name in plain]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._wrap(name, fn, *plain[name]))
        return self

    def _wrap(self, name, fn, kern, plain):
        from repro_torch.core import routing

        def call(*args, **kw):
            tc = kern.tc_launches
            y = fn(*args, **kw)
            label = routing.current_layer()
            if label is not None and int(label[1:]) in self.layers:
                self.calls.append({
                    "name": name, "layer": int(label[1:]), "plain": plain,
                    "args": [a.clone() for a in args], "kw": dict(kw),
                    "out": y.clone(),
                    "route": ("tensor_core" if kern.tc_launches > tc
                              else "fma")})
            return y
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def replay_plain(torch, calls, stage):
    """Each recorded call again through its plain version on the card on
    the same inputs: rows of (stage, layer, kernel, shape, route, bitwise
    for a quantize pass, rel L2 for a product), and the control: the
    first ``qmm_stream`` call with its activation left unquantized.
    Raises on a stochastic call: serving rounds to nearest."""
    rows, control = [], None

    def rel(y, ref):
        y, ref = y.double(), ref.double()
        return float((y - ref).norm() / max(float(ref.norm()), 1e-30))
    for c in calls:
        kw = dict(c["kw"])
        if any(kw.pop(k, False) for k in ("sr", "a_sr", "b_sr")):
            raise AssertionError(f"{stage}: a stochastic {c['name']} call")
        a, y = c["args"][0], c["out"]
        ref = c["plain"](*c["args"], **kw)
        row = {"stage": stage, "layer": c["layer"], "kernel": c["name"],
               "route": c["route"]}
        if c["name"] == "quantize_rows":
            row["shape"] = list(a.shape)
            row["bitwise"] = torch.equal(y.view(torch.int16),
                                         ref.view(torch.int16))
        else:   # [M, K, N], or [E, M, K, N] for a batched call
            row["shape"] = [*a.shape, c["args"][1].shape[-1]]
            row["rel_l2"] = rel(y, ref)
            row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
            if c["name"] == "qmm_stream" and control is None:
                control = rel(y, c["plain"](*c["args"],
                                            **{**kw, "a_mode": "pass"}))
        rows.append(row)
    return rows, control


def engine_replay(torch, engine, prompt, layers, what):
    """The GEMM kernels at a serving path's own shapes against their plain
    versions: one exact-length prefill of ``prompt`` and one batched
    decode step of the eager ``engine``, every call in ``layers``
    recorded (``KernelRecorder``) and replayed on the card
    (``replay_plain``).  Returns (rows, the summary for the phase's line);
    raises on a product past OP_BOUND, a quantize pass that is not
    bitwise, or a stage whose control does not miss the bound."""
    with KernelRecorder(layers) as pre:
        tok, c1 = engine.prefill(prompt)
    engine.insert(c1, tok, 0)
    with KernelRecorder(layers) as dec:
        engine.generate_step()
    del c1
    return replay_stages(torch, (("prefill", pre), ("decode", dec)), layers,
                         what)


def replay_stages(torch, stages, layers, what):
    """``replay_plain`` of each (stage, ``KernelRecorder``) in ``stages``:
    (rows, the summary for the phase's line); raises on a product past
    OP_BOUND, a quantize pass that is not bitwise, or a stage whose
    control does not miss the bound."""
    bound = OP_BOUND["bfloat16"]
    rows, controls = [], []
    for stage, rec in stages:
        r, ctrl = replay_plain(torch, rec.calls, stage)
        rows += r
        controls.append(ctrl)
        del rec.calls
    worst = max((r["rel_l2"] for r in rows if "rel_l2" in r), default=None)
    not_bitwise = sum(r.get("bitwise") is False for r in rows)
    by_call = {}
    for r in rows:
        key = (f"{r['stage']} L{r['layer']} {r['kernel']} {r['shape']} "
               f"{r['route']}")
        by_call[key] = max(by_call.get(key, 0.0), r.get("rel_l2", 0.0))
    out = {"layers": list(layers), "calls": len(rows),
           "rel_l2_max": worst, "bound": bound,
           "quantized_not_bitwise": not_bitwise,
           "rel_l2_max_by_call": by_call,
           "control_activation_unquantized": dict(
               zip((stage for stage, _ in stages), controls))}
    if worst is None or not worst <= bound or not_bitwise or \
            any(c is None or not c > bound for c in controls):
        raise AssertionError(f"{what} kernel replay: {out}")
    return rows, out


def calls_by_layer(rows, stage, layer):
    """{kernel: calls} of one stage and layer of ``engine_replay``'s rows."""
    got = {}
    for r in rows:
        if r["stage"] == stage and r["layer"] == layer:
            got[r["kernel"]] = got.get(r["kernel"], 0) + 1
    return got


def swa_kernel_replay(torch, cfg, params, recipe, prompt):
    """``engine_replay`` at serve_swa's own shapes: an eager engine of
    ``SWA_SLOTS`` slots (so the decode's M = 4), layers
    ``SWA_REPLAY_LAYERS``.  Raises on a miss, a missing call or a shape
    not covered."""
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import DecodeEngine
    engine = DecodeEngine(build_model(cfg), params, n_slots=SWA_SLOTS,
                          max_len=SWA_MAX_LEN, recipe=recipe,
                          kv_format="fp8_e4m3", jit=False)
    rows, out = engine_replay(torch, engine, prompt, SWA_REPLAY_LAYERS,
                              "serve_swa")
    del engine
    failures = []
    for stage in ("prefill", "decode"):
        for layer in SWA_REPLAY_LAYERS:
            got = calls_by_layer(rows, stage, layer)
            if got != SWA_CALLS_PER_LAYER:
                failures.append(f"{stage} layer {layer} calls {got}")
    shapes = {(r["kernel"], tuple(r["shape"])) for r in rows}
    want = {"ragged N 960": any(k == "tiled_mm" and s[2] == 960
                                for k, s in shapes),
            "K 10240": any(k == "qmm_stream" and s[1] == 10240
                           for k, s in shapes),
            "M 4": any(s[0] == SWA_SLOTS for _, s in shapes),
            "M prompt": any(s[0] == len(prompt) for _, s in shapes)}
    if not all(want.values()):
        failures.append(f"shapes not covered: {want}")
    if failures:
        raise AssertionError(f"serve_swa kernel replay: {failures}; {out}")
    return out


def phase_serve_swa(torch, card):
    """h2o-danube-3-4b at full width (``SWA_LAYERS`` layers) through the
    packed-FP4 ``ContinuousBatcher`` with its ring-window caches (module
    docstring, phase 3b)."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, quantize_weights_for_serving,
        serving_memory_report)

    cfg = get_config("h2o-danube-3-4b").replace(linear_impl="pallas",
                                                n_layers=SWA_LAYERS)
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = quantize_weights_for_serving(
        model, model.init(seed=0, on_device=True), "fp4_e2m1")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem = serving_memory_report(params)
    rng = np.random.default_rng(0)
    lengths = rng.integers(SWA_PROMPT[0], SWA_PROMPT[1] + 1,
                           size=SWA_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in lengths]
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)
    batcher = ContinuousBatcher(model, params, n_slots=SWA_SLOTS,
                                max_len=SWA_MAX_LEN, recipe=recipe,
                                kv_format="fp8_e4m3")
    engine = batcher.engine
    ring = engine.cache["stack"]["layers"][0]["self"]["pos"].shape[-1]
    kv_bytes = {str(n): serve_cache_bytes(engine.model.cfg, SWA_SLOTS, n)
                for n in (cfg.sliding_window, SWA_MAX_LEN)}
    held = held_cache_bytes(engine.cache)
    if ring != cfg.sliding_window or len(set(kv_bytes.values())) != 1 \
            or held != kv_bytes[str(SWA_MAX_LEN)]:
        raise AssertionError(f"ring {ring}, KV bytes {kv_bytes}, held "
                             f"{held}")
    # Warm-up, not timed: captures insert and the batched step.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batcher.submit(prompts[0][:16], 2)
    batcher.run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    warm_counts = stage_counts(engine)
    out, launches, prefill_ms, step_ms, wall, peak = serve_run(
        torch, batcher, prompts, SWA_NEW, kernels)
    counts = stage_counts(engine)
    past = [int(n) + SWA_NEW - 1 > cfg.sliding_window for n in lengths]
    if not all(past):
        raise AssertionError(f"a request stays inside the window: {past}")
    t0 = time.perf_counter()
    check_sequential(torch, engine, prompts[0], out[0], "request 0")
    sequential_s = time.perf_counter() - t0
    profile_decode(torch, engine, card, phase="serve_swa_profile")
    del batcher, engine
    gc.collect()
    torch.cuda.empty_cache()
    replay = swa_kernel_replay(torch, cfg, params, recipe, prompts[0])
    gc.collect()
    torch.cuda.empty_cache()
    seq = np.concatenate([prompts[0], np.asarray(out[0])])
    ring_out = ring_check(torch, cfg, params, seq)
    n_gen = sum(len(v) for v in out)
    prefill = [v for vs in prefill_ms.values() for v in vs]
    emit({"phase": "serve_swa", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "sliding_window": cfg.sliding_window, "slots": SWA_SLOTS,
          "max_len": SWA_MAX_LEN, "ring_positions": ring,
          "requests": len(prompts), "new_tokens": SWA_NEW,
          "prompt_lengths": [int(n) for n in lengths],
          "init_and_pack_s": init_s, "capture_warmup_s": capture_s,
          "stages": counts,
          "prefill_exact_length_ms": {
              str(n): float(np.median(v)) for n, v in
              sorted(prefill_ms.items())},
          "prefill_ms_median": float(np.median(prefill)),
          "decode_step_p50_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "tokens_per_s": n_gen / wall, "wall_s": wall,
          "max_memory_allocated": int(peak),
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "packed_params": mem["packed_params"],
          "kv_cache_bytes_by_max_len": kv_bytes,
          "launches": launches,
          "every_request_past_window": True,
          "engine_vs_sequential": "token-exact (request 0)",
          "sequential_s": sequential_s, "kernel_replay": replay,
          "ring_check": ring_out})
    return launches


class TrainRecorder:
    """While entered, records step 0's quantized matmul roles (fwd, dgrad,
    wgrad) and flash attention calls of the layers in ``layers``: the
    card's inputs (cloned) and outputs, for ``replay_train_ops``.

    Roles are told apart by their trans flags; a forward call's layer is
    the stack's layer scope (``core.routing``) and its name its place in
    the layer (``names``: gpt2's wq, wk, wv, wo, w_up, w_down; swiglu adds
    w_gate before w_up; or a dict of such tuples by layer); in the
    backward, dgrad reads the forward's
    weight and wgrad its input, found by their storage.  Under remat a
    layer's forward runs again in the backward (``kernels.build``'s
    recompute count): those calls are not recorded, but their inputs are
    the ones the wgrad reads."""

    GPT2 = ("wq", "wk", "wv", "wo", "w_up", "w_down")
    SWIGLU = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def __init__(self, names=GPT2, layers=REPLAY_LAYERS):
        self.names, self.layers = names, layers

    def __enter__(self):
        from repro_torch.core import qlinear as ql
        from repro_torch.kernels import ops
        self.records, self.n_fwd, self.n_flash = [], 0, 0
        self._w, self._x, self._seen = {}, {}, {}
        self._saved = [(ql, "_role", ql._role),
                       (ops, "flash_attention_fwd", ops.flash_attention_fwd)]
        ql._role = self._role(ql._role)
        ops.flash_attention_fwd = self._flash(ops.flash_attention_fwd)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    @staticmethod
    def _where():
        """(layer index or None, whether this is a recompute)."""
        from repro_torch.core import routing
        from repro_torch.kernels.build import recomputing_now
        label = routing.current_layer()
        return (None if label is None else int(label[1:]),
                recomputing_now())

    def _keep(self, layer, role, fn, args, kw, y):
        if layer in self.layers:
            self.records.append({
                "layer": layer, "role": role, "fn": fn, "kw": kw,
                "args": [a.detach().clone() if hasattr(a, "detach") else a
                         for a in args], "out": _clone(y)})

    def _role(self, fn):
        def call(impl, a, b, spec_a, spec_b, *, trans_a=False,
                 trans_b=False, **kw):
            y = fn(impl, a, b, spec_a, spec_b, trans_a=trans_a,
                   trans_b=trans_b, **kw)
            if trans_b:                          # dgrad: b is the weight
                layer, name = self._w[b.data_ptr()]
                role = f"dgrad {name}"
            elif trans_a:                        # wgrad: a is the input
                layer = self._x[a.data_ptr()]
                role = f"wgrad {tuple(b.shape)}"
            else:
                layer, again = self._where()
                j = self._seen.get((layer, again), 0)
                self._seen[(layer, again)] = j + 1
                names = (self.names.get(layer, ())
                         if isinstance(self.names, dict) else self.names)
                name = names[j] if j < len(names) else f"mm{j}"
                self._w[b.data_ptr()] = (layer, name)
                self._x[a.data_ptr()] = layer
                if again:
                    return y
                self.n_fwd += 1
                role = f"fwd {name}"
            # a replay records no routing event (census: the card run's)
            kw = {k: v for k, v in kw.items() if k != "census"}
            self._keep(layer, role, fn, (impl, a, b, spec_a, spec_b),
                       dict(trans_a=trans_a, trans_b=trans_b, **kw), y)
            return y
        return call

    def _flash(self, fn):
        def call(q, k, v, *, causal=True):
            y = fn(q, k, v, causal=causal)
            layer, again = self._where()
            if not again:
                self._keep(layer, "flash", fn, (q, k, v),
                           dict(causal=causal), y)
                self.n_flash += 1
            return y
        return call


def _clone(y, host=False):
    """A detached copy of a kernel call's result (on the host with
    ``host``): a tensor, or (y, (stats vectors or None))."""
    if isinstance(y, tuple):
        return tuple(_clone(v, host) for v in y)
    if y is None:
        return None
    return y.detach().cpu() if host else y.detach().clone()


class plain_kernels:
    """While entered, the fused pipeline (``kernels.fp4_matmul``) calls
    the plain versions of ``qmm_stream``, ``quantize_rows`` and
    ``tiled_mm``, which run on the card as on the CPU: a recorded card
    call replays through them on the card's own tensors."""

    def __enter__(self):
        from repro_torch.kernels import fp4_matmul
        from repro_torch.kernels import qmm_stream as qs
        from repro_torch.kernels import quantize_rows as qr
        from repro_torch.kernels import tiled_mm as tm

        def stream(a, b, *, a_sr=False, b_sr=False, seed_a=None,
                   seed_b=None, **kw):
            return qs.qmm_stream_plain(a, b, seed_a=seed_a if a_sr else None,
                                       seed_b=seed_b if b_sr else None, **kw)

        def quant(x, *, sr=False, seed=None, **kw):
            return qr.quantize_rows_plain(x, seed=seed if sr else None, **kw)
        self._saved = [(name, getattr(fp4_matmul, name)) for name in
                       ("qmm_stream", "quantize_rows", "tiled_mm")]
        fp4_matmul.qmm_stream, fp4_matmul.quantize_rows = stream, quant
        fp4_matmul.tiled_mm = tm.tiled_mm_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import fp4_matmul
        for name, fn in self._saved:
            setattr(fp4_matmul, name, fn)


def replay_train_ops(torch, records, control_role="dgrad wq",
                     control_kw=None, control_layer=0, on_card=False):
    """Each recorded card call again through the plain versions on the
    card's inputs: on the CPU, or with ``on_card`` on the card (the
    records may hold their tensors on the host: each goes back to the
    card for its replay).  Returns per-record (layer, role, relative L2
    of the output, quantized operand elements that differ, for a call
    with the stats epilogue its stats checks) and the control: layer
    ``control_layer``'s ``control_role`` replayed with ``control_kw``
    (default: trans_b off, from a paper_fp4 step's wq dgrad)."""
    import contextlib
    from repro_torch.core.qlinear import ZERO_KEY, kernel_quant_mode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels.rounding import fold_seed
    dev = "cuda" if on_card else "cpu"

    def rel(y, ref):
        y, ref = y.cpu().double(), ref.cpu().double()
        return float((y - ref).norm() / max(float(ref.norm()), 1e-30))

    def q_diff(x, spec, trans, kw, which):
        """Elements of the card's quantization of operand ``x`` that differ
        from the plain version's (two-pass layout; an SR spec with the
        seed its role folds)."""
        if spec.is_passthrough:
            return 0
        qkw = dict(mode=kernel_quant_mode(spec), fmt_name=spec.fmt,
                   trans=trans, emit_trans=trans)
        if spec.stochastic:
            qkw.update(sr=True, seed=fold_seed(ZERO_KEY, kw["salt"], which))
        got = qr.quantize_rows(x.cuda() if on_card else x, **qkw).to(dev)
        qkw.pop("sr", None)
        return int((got != qr.quantize_rows_plain(x.to(dev), **qkw)).sum())

    def plain(r):
        """The record's call through the plain versions."""
        if r["role"] == "flash":
            return fa.flash_attention_fwd_plain
        return r["fn"]

    out, control = [], None
    for r in records:
        args = [a.to(dev) if hasattr(a, "to") else a for a in r["args"]]
        with plain_kernels() if on_card else contextlib.nullcontext():
            ref = plain(r)(*args, **r["kw"])
        y, y_ref = r["out"], ref
        stats = stats_ref = None
        if isinstance(y, tuple):                # the stats epilogue's calls
            (y, stats), (y_ref, stats_ref) = y, ref
        row = {"layer": r["layer"], "role": r["role"],
               "rel_l2": rel(y, y_ref), "quantized_differing": 0}
        if r["role"] != "flash":
            _, a, b, spec_a, spec_b = r["args"]
            kw = r["kw"]
            row["quantized_differing"] = (
                q_diff(a, spec_a, kw["trans_a"], kw, 0)
                + q_diff(b, spec_b, not kw["trans_b"], kw, 1))
            row["sr"] = spec_a.stochastic or spec_b.stochastic
        if stats is not None:
            row["stats"] = [None if s_ is None else check_stats(
                torch, s_, sr_, f"layer {r['layer']} {r['role']}")
                for s_, sr_ in zip(stats, stats_ref)]
        out.append(row)
        if r["layer"] == control_layer and r["role"] == control_role:
            with plain_kernels() if on_card else contextlib.nullcontext():
                bad = r["fn"](*args, **{**r["kw"], **(
                    control_kw or dict(trans_a=False, trans_b=False))})
            control = rel(y, bad[0] if isinstance(bad, tuple) else bad)
    return out, control


# Host-side phase spans of the train loop (telemetry.profiler.phase_span):
# user annotations in a trace, not device work.
PHASE_SPANS = ("data", "step", "host", "fwd", "bwd", "optim")


def profile_train_step(torch, fn, state, batch, card, phase="train_profile",
                       plan="paper_fp4", spans=()) -> None:
    """Split of one training step (of ``plan``) from a ``torch.profiler``
    trace: device time by kernel group and the device's busy share of the
    step's wall time; for each ``record_function`` span named in
    ``spans``, the device time of the kernels launched inside it (a
    forward's and a recompute's: autograd runs the backward outside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state.params, state.opt_state, batch, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = (("qmm_stream", ("qmm_stream_kernel", "qmm_stream_tc_kernel")),
              ("quantize_rows", QUANTIZE_ROWS_KERNELS),
              ("tiled_mm", ("tiled_mm_kernel", "tiled_mm_tc_kernel")),
              ("flash_attention", ("flash_fwd_kernel",
                                   "flash_fwd_tc_kernel")),
              ("stats_fold", ("stats_slab_kernel", "stats_total_kernel")),
              ("cublas_gemm", ("gemm", "xmma", "cutlass", "Kernel2")),
              ("memcpy_memset", ("Memcpy", "Memset")))
    by_group, by_name = {}, {}
    n_launches = 0
    for ev in prof.key_averages():
        # spans are annotations (on the device timeline too), not work
        if ev.device_type == DeviceType.CPU or ev.key in PHASE_SPANS or \
                ev.key in spans:
            continue
        ms = ev.self_device_time_total / 1e3
        if ms <= 0:
            continue
        group = next((g for g, keys in groups
                      if any(k in ev.key for k in keys)), "other_torch")
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[ev.key[:80]] = ms
        n_launches += ev.count
    busy = sum(by_group.values()) if by_group else None
    named = {}
    for ev in prof.key_averages():
        if ev.key in spans and ev.device_type == DeviceType.CPU:
            ms = getattr(ev, "device_time_total", 0) / 1e3
            named[ev.key] = {"calls": ev.count,
                             "device_ms": ms if ms > 0 else "not measured"}
    emit({"phase": phase, "card": card, "plan": plan,
          "device_ops": n_launches, "spans": named,
          "wall_ms": wall_ms,
          "device_ms": busy if busy else "not measured",
          "device_busy_share": busy / wall_ms if busy else "not measured",
          "device_ms_by_group": by_group,
          "top_kernels_ms": dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:10])})


def phase_train(torch, card):
    """Train gpt2-125m at full width and depth for TRAIN_STEPS steps;
    gate the run (see the module docstring); return the path's launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    # every activation kept, as in the phases before remat was ported
    cfg = get_config("gpt2-125m").replace(linear_impl="pallas",
                                          attention_impl="pallas",
                                          remat=False)
    ckpt_dir = tempfile.TemporaryDirectory()
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=TRAIN_STEPS,
                       global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       log_every=0, checkpoint_every=RESUME_AT,
                       checkpoint_dir=ckpt_dir.name)
    pipeline = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    trainer = Trainer(build_model(cfg), tcfg, pipeline)
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.reset()
    per_step, save_s = [], []
    for step in range(TRAIN_STEPS):
        before = {k.name: (k.launches, k.trans_launches, k.tc_launches)
                  for k in kernels}
        t0 = time.perf_counter()
        if step == 0:
            with TrainRecorder() as rec:
                state = trainer.train(state, num_steps=1)
        else:
            state = trainer.train(state, num_steps=1)
        if (step + 1) % RESUME_AT == 0:   # the step's periodic save
            save_s.append(time.perf_counter() - t0
                          - trainer.history[-1]["dt"])
        per_step.append({k.name: [k.launches - before[k.name][0],
                                  k.trans_launches - before[k.name][1],
                                  k.tc_launches - before[k.name][2]]
                         for k in kernels})
    launches = {k.name: k.launches for k in kernels}
    trans = {k.name: k.trans_launches for k in kernels}
    tc = {k.name: k.tc_launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    dts = [r["dt"] for r in hist]
    p50 = float(np.median(dts[1:]))
    if rec.n_fwd != 6 * cfg.n_layers or rec.n_flash != cfg.n_layers:
        raise AssertionError(f"recorded {rec.n_fwd} forward matmuls and "
                             f"{rec.n_flash} flash calls in step 0")
    replay, control = replay_train_ops(torch, rec.records)
    del rec
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    failures = []
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss: {losses}")
    elif not losses[6] < losses[0]:
        failures.append(f"loss did not fall: step 0 {losses[0]}, step 6 "
                        f"{losses[6]}")
    switch = trainer.schedule.switch_step
    plans = [r["recipe"] for r in hist]
    if switch != 7 or plans != ["paper_fp4"] * 7 + ["bf16"]:
        failures.append(f"switch step {switch}, plans {plans}")
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the path never ran: {launches}")
    if min(trans[k] for k in ("qmm_stream", "quantize_rows",
                              "tiled_mm")) <= 0 or \
            launches["qmm_stream"] <= trans["qmm_stream"]:
        failures.append(f"a layout never ran: launches {launches}, "
                        f"transposed {trans}")
    if any(tc[k] != launches[k] for k in TC_SOURCES):
        failures.append(f"a GEMM or bf16 flash launch of the 8192-token "
                        f"steps left the tensor-core route: launches "
                        f"{launches}, "
                        f"tensor-core {tc}")
    if not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if control is None or not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    emit({"phase": "train", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab_size": cfg.vocab_size, "global_batch": TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "recipe": "paper_fp4",
          "switch_step": switch, "losses": losses, "plans": plans,
          "step_ms": [dt * 1e3 for dt in dts],
          "step_p50_ms_after_first": p50 * 1e3,
          "tokens_per_s": TRAIN_TOKENS / p50,
          "max_memory_allocated": int(peak),
          "launches_per_step": per_step,
          "launches_per_step_fields": ["launches", "trans", "tensor_core"],
          "launches": launches, "trans_launches": trans,
          "tensor_core_launches": tc,
          "op_replay": {"calls": len(replay), "layers": list(REPLAY_LAYERS),
                        "rel_l2_max": worst, "bound": bound,
                        "quantized_differing": q_bad,
                        "rel_l2_max_by_role": {
                            k: max(r["rel_l2"] for r in replay
                                   if r["role"].split()[0] == k)
                            for k in ("fwd", "dgrad", "wgrad", "flash")},
                        "control_wq_dgrad_without_trans_b": control}})
    if failures:
        raise AssertionError("train phase: " + "; ".join(failures))
    train_resume(torch, card, cfg, tcfg, pipeline, trainer, state, save_s,
                 ckpt_dir)
    fn = trainer._step_fn(trainer.plan)
    profile_train_step(torch, fn, state, trainer._batch(trainer.pipeline, 0),
                       card)
    return launches, p50 * 1e3


def train_resume(torch, card, cfg, tcfg, pipeline, trainer, state, save_s,
                 ckpt_dir):
    """A second ``Trainer`` resumes the train phase's run from its step
    RESUME_AT checkpoint (moved into a directory of its own, so it is the
    newest there) and runs the remaining steps across the §3.3 switch.
    Gate: its per-step losses, grad norms and plans equal the
    uninterrupted run's, and its final parameters and AdamW moments equal
    them bit for bit."""
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    name = f"step_{RESUME_AT:08d}"
    with tempfile.TemporaryDirectory() as tmp:
        os.replace(os.path.join(ckpt_dir.name, name),
                   os.path.join(tmp, name))
        ckpt_dir.cleanup()
        nbytes = sum(os.path.getsize(os.path.join(tmp, name, f))
                     for f in os.listdir(os.path.join(tmp, name)))
        second = Trainer(build_model(cfg), dataclasses.replace(
            tcfg, checkpoint_dir=tmp), pipeline)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = second.resume()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = second.train(resumed)
    keys = ("loss", "grad_norm", "recipe")
    got = [[r[k] for k in keys] for r in second.history]
    want = [[r[k] for k in keys] for r in trainer.history[RESUME_AT:]]

    def bits(t):
        return t.view(torch.int32)
    leaves = (tree_leaves(resumed.params) + tree_leaves(resumed.opt_state.mu)
              + tree_leaves(resumed.opt_state.nu),
              tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
              + tree_leaves(state.opt_state.nu))
    differing = sum(not torch.equal(bits(a), bits(b))
                    for a, b in zip(*leaves))
    emit({"phase": "train_resume", "card": card, "model": cfg.name,
          "resumed_at": RESUME_AT, "steps": len(second.history),
          "checkpoint_bytes": nbytes, "save_s": save_s,
          "restore_s": restore_s,
          "rows_resumed": got, "rows_uninterrupted": want,
          "rows_equal": got == want, "tensors": len(leaves[0]),
          "tensors_differing": differing,
          "final_step": resumed.step})
    if got != want or differing or resumed.step != state.step:
        raise AssertionError(f"resume: rows equal {got == want}, "
                             f"{differing} tensors differ, step "
                             f"{resumed.step} vs {state.step}")


def telemetry_schema(n_layers):
    """The metric keys of an instrumented fine_grained_fp4 step of the
    reference (``repro.telemetry.collect``): every layer's forward-side
    taps (attention: 4 linears, FFN: 2; all four operand slots quantized),
    its backward probe rows, its gradient norm, and the per-class
    aggregates, the head's included."""
    stats = ("clip", "underflow", "rel_err", "scale_spread")
    slots = ("fwd_x", "fwd_w", "wgrad_x", "dgrad_w")
    grad = ("dgrad_g/clip", "dgrad_g/underflow", "dgrad_g/rel_err",
            "wgrad_g/clip", "wgrad_g/underflow", "wgrad_g/rel_err",
            "gout_norm", "taps")
    keys = {f"tel/bwd/{c}/{g}" for c in ("attn", "ffn", "head", "other")
            for g in grad}
    for i in range(n_layers):
        keys.add(f"tel/gnorm/l{i:02d}")
        for scope, n_mm in (("attn", 4), ("ffn", 2)):
            keys |= {f"tel/l{i:02d}/{scope}/mm{j}/{slot}/{stat}"
                     for j in range(n_mm) for slot in slots
                     for stat in stats}
        keys |= {f"tel/bwd/l{i:02d}/{c}/{g}" for c in ("attn", "ffn",
                                                        "other")
                 for g in grad}
    return keys


def phase_train_telemetry(torch, card, paper_p50_ms):
    """The instrumented training step (see the module docstring): gate
    the run; return the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.telemetry.writer import read_jsonl
    from repro_torch.train.trainer import Trainer

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    cfg = get_config("gpt2-125m").replace(linear_impl="pallas",
                                          attention_impl="pallas",
                                          remat=False)
    pipeline = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    base = dict(recipe="fine_grained_fp4", total_steps=TEL_SCHEDULE,
                global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=0,
                profiler_warmup=1)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "telemetry.jsonl")
        trainer = Trainer(build_model(cfg), TrainConfig(
            **base, telemetry=True, telemetry_every=1,
            telemetry_jsonl=log_path), pipeline)
        state = trainer.init_state(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.reset()
        per_step = []
        for step in range(TEL_STEPS):
            before = {k.name: k.counts() for k in kernels}
            if step == 0:
                with TrainRecorder() as rec:
                    state = trainer.train(state, num_steps=1)
            else:
                state = trainer.train(state, num_steps=1)
            per_step.append({k.name: {c: v - before[k.name][c]
                                      for c, v in k.counts().items()}
                             for k in kernels})
        counts = {k.name: k.counts() for k in kernels}
        launches = {k.name: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        summary = trainer.step_time_summary()
        trainer.close()
        log_rows = read_jsonl(log_path)
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    plans = [r["recipe"] for r in hist]
    # the same recipe with telemetry off, for the overhead
    plain = Trainer(build_model(cfg), TrainConfig(**base), pipeline)
    plain.train(plain.init_state(seed=0), num_steps=TEL_STEPS)
    plain_summary = plain.step_time_summary()

    replay, control = replay_train_ops(
        torch, rec.records, control_role=f"wgrad {(TRAIN_TOKENS, 3072)}",
        control_kw={"salt": 5})
    n_fwd, n_flash = rec.n_fwd, rec.n_flash
    del rec
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    stats_rel = max(c[0] for r in replay for c in r.get("stats", ())
                    if c is not None)
    stats_bitwise = all(c[1] for r in replay for c in r.get("stats", ())
                        if c is not None)
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss: {losses}")
    if plans != ["fine_grained_fp4"] * TEL_STEPS:
        failures.append(f"plans {plans}")
    if n_fwd != 6 * cfg.n_layers or n_flash != cfg.n_layers:
        failures.append(f"recorded {n_fwd} forward matmuls and {n_flash} "
                        "flash calls in step 0")
    want = telemetry_schema(cfg.n_layers)
    for r in hist:
        got = {k for k in r if k.startswith("tel/")}
        if got != want:
            failures.append(f"step {r['step']}: telemetry keys missing "
                            f"{sorted(want - got)[:5]}, extra "
                            f"{sorted(got - want)[:5]}")
        bad = [k for k in want & got if not np.isfinite(r[k])]
        if bad:
            failures.append(f"step {r['step']}: non-finite {bad[:5]}")
        taps = tuple({r.get(f"tel/bwd/l{i:02d}/{c}/taps")
                      for i in range(cfg.n_layers)} for c in ("attn", "ffn"))
        if taps != ({4.0}, {2.0}):
            failures.append(f"step {r['step']}: taps per layer {taps}")
    if [r.get("step") for r in log_rows] != list(range(TEL_STEPS)) or any(
            set(lr) != set(h) for lr, h in zip(log_rows, hist)):
        failures.append(f"JSONL log: {len(log_rows)} rows, steps "
                        f"{[r.get('step') for r in log_rows]}")
    sr_wgrad = [r for r in replay if r.get("sr")]
    if not sr_wgrad:
        failures.append("no stochastic-rounding call was replayed")
    if not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if control is None or not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    if min(launches.values()) <= 0 or counts["qmm_stream"]["sr"] <= 0 or \
            min(counts[k]["stats"] for k in ("qmm_stream",
                                             "quantize_rows")) <= 0:
        failures.append(f"a kernel or mode of the path never ran: {counts}")
    if any(counts[k]["tc"] != counts[k]["launches"] for k in TC_SOURCES):
        failures.append("a GEMM or bf16 flash launch of the 8192-token "
                        f"steps left the tensor-core route: {counts}")
    p50 = summary.get("p50_ms")
    # FP4 health, the mean over the 12 layers of a few of the stats a step
    health = {f"{key}/{stat}": [float(np.mean([
        r[f"tel/l{i:02d}/{key}/{stat}"] for i in range(cfg.n_layers)]))
        for r in hist]
        for key in ("ffn/mm0/fwd_x", "ffn/mm1/fwd_x", "ffn/mm0/fwd_w",
                    "attn/mm0/fwd_x")
        for stat in ("underflow", "rel_err")}
    health.update({f"bwd/ffn/wgrad_g/{stat}": [float(np.mean([
        r[f"tel/bwd/l{i:02d}/ffn/wgrad_g/{stat}"]
        for i in range(cfg.n_layers)])) for r in hist]
        for stat in ("underflow", "rel_err")})
    emit({"phase": "train_telemetry", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "steps": TEL_STEPS, "recipe": "fine_grained_fp4",
          "telemetry_every": 1, "losses": losses, "plans": plans,
          "step_ms": [r["dt"] * 1e3 for r in hist],
          "step_p50_ms": p50,
          "tokens_per_s": summary.get("tokens_per_sec"),
          "mfu": summary.get("mfu"),
          "telemetry_off_step_p50_ms": plain_summary.get("p50_ms"),
          "telemetry_off_tokens_per_s": plain_summary.get("tokens_per_sec"),
          "paper_fp4_step_p50_ms": paper_p50_ms,
          "max_memory_allocated": int(peak),
          "health_mean_over_layers": health,
          "metrics_per_row": len(hist[0]), "telemetry_keys": len(want),
          "jsonl_rows": len(log_rows),
          "launches_per_step": per_step, "counts": counts,
          "op_replay": {"calls": len(replay), "layers": list(REPLAY_LAYERS),
                        "rel_l2_max": worst, "bound": bound,
                        "quantized_differing": q_bad,
                        "sr_calls": len(sr_wgrad),
                        "sr_rel_l2_max": max(
                            (r["rel_l2"] for r in sr_wgrad), default=None),
                        "stats_lanes_3_4_rel_max": stats_rel,
                        "stats_bitwise": stats_bitwise,
                        "stats_rtol": STATS_RTOL,
                        "control_sr_wgrad_salt_5": control}})
    if failures:
        raise AssertionError("train_telemetry phase: " + "; ".join(failures))
    batch = trainer._batch(pipeline, 0)
    for tel in (False, True):
        profile_train_step(torch, trainer._step_fn(trainer.plan, tel), state,
                           batch, card, phase="train_telemetry_profile",
                           plan="fine_grained_fp4" + " with telemetry" * tel)
    return launches


def phase_speed_factors(torch, card, out_dir):
    """The card's ``CostCalibration`` (the reference's
    ``measure_speed_factors`` on the port's own kernels): every distinct
    (fwd_x, fwd_w), (dgrad_g, dgrad_w) and (wgrad_x, wgrad_g) operand-spec
    pair of SPEED_RECIPES, keyed by ``cost_model._cal_key``, timed through
    the route the trainer takes under ``linear_impl="pallas"``
    (``core.qlinear._role``) at the FFN forward shape in bf16 and the nn
    layout, L2 flushed, against ``torch.matmul`` at the same shape.
    Writes the ``speed_factors.v1`` JSON to ``out_dir``; gate: every
    factor finite and > 0, the JSON read back to the same table.  Prints
    the paper and the calibrated cost of gpt2-125m's uniform paper_fp4,
    first_last_k and bf16 plans.  Returns the JSON's path."""
    from repro_torch.configs import get_config
    from repro_torch.core import qlinear as ql
    from repro_torch.core.cost_model import (CostCalibration, ModelDims,
                                             _cal_key, calibrate, plan_cost,
                                             schedule_cost, speed_factor)
    from repro_torch.core.recipe import RECIPES, PrecisionPlan
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.kernels.fp4_matmul import resolve_pipeline
    m, k, n = SPEED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(m, k, generator=gen, device="cuda") * 2).to(
        torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    pairs = {}
    for name in SPEED_RECIPES:
        r = RECIPES[name]
        for mm in (r.attn_linear, r.ffn_linear, r.head_linear):
            for sa, sb in ((mm.fwd_x, mm.fwd_w), (mm.dgrad_g, mm.dgrad_w),
                           (mm.wgrad_x, mm.wgrad_g)):
                pairs.setdefault((_cal_key(sa), _cal_key(sb)), (sa, sb))
    timer = Timer(torch)
    matmul_ms = timer.ms(lambda: torch.matmul(x, w))
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)
    table, rows = {}, []
    for (ka, kb), (sa, sb) in sorted(pairs.items()):
        def call(sa=sa, sb=sb):
            return ql._role("pallas", x, w, sa, sb, salt=4)
        before = [kern.launches for kern in kernels]
        call()
        torch.cuda.synchronize()
        route = "+".join(kern.name for kern, b in zip(kernels, before)
                         if kern.launches > b)
        ms = timer.ms(call)
        table[(ka, kb)] = matmul_ms / ms
        rows.append({"pair": f"{ka}|{kb}", "specs": [sa.to_str(),
                                                    sb.to_str()],
                     "route": route, "pipeline": resolve_pipeline(
                         None, ql.kernel_quant_mode(sa),
                         ql.kernel_quant_mode(sb)),
                     "ms": ms, "factor": table[(ka, kb)],
                     "paper_factor": speed_factor(sa, sb)})
    cal = calibrate(table, source=f"chip_smoke speed_factors {m}x{k}x{n} "
                                  f"bf16 ({card})")
    path = os.path.join(out_dir, "speed_factors.json")
    cal.to_json(path)
    back = CostCalibration.from_json(path)
    cfg = get_config("gpt2-125m")
    dims = ModelDims.from_config(cfg, seq_len=TRAIN_SEQ)
    plans = [PrecisionPlan.uniform(RECIPES["paper_fp4"], cfg.n_layers),
             PrecisionPlan.first_last_k(RECIPES["paper_fp4"], cfg.n_layers,
                                        k=LARGE_K),
             PrecisionPlan.uniform(RECIPES["bf16"], cfg.n_layers)]
    costs = {p.name: {
        "paper": plan_cost(p, dims), "calibrated": plan_cost(p, dims, cal),
        "schedule_paper": schedule_cost(p, dims, total_steps=ADAPT_STEPS),
        "schedule_calibrated": schedule_cost(p, dims,
                                             total_steps=ADAPT_STEPS,
                                             calibration=cal)}
        for p in plans}
    emit({"phase": "speed_factors", "card": card, "shape": [m, k, n],
          "dtype": "bfloat16", "matmul_ms": matmul_ms, "pairs": rows,
          "plan_costs_gpt2_125m": costs, "json": path})
    bad = {p: f for p, f in table.items()
           if not (np.isfinite(f) and f > 0)}
    if bad or dict(back.table) != dict(cal.table) or len(table) != len(
            pairs):
        raise AssertionError(f"speed factors: non-finite or <= 0 {bad}; "
                             f"JSON round trip equal "
                             f"{dict(back.table) == dict(cal.table)}")
    return path


def _plan_mm(plan, layer, cls):
    """The MatmulRecipe of a census event's cell (``"L<i>"`` / None and
    attn | ffn | head) in ``plan``."""
    if cls == "head":
        return plan.head_linear
    row = plan.layers[int(layer[1:])]
    return row.attn_linear if cls == "attn" else row.ffn_linear


ROLE_SPECS = {"fwd": ("fwd_x", "fwd_w"), "dgrad": ("dgrad_g", "dgrad_w"),
              "wgrad": ("wgrad_x", "wgrad_g")}


def census_failures(cells, plan, n_layers):
    """What is wrong with one step's routing census against the plan the
    step ran: specs, kernel modes and pipeline per event; fwd, dgrad and
    wgrad events of every layer and class (fwd ``dot`` events for a
    passthrough plan)."""
    from repro_torch.core.qlinear import kernel_quant_mode
    from repro_torch.kernels.fp4_matmul import resolve_pipeline
    bad = []
    for ev in cells:
        mm = _plan_mm(plan, ev.layer, ev.cls)
        sa, sb = (getattr(mm, r) for r in ROLE_SPECS[ev.role])
        want = [sa.to_str(), sb.to_str()]
        if [ev.spec_a, ev.spec_b] != want:
            bad.append(f"{ev.layer}/{ev.cls}/{ev.role} specs "
                       f"{[ev.spec_a, ev.spec_b]} != plan {want}")
        if ev.route == "pallas":
            modes = (kernel_quant_mode(sa), kernel_quant_mode(sb))
            if (ev.mode_a, ev.mode_b) != modes or ev.pipeline != \
                    resolve_pipeline(None, *modes):
                bad.append(f"{ev.layer}/{ev.cls}/{ev.role} modes "
                           f"{ev.mode_a, ev.mode_b} pipeline {ev.pipeline}")
        elif ev.route != "dot":
            bad.append(f"{ev.layer}/{ev.cls}/{ev.role} route {ev.route}")
    have = {(ev.layer, ev.cls, ev.role) for ev in cells}
    roles = ("fwd",) if plan.is_passthrough else ("fwd", "dgrad", "wgrad")
    missing = {(f"L{i}", c, r) for i in range(n_layers)
               for c in ("attn", "ffn") for r in roles} - have
    if missing:
        bad.append(f"no event for {sorted(missing)[:6]} "
                   f"({len(missing)} cells)")
    return bad


def _ffn_routes(cells):
    """The FFN forward's route per layer: ``pallas/<pipeline>`` or
    ``dot``."""
    out = {}
    for ev in cells:
        if ev.cls == "ffn" and ev.role == "fwd":
            out[int(ev.layer[1:])] = (ev.route if ev.route != "pallas"
                                      else f"pallas/{ev.pipeline}")
    return [out.get(i) for i in range(len(out))]


def phase_train_adaptive(torch, card, cal_path):
    """Train gpt2-125m at full width and depth under the adaptive
    controller with plan search priced by the card's speed factors, an
    injected rollback and a resume (see the module docstring); gate the
    run; return the path's launch counts."""
    from repro_torch.configs import ControllerSettings, get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import routing
    from repro_torch.core.cost_model import plan_cost
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    cfg = get_config("gpt2-125m").replace(linear_impl="pallas",
                                          attention_impl="pallas",
                                          remat=False)
    pipeline = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    ckpt_dir, log_dir = tempfile.TemporaryDirectory(), \
        tempfile.TemporaryDirectory()
    tcfg = TrainConfig(
        recipe="paper_fp4", total_steps=ADAPT_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=0,
        telemetry=True, telemetry_every=1,
        telemetry_jsonl=os.path.join(log_dir.name, "adaptive.jsonl"),
        checkpoint_every=ADAPT_CKPT, checkpoint_dir=ckpt_dir.name,
        cost_calibration=cal_path, profiler_warmup=1,
        controller=ControllerSettings(**ADAPT_CONTROLLER))
    trainer = Trainer(build_model(cfg), tcfg, pipeline)
    ctrl = trainer.controller

    def leaves(st):
        return (tree_leaves(st.params) + tree_leaves(st.opt_state.mu)
                + tree_leaves(st.opt_state.nu))

    host_copy, used, ctl_s = {}, [], [0.0]
    save, step_fn = trainer.save, trainer._step_fn
    observe, apply_events = ctrl.observe, trainer._apply_controller_events

    def save_with_copy(st):       # a host copy of the step-6 checkpoint
        if st.step == ADAPT_RESTORE and st.step not in host_copy:
            host_copy[st.step] = [t.detach().to("cpu", copy=True)
                                  for t in leaves(st)]
        save(st)

    def recorded_step_fn(plan, telemetry=None):    # the plan a step ran
        used.append(plan)
        return step_fn(plan, telemetry)

    def timed(fn):                # the controller's host time
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ctl_s[0] += time.perf_counter() - t0
        return call
    trainer.save, trainer._step_fn = save_with_copy, recorded_step_fn
    ctrl.observe = timed(observe)
    trainer._apply_controller_events = timed(apply_events)

    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.reset()
    steps, rec, rec_layers, restore = [], None, (), None
    while state.step < ADAPT_STEPS:
        step = state.step
        expect = ctrl.active_plan(step)
        before = {kern.name: kern.counts() for kern in kernels}
        n_events, ctl_s[0] = len(ctrl.events), 0.0
        with routing.capture() as log:
            if step == ADAPT_REPLAY_STEP and rec is None:
                promoted = sorted({int(e["cell"][1:3]) for e in ctrl.events
                                   if e["event"] == "plan_search"
                                   and e["op"] == "promote"
                                   and e["cell"].endswith("/ffn")})
                fp4 = next((i for i in range(cfg.n_layers)
                            if i not in promoted), 0)
                rec_layers = (promoted[0] if promoted else 0, fp4)
                with TrainRecorder(layers=rec_layers) as rec:
                    state = trainer.train(state, num_steps=1)
            else:
                state = trainer.train(state, num_steps=1)
        row = trainer.history[-1]
        steps.append({
            "step": step, "row": row, "plan": used[-1], "expect": expect,
            "cells": log.cells(), "raw_events": len(log.events),
            "events": ctrl.events[n_events:], "controller_s": ctl_s[0],
            "launches": {kern.name: {c: v - before[kern.name][c]
                                     for c, v in kern.counts().items()
                                     if c in ("launches", "tc")}
                         for kern in kernels}})
        if restore is None and state.step == ADAPT_RESTORE + 1:
            # the injected loss spike, as the reference's tests inject it
            ev = {"event": "rollback", "step": step, "loss": 99.0,
                  "loss_ema": row["loss"]}
            ctrl.rollbacks = 1
            ctrl._observe_lr([ev])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = apply_events(state, [ev], lambda s: None)
            torch.cuda.synchronize()
            restore = {"seconds": time.perf_counter() - t0,
                       "to_step": state.step,
                       "tensors_differing": sum(
                           not torch.equal(a.cpu().view(torch.int32),
                                           b.view(torch.int32))
                           for a, b in zip(leaves(state), host_copy.get(
                               ADAPT_RESTORE, []))),
                       "tensors": len(host_copy.get(ADAPT_RESTORE, [])),
                       "lr_scale": ctrl.lr_scale,
                       "replay_until": ctrl.replay_until}
    counts = {kern.name: kern.counts() for kern in kernels}
    launches = {kern.name: kern.launches for kern in kernels}
    peak = torch.cuda.max_memory_allocated()
    summary = trainer.step_time_summary()
    trainer.ckpt.wait()
    trainer.save, trainer._step_fn = save, step_fn
    ctrl.observe, trainer._apply_controller_events = observe, apply_events

    failures = []
    hist = [s["row"] for s in steps]
    plans = [s["plan"].name for s in steps]
    want_steps = list(range(ADAPT_RESTORE + 1)) + list(
        range(ADAPT_RESTORE, ADAPT_STEPS))
    if [r["step"] for r in hist] != want_steps:
        failures.append(f"steps run {[r['step'] for r in hist]}")
    if not all(np.isfinite([r["loss"] for r in hist])):
        failures.append(f"non-finite loss: {[r['loss'] for r in hist]}")
    for s in steps:
        if s["plan"] != s["expect"] or s["row"]["recipe"] != \
                s["plan"].name:
            failures.append(f"step {s['step']} ran {s['plan'].name}, the "
                            f"controller chose {s['expect'].name}")
        bad = census_failures(s["cells"], s["plan"], cfg.n_layers)
        if bad:
            failures.append(f"step {s['step']} census: {bad[:3]}")
    # the search: FFN promotes (the edits the final state keeps), each
    # promoted cell's forward on the fp8 two-pass route in every
    # quantized step run after its edit; frontier costs recomputed and a
    # monotone frontier
    promoted = [cell for op, cell in ctrl.searcher.edits
                if op == "promote" and cell.endswith("/ffn")]
    if not promoted:
        failures.append(f"no FFN promote: {ctrl.searcher.edits}")
    for cell in promoted:
        at = max(j for j, s in enumerate(steps) for e in s["events"]
                 if e["event"] == "plan_search" and e["cell"] == cell)
        for s in steps[at + 1:]:
            if s["plan"].is_passthrough:
                continue
            fwd = [ev for ev in s["cells"] if ev.layer == f"L{int(cell[1:3])}"
                   and ev.cls == "ffn" and ev.role == "fwd"]
            if not fwd or any(not ev.spec_a.startswith("fp8_e4m3@token")
                              or ev.pipeline != "two_pass" for ev in fwd):
                failures.append(f"step {s['step']}: promoted {cell} "
                                f"forward ran {[ev.to_dict() for ev in fwd]}")
    # the kernels agree: a step with promoted FFN cells launches qmm_stream
    # less and tiled_mm more than step 0 (all FFN cells FP4)
    base = {k: steps[0]["launches"][k]["launches"]
            for k in ("qmm_stream", "tiled_mm")}
    for s in steps:
        n_prom = sum(row.ffn_linear.fwd_x.fmt == "fp8_e4m3"
                     for row in s["plan"].layers)
        got = {k: s["launches"][k]["launches"] for k in base}
        if n_prom and not s["plan"].is_passthrough and not (
                got["qmm_stream"] < base["qmm_stream"]
                and got["tiled_mm"] > base["tiled_mm"]):
            failures.append(f"step {s['step']} ({n_prom} FFN cells on FP8) "
                            f"launched {got}, step 0 {base}")
    frontier = []
    for p in ctrl.searcher.frontier:
        plan = ctrl._demoted_plan(ctrl.searcher._apply_edits(
            trainer.schedule.plan, p["edits"]))
        frontier.append({**p, "paper_cost": plan_cost(plan, trainer.dims),
                         "recomputed": plan_cost(plan, trainer.dims,
                                                 trainer.calibration),
                         "name_ok": plan.name == p["plan"]})
    if any(f["recomputed"] != f["cost"] or not f["name_ok"]
           for f in frontier):
        failures.append(f"frontier costs: {frontier}")
    fc = [f["cost"] for f in frontier]
    fe = [f["error"] for f in frontier]
    if fc != sorted(fc) or any(a <= b for a, b in zip(fe, fe[1:])):
        failures.append(f"frontier not monotone: {list(zip(fc, fe))}")
    # the rollback: restore, bf16 replay, LR halved then recovering
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.total_steps,
                          tcfg.warmup_frac, tcfg.min_lr_frac)
    rate = (1.0 / ADAPT_CONTROLLER["lr_backoff"]) ** (
        1.0 / max(ADAPT_CONTROLLER["lr_recovery_steps"], 1))
    replay = steps[ADAPT_RESTORE + 1:]
    scale, lr_rows = ADAPT_CONTROLLER["lr_backoff"], []
    for s in replay:
        want_lr = float(lr_fn(s["step"]) * torch.tensor(
            scale, dtype=torch.float32))
        lr_rows.append({"step": s["step"], "lr": s["row"]["lr"],
                        "scale": scale, "want": want_lr})
        if s["row"]["lr"] != want_lr:
            failures.append(f"step {s['step']} lr {s['row']['lr']} != "
                            f"scheduled x f32({scale}) = {want_lr}")
        scale = min(1.0, scale * rate)
    if replay and replay[0]["row"]["lr"] != float(lr_fn(ADAPT_RESTORE)) * 0.5:
        failures.append("step 6's replay lr is not half the scheduled lr")
    if restore is None or restore["to_step"] != ADAPT_RESTORE or \
            restore["tensors_differing"] or not restore["tensors"]:
        failures.append(f"restore: {restore}")
    if [s["plan"].name for s in replay[:2]] != ["bf16", "bf16"] or \
            replay[-1]["plan"].name != "bf16" or any(
                s["plan"].is_passthrough for s in replay[2:-1]):
        failures.append(f"plans after the rollback: "
                        f"{[s['plan'].name for s in replay]}")
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the path never ran: {launches}")
    if any(counts[k]["tc"] != counts[k]["launches"] for k in TC_SOURCES):
        failures.append(f"a GEMM or flash launch left the tensor-core "
                        f"route: {counts}")
    # the op replay of the searcher-edited step, with its control
    if rec is None or rec.n_fwd != 6 * cfg.n_layers or \
            rec.n_flash != cfg.n_layers:
        failures.append("op recorder: " + ("no step recorded" if rec is None
                        else f"{rec.n_fwd} forward matmuls, {rec.n_flash} "
                        "flash calls"))
        replay_ops, control = [], None
    else:
        replay_ops, control = replay_train_ops(
            torch, rec.records, control_layer=rec_layers[1])
    del rec
    worst = max((r["rel_l2"] for r in replay_ops), default=None)
    q_bad = sum(r["quantized_differing"] for r in replay_ops)
    bound = OP_BOUND["bfloat16"]
    if worst is None or not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if control is None or not control > bound:
        failures.append(f"the control did not miss the bound: {control}")

    # the resume: a fresh Trainer from the step-9 checkpoint
    name = f"step_{ADAPT_RESUME_AT:08d}"
    with tempfile.TemporaryDirectory() as tmp:
        os.replace(os.path.join(ckpt_dir.name, name),
                   os.path.join(tmp, name))
        ckpt_dir.cleanup()
        second = Trainer(build_model(cfg), dataclasses.replace(
            tcfg, checkpoint_dir=tmp, telemetry_jsonl=os.path.join(
                log_dir.name, "resumed.jsonl")), pipeline)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = second.resume()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed = second.train(resumed)
        second.close()
    trainer.close()
    log_dir.cleanup()
    keys = ("loss", "grad_norm", "recipe", "lr")
    got = [[r[k] for k in keys] for r in second.history]
    want = [[r[k] for k in keys] for r in hist[-(ADAPT_STEPS
                                                 - ADAPT_RESUME_AT):]]
    differing = sum(not torch.equal(a.view(torch.int32),
                                    b.view(torch.int32))
                    for a, b in zip(leaves(resumed), leaves(state)))
    ctl_equal = second.controller.state_dict() == ctrl.state_dict()
    if got != want or differing or not ctl_equal:
        failures.append(f"resume from step {ADAPT_RESUME_AT}: rows equal "
                        f"{got == want}, {differing} tensors differ, "
                        f"controller state equal {ctl_equal}")
    all_counts = {kern.name: kern.counts() for kern in kernels}
    if any(all_counts[k]["tc"] != all_counts[k]["launches"]
           for k in TC_SOURCES):
        failures.append(f"a launch of the resumed steps left the "
                        f"tensor-core route: {all_counts}")
    dts = [r["dt"] for r in hist]
    emit({"phase": "train_adaptive", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab_size": cfg.vocab_size, "global_batch": TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "total_steps": ADAPT_STEPS,
          "recipe": "paper_fp4", "controller": ADAPT_CONTROLLER,
          "switch_step": trainer.schedule.switch_step,
          "steps": [{"step": s["step"], "loss": s["row"]["loss"],
                     "plan": s["plan"].name, "lr": s["row"]["lr"],
                     "dt_ms": s["row"]["dt"] * 1e3,
                     "events": [{k: v for k, v in e.items()
                                 if k in ("event", "op", "cell", "cost",
                                          "error", "lr_scale")}
                                for e in s["events"]],
                     "ffn_route": _ffn_routes(s["cells"]),
                     "census_cells": len(s["cells"]),
                     "census_raw_events": s["raw_events"],
                     "launches": {k: v["launches"]
                                  for k, v in s["launches"].items()},
                     "controller_ms": s["controller_s"] * 1e3}
                    for s in steps],
          "search_edits": ctrl.searcher.edits,
          "frontier": [{k: f[k] for k in ("step", "plan", "cost",
                                          "paper_cost", "error")}
                       for f in frontier],
          "restore": restore, "lr_after_rollback": lr_rows,
          "step_p50_ms": summary.get("p50_ms"),
          "step_p50_ms_after_first": float(np.median(dts[1:])) * 1e3,
          "tokens_per_s": summary.get("tokens_per_sec"),
          "controller_ms_per_step": [s["controller_s"] * 1e3
                                     for s in steps],
          "max_memory_allocated": int(peak),
          "counts": counts, "launches": launches,
          "op_replay": {"step": ADAPT_REPLAY_STEP,
                        "layers": list(rec_layers),
                        "calls": len(replay_ops), "rel_l2_max": worst,
                        "bound": bound, "quantized_differing": q_bad,
                        "control_wq_dgrad_without_trans_b": control},
          "resume": {"from_step": ADAPT_RESUME_AT, "restore_s": resume_s,
                     "rows_resumed": got, "rows_uninterrupted": want,
                     "tensors_differing": differing,
                     "controller_state_equal": ctl_equal}})
    if failures:
        raise AssertionError("train_adaptive phase: "
                             + "; ".join(failures[:12]))
    edited = next(s["plan"] for s in steps
                  if s["step"] == ADAPT_REPLAY_STEP)
    profile_train_step(torch, trainer._step_fn(edited, True), state,
                       trainer._batch(pipeline, 0), card,
                       phase="train_adaptive_profile",
                       plan=edited.name + " with telemetry")
    return launches


def phase_train_large(torch, card):
    """Train llama-1b at full published width and depth (see the module
    docstring): remat, first_last_k, 4 x 2048 tokens.  Gate the run;
    return the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    cfg = get_config("llama-1b").replace(linear_impl="pallas",
                                         attention_impl="pallas",
                                         remat=True, remat_policy="full")
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=LARGE_STEPS,
                       global_batch=LARGE_BATCH, seq_len=LARGE_SEQ,
                       log_every=0, plan_preset="first_last_k",
                       plan_k=LARGE_K)
    pipeline = SyntheticLM(cfg.vocab_size, LARGE_SEQ, LARGE_BATCH, seed=0)
    trainer = Trainer(build_model(cfg), tcfg, pipeline)
    used = []                       # the plan each step ran
    step_fn = trainer._step_fn

    def recorded_step_fn(plan, telemetry=None):
        used.append(plan)
        return step_fn(plan, telemetry)
    trainer._step_fn = recorded_step_fn
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for kern in kernels:
        kern.reset()
    per_step, peaks = [], []
    for step in range(LARGE_STEPS):
        before = {k.name: k.counts() for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        if step == 0:
            with TrainRecorder(TrainRecorder.SWIGLU,
                               LARGE_REPLAY_LAYERS) as rec:
                state = trainer.train(state, num_steps=1)
            for r in rec.records:   # off the card before the next step
                r["args"] = [a.cpu() if hasattr(a, "cpu") else a
                             for a in r["args"]]
        else:
            state = trainer.train(state, num_steps=1)
        peaks.append(int(torch.cuda.max_memory_allocated()))
        per_step.append({k.name: {c: v - before[k.name][c]
                                  for c, v in k.counts().items()
                                  if c in ("launches", "trans", "tc",
                                           "recompute")}
                         for k in kernels})
    counts = {k.name: k.counts() for k in kernels}
    launches = {k.name: k.launches for k in kernels}
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    dts = [r["dt"] for r in hist]
    p50 = float(np.median(dts[1:]))
    tokens = LARGE_BATCH * LARGE_SEQ
    switch = trainer.schedule.switch_step
    failures = []
    if rec.n_fwd != 7 * cfg.n_layers or rec.n_flash != cfg.n_layers:
        failures.append(f"recorded {rec.n_fwd} forward matmuls and "
                        f"{rec.n_flash} flash calls in step 0")
    replay, control = replay_train_ops(torch, rec.records)
    del rec
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    protected = {0, 1, cfg.n_layers - 2, cfg.n_layers - 1}
    formats = [[p.layers[i].ffn_linear.fwd_x.fmt for i in
                range(cfg.n_layers)] for p in used]
    want_fmts = [[("fp8_e4m3" if i in protected else "fp4_e2m1")
                  if step < switch else "bf16" for i in range(cfg.n_layers)]
                 for step in range(LARGE_STEPS)]
    attn_fmts = {p.layers[i].attn_linear.fwd_x.fmt for p in used[:switch]
                 for i in range(cfg.n_layers)}
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss: {losses}")
    elif not losses[switch - 1] < losses[0]:
        failures.append(f"loss did not fall: step 0 {losses[0]}, step "
                        f"{switch - 1} {losses[switch - 1]}")
    if switch != LARGE_STEPS - 1 or formats != want_fmts or \
            attn_fmts != {"fp8_e4m3"}:
        failures.append(f"switch step {switch}; per-layer FFN forward "
                        f"formats {[sorted(set(f)) for f in formats]}, "
                        f"attention {attn_fmts}")
    if min(launches.values()) <= 0 or \
            min(counts[k]["recompute"] for k in launches) <= 0:
        failures.append(f"a kernel of the path never ran, or never in a "
                        f"recompute: {counts}")
    if any(counts[k]["tc"] != counts[k]["launches"] for k in TC_SOURCES):
        failures.append(f"a GEMM or flash launch left the tensor-core "
                        f"route: {counts}")
    if not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if control is None or not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    emit({"phase": "train_large", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
          "vocab_size": cfg.vocab_size,
          "params": sum(p.numel() for p in tree_leaves(state.params)),
          "global_batch": LARGE_BATCH, "seq_len": LARGE_SEQ,
          "steps": LARGE_STEPS, "recipe": "paper_fp4",
          "plan_preset": f"first_last_k (k={LARGE_K})",
          "remat": cfg.remat_policy, "switch_step": switch,
          "losses": losses, "plans": [r["recipe"] for r in hist],
          "protected_layers": sorted(protected),
          "init_s": init_s, "step_ms": [dt * 1e3 for dt in dts],
          "step_p50_ms_after_first": p50 * 1e3,
          "tokens_per_s": tokens / p50,
          "max_memory_allocated_per_step": peaks,
          "max_memory_allocated": max(peaks[1:]),
          "launches_per_step": per_step, "counts": counts,
          "op_replay": {"calls": len(replay),
                        "layers": list(LARGE_REPLAY_LAYERS),
                        "rel_l2_max": worst, "bound": bound,
                        "quantized_differing": q_bad,
                        "rel_l2_max_by_role": {
                            k: max(r["rel_l2"] for r in replay
                                   if r["role"].split()[0] == k)
                            for k in ("fwd", "dgrad", "wgrad", "flash")},
                        "control_wq_dgrad_without_trans_b": control}})
    if failures:
        raise AssertionError("train_large phase: " + "; ".join(failures))
    profile_train_step(torch, step_fn(trainer.plan), state,
                       trainer._batch(pipeline, 0), card,
                       phase="train_large_profile",
                       plan=trainer.plan.name)
    return launches


class MoeTrainRecorder(TrainRecorder):
    """``TrainRecorder`` keeping only the batched (expert) calls, each cut
    to its first ``experts`` experts when it is kept."""

    def __init__(self, layers, experts):
        super().__init__(TrainRecorder.SWIGLU, layers)
        self.experts = experts

    def _keep(self, layer, role, fn, args, kw, y):
        if role == "flash" or \
                not any(getattr(a, "dim", lambda: 0)() == 3 for a in args):
            return
        n = self.experts
        cut = [a[:n] if getattr(a, "dim", lambda: 0)() == 3 else a
               for a in args]
        super()._keep(layer, role, fn, cut, kw, y[:n])


def phase_train_moe(torch, card):
    """Train olmoe-1b-7b at full width and depth (module docstring):
    remat, adafactor, 4 x 2048 tokens, the experts' batched launches.
    Gate the run; return the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.quantize import BF16_SPEC
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.train.train_step import make_eval_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    cfg = get_config("olmoe-1b-7b").replace(
        linear_impl="pallas", attention_impl="pallas", remat=True,
        remat_policy="full", optimizer="adafactor", scan_layers=False)
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=MOE_STEPS,
                       global_batch=MOE_BATCH, seq_len=MOE_SEQ, log_every=0)
    pipeline = SyntheticLM(cfg.vocab_size, MOE_SEQ, MOE_BATCH, seed=0)
    model = build_model(cfg)
    trainer = Trainer(model, tcfg, pipeline)
    t0 = time.perf_counter()
    state = trainer.init_state(params=model.init(0, on_device=True))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    # the sanity check of learning: the loss on step 0's batch before and
    # after the run (one batch to the next, SyntheticLM's losses differ
    # more than 6 steps move them)
    eval_step = make_eval_step(model, trainer.plan)
    batch0 = trainer._batch(pipeline, 0)
    eval_before = float(eval_step(state.params, batch0)["loss"])
    for kern in kernels:
        kern.reset()
    per_step, peaks = [], []
    for step in range(MOE_STEPS):
        before = {k.name: k.counts() for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        if step == 0:
            with MoeTrainRecorder((0,), MOE_REPLAY_EXPERTS) as rec:
                state = trainer.train(state, num_steps=1)
            for r in rec.records:
                r["args"] = [a.cpu() if hasattr(a, "cpu") else a
                             for a in r["args"]]
                r["out"] = r["out"].cpu()
        else:
            state = trainer.train(state, num_steps=1)
        peaks.append(int(torch.cuda.max_memory_allocated()))
        per_step.append({k.name: {c: v - before[k.name][c]
                                  for c, v in k.counts().items()
                                  if c in ("launches", "tc", "recompute",
                                           "batched")}
                         for k in kernels})
    counts = {k.name: k.counts() for k in kernels}
    launches = {k.name: k.launches for k in kernels}
    eval_after = float(eval_step(state.params, batch0)["loss"])
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    dts = [r["dt"] for r in hist]
    p50 = float(np.median(dts[1:]))
    tokens = MOE_BATCH * MOE_SEQ
    failures = []
    # per MoE layer a step: fwd, recompute, dgrad and wgrad of w_gate,
    # w_up and w_down, each one batched launch
    want_batched = 12 * cfg.n_layers
    got_batched = [s_["qmm_stream"]["batched"] for s_ in per_step]
    if any(n != want_batched for n in got_batched):
        failures.append(f"batched qmm_stream launches a step {got_batched}, "
                        f"not {want_batched}")
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite loss: {losses}")
    elif not eval_after < eval_before:
        failures.append(f"the loss on step 0's batch did not fall: "
                        f"{eval_before} -> {eval_after}")
    for key in ("moe_load_balance", "moe_router_z", "moe_frac_dropped"):
        if not all(key in r and np.isfinite(r[key]) for r in hist):
            failures.append(f"{key} missing or non-finite in a row")
    if min(launches.values()) <= 0 or \
            min(counts[k]["recompute"] for k in launches) <= 0:
        failures.append(f"a kernel of the path never ran, or never in a "
                        f"recompute: {counts}")
    if any(counts[k]["tc"] != counts[k]["launches"] for k in TC_SOURCES):
        failures.append(f"a GEMM or flash launch left the tensor-core "
                        f"route: {counts}")
    # layer 0's expert calls again on the CPU (the plain versions) on the
    # card's inputs, and the control: the w_up forward with its
    # activation left unquantized
    names = ("w_gate", "w_up", "w_down")
    got_roles = sorted(r["role"] for r in rec.records)
    want_roles = sorted([f"fwd {n}" for n in names]
                        + [f"dgrad {n}" for n in names]
                        + ["wgrad"] * 3)
    if [r_.split()[0] for r_ in got_roles] != \
            [r_.split()[0] for r_ in want_roles]:
        failures.append(f"recorded expert calls {got_roles}")
    replay, _ = replay_train_ops(torch, rec.records, control_role=None)
    ctrl_rec = next(r for r in rec.records if r["role"] == "fwd w_up")
    impl, a, b, _, spec_b = ctrl_rec["args"]
    ctrl = ctrl_rec["fn"](impl, a, b, BF16_SPEC, spec_b, **ctrl_rec["kw"])
    y = ctrl_rec["out"].double()
    control = float((y - ctrl.double()).norm() / y.norm())
    del rec
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    if not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    emit({"phase": "train_moe", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "group_size": cfg.moe.group_size,
          "vocab_size": cfg.vocab_size, "params": n_params,
          "active_params": model.active_param_count(),
          "global_batch": MOE_BATCH, "seq_len": MOE_SEQ,
          "steps": MOE_STEPS, "recipe": "paper_fp4",
          "optimizer": cfg.optimizer, "remat": cfg.remat_policy,
          "losses": losses, "plans": [r["recipe"] for r in hist],
          "batch0_loss_before_after": [eval_before, eval_after],
          "moe_metrics": [{k: r[k] for k in ("moe_load_balance",
                                             "moe_router_z",
                                             "moe_frac_dropped")}
                          for r in hist],
          "init_s": init_s, "step_ms": [dt * 1e3 for dt in dts],
          "step_p50_ms_after_first": p50 * 1e3,
          "tokens_per_s": tokens / p50,
          "max_memory_allocated_per_step": peaks,
          "max_memory_allocated": max(peaks),
          "launches_per_step": per_step, "counts": counts,
          "op_replay": {"calls": len(replay), "layer": 0,
                        "experts": MOE_REPLAY_EXPERTS,
                        "rel_l2_max": worst, "bound": bound,
                        "quantized_differing": q_bad,
                        "rel_l2_by_role": {r["role"]: r["rel_l2"]
                                           for r in replay},
                        "control_w_up_activation_unquantized": control}})
    if failures:
        raise AssertionError("train_moe phase: " + "; ".join(failures))
    profile_train_step(torch, trainer._step_fn(trainer.plan), state,
                       trainer._batch(pipeline, 0), card,
                       phase="train_moe_profile", plan=trainer.plan.name)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {k.name: counts[k.name]["batched"] for k in kernels}


def phase_serve_moe(torch, card):
    """olmoe-1b-7b at full width, MOE_SERVE_LAYERS deep, through the
    packed-FP4 ``ContinuousBatcher``, every stage captured (module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, DecodeEngine, quantize_weights_for_serving,
        serving_memory_report)

    cfg = get_config("olmoe-1b-7b").replace(linear_impl="pallas",
                                            n_layers=MOE_SERVE_LAYERS)
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=1, dtype=torch.bfloat16, on_device=True),
        "fp4_e2m1"))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    mem = serving_memory_report(params)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(16, 513, size=MOE_REQUESTS)]
    lengths[:len(MOE_EXACT_PROMPTS)] = MOE_EXACT_PROMPTS
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)

    def make(jit):
        return ContinuousBatcher(model, params, n_slots=MOE_SLOTS,
                                 max_len=MOE_MAX_LEN, recipe=recipe,
                                 kv_format="fp8_e4m3", jit=jit)

    batcher = make(jit=True)
    engine = batcher.engine
    if any(engine.bucket(n) != n for n in MOE_EXACT_PROMPTS):
        raise AssertionError("MOE_EXACT_PROMPTS are not bucket lengths")
    buckets = sorted({engine.bucket(n) for n in lengths})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in buckets:
        batcher.submit(np.arange(n) % cfg.vocab_size, 2)
    batcher.run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    warm_counts = stage_counts(engine)
    out, launches, prefill_ms, step_ms, wall, peak = serve_run(
        torch, batcher, prompts, MOE_NEW, kernels)
    batched = {k.name: k.batched_launches for k in kernels}
    counts = stage_counts(engine)
    run_counts = {name: {k: n - warm_counts[name][k] for k, n in c.items()}
                  for name, c in counts.items()}
    failures = []
    if any(c["captures"] for c in run_counts.values()):
        failures.append(f"the timed run captured: {run_counts}")
    if batched["qmm_stream"] <= 0:
        failures.append(f"no batched expert launch in the run: {batched}")
    if failures:
        raise AssertionError("serve_moe phase: " + "; ".join(failures))

    # the eager engine on the first SLICE_EAGER requests; requests 0 and 1
    # again through the sequential ``generate`` (a cache of prompt +
    # MOE_NEW positions, allocated in whole attention chunks as the
    # engine's 2048 are, so it gives their bits), and through a captured
    # engine of one slot and the same max_len
    t0 = time.perf_counter()
    eager_launches, eager_prefill_ms, eager_step_ms = engine_checks(
        torch, engine, prompts, out, make, SLICE_EAGER, kernels,
        "serve_moe")
    single = ContinuousBatcher(model, params, n_slots=1,
                               max_len=MOE_MAX_LEN, recipe=recipe,
                               kv_format="fp8_e4m3")
    for i in range(len(MOE_EXACT_PROMPTS)):
        rid = single.submit(prompts[i], MOE_NEW)
        alone = single.run()[rid]
        if alone != out[i]:
            first = next(j for j, (a, b) in enumerate(zip(alone, out[i]))
                         if a != b)
            failures.append(f"request {i}: 8-slot engine != 1-slot engine "
                            f"from token {first}")
    sequential_s = time.perf_counter() - t0
    del single
    if failures:
        raise AssertionError("serve_moe phase: " + "; ".join(failures))
    del batcher, engine
    gc.collect()

    # the GEMM kernels at this phase's shapes against their plain versions:
    # an eager engine's prefill of request 2 and one batched decode step,
    # layer 0's calls recorded and replayed on the card
    rows, replay = engine_replay(torch, DecodeEngine(
        model, params, n_slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
        recipe=recipe, kv_format="fp8_e4m3", jit=False), prompts[2], (0,),
        "serve_moe")
    expert_rows = [r for r in rows if len(r["shape"]) == 4]
    if not expert_rows:
        raise AssertionError(f"serve_moe kernel replay: no expert call; "
                             f"{replay}")
    profile_decode(torch, DecodeEngine(
        model, params, n_slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
        recipe=recipe, kv_format="fp8_e4m3"), card,
        phase="serve_moe_profile")
    n_gen = sum(len(v) for v in out)
    emit({"phase": "serve_moe", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "slots": MOE_SLOTS, "max_len": MOE_MAX_LEN,
          "requests": len(prompts), "new_tokens": MOE_NEW,
          "prompt_lengths": lengths, "jit": True, "pack_s": pack_s,
          "capture_warmup_s": capture_s,
          "stages_warmup": warm_counts, "stages_run": run_counts,
          "prefill_ms_by_bucket": {
              str(b): float(np.median(v)) for b, v in
              sorted(prefill_ms.items())},
          "prefill_count_by_bucket": {
              str(b): len(v) for b, v in sorted(prefill_ms.items())},
          "decode_step_p50_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "eager": {"requests": SLICE_EAGER,
                    "decode_step_p50_ms": float(np.median(eager_step_ms)),
                    "decode_steps": len(eager_step_ms),
                    "prefill_ms_by_bucket": {
                        str(b): float(np.median(v)) for b, v in
                        sorted(eager_prefill_ms.items())},
                    "launches": eager_launches,
                    "tokens_vs_captured": "equal"},
          "launches": launches, "batched_launches": batched,
          "tokens_per_s": n_gen / wall, "wall_s": wall,
          "max_memory_allocated": int(peak),
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "packed_params": mem["packed_params"],
          "total_param_bytes": mem["total_bytes"],
          "kv_cache_bytes": serve_cache_bytes(cfg.replace(
              kv_cache_format="fp8_e4m3"), MOE_SLOTS, MOE_MAX_LEN),
          "engine_vs_sequential": f"token-exact (requests 0-1, "
                                  f"prompts {list(MOE_EXACT_PROMPTS)})",
          "engine_vs_one_slot_engine": f"token-exact (requests 0-1, "
                                       f"prompts {list(MOE_EXACT_PROMPTS)})",
          "sequential_s": sequential_s,
          "kernel_replay": {**replay, "expert_calls": len(expert_rows)}})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, batched


class SsdWatch:
    """While entered, wraps ``models.ssm.ssd_chunked``: for each call of
    a forward (not a recompute), the heads whose largest chunk sum of
    dt * |A| passes ``SSM_EXP_OVERFLOW`` (where the reference's SSD
    gradient turns NaN), per layer, summed on the device."""

    def __enter__(self):
        from repro_torch.kernels.build import recomputing_now
        from repro_torch.models import ssm
        self.per_call = []
        self._mod, self._fn = ssm, ssm.ssd_chunked
        fn = self._fn

        def call(x, dt, a, bmat, cmat, *, chunk, initial_state=None):
            if not recomputing_now():
                # detached: a remat recompute must save what the forward
                # saved
                b, s, h = dt.shape
                sums = (dt.detach().float() * -a.detach().float()).reshape(
                    b, s // chunk, chunk, h).sum(2)
                self.per_call.append(
                    (sums.amax(dim=(0, 1)) > SSM_EXP_OVERFLOW).sum())
            return fn(x, dt, a, bmat, cmat, chunk=chunk,
                      initial_state=initial_state)
        ssm.ssd_chunked = call
        return self

    def __exit__(self, *exc):
        self._mod.ssd_chunked = self._fn

    def counts(self):
        return [int(c) for c in self.per_call]


def ssd_fwd_bwd_ms(torch, cfg, timer):
    """Device ms of one layer's SSD at the training shape (the plain-torch
    chunked SSD, f32 inside), forward alone and forward + backward."""
    from repro_torch.models import ssm
    st = cfg.mamba
    h = st.expand * cfg.d_model // st.headdim
    g = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = rand(SSM_BATCH, SSM_SEQ, h, st.headdim).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rand(SSM_BATCH, SSM_SEQ, h) - 3)
    a = -torch.rand(h, generator=g, device="cuda") * 15 - 1
    bm, cm = (rand(SSM_BATCH, SSM_SEQ, st.n_groups, st.d_state)
              .to(torch.bfloat16) for _ in range(2))
    leaves = [t.requires_grad_(True) for t in (x, dt, bm, cm)]

    def fwd():
        with torch.no_grad():
            return ssm.ssd_chunked(x, dt, a, bm, cm, chunk=st.chunk)

    def fwd_bwd():
        y, s_ = ssm.ssd_chunked(x, dt, a, bm, cm, chunk=st.chunk)
        torch.autograd.grad((y.float().sum(), s_.sum()), leaves)
    return timer.ms(fwd, iters=5), timer.ms(fwd_bwd, iters=5)


def phase_train_ssm(torch, card):
    """Train mamba2-780m at full width and depth (module docstring):
    4 x 2048 tokens, paper_fp4, remat, AdamW.  Gate the run; return the
    path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.quantize import BF16_SPEC
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.models.ssm import softplus
    from repro_torch.train.train_step import make_eval_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    cfg = get_config("mamba2-780m").replace(
        linear_impl="pallas", remat=True, remat_policy="full")
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=SSM_STEPS,
                       global_batch=SSM_BATCH, seq_len=SSM_SEQ, log_every=0)
    pipeline = SyntheticLM(cfg.vocab_size, SSM_SEQ, SSM_BATCH, seed=0)
    model = build_model(cfg)
    trainer = Trainer(model, tcfg, pipeline)
    t0 = time.perf_counter()
    state = trainer.init_state(params=model.init(0, on_device=True))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    # the heads (of every layer) past the NaN condition from the init
    # alone: softplus(dt_bias) |A| over a whole chunk
    groups = state.params["stack"]["groups"]["l00"]["mixer"]
    est = softplus(groups["dt_bias"]) * torch.exp(groups["a_log"]) * \
        (cfg.mamba.chunk - 1)
    heads_est = int((est > SSM_EXP_OVERFLOW).sum())
    eval_step = make_eval_step(model, trainer.plan)
    batch0 = trainer._batch(pipeline, 0)
    eval_before = float(eval_step(state.params, batch0)["loss"])
    for kern in kernels:
        kern.reset()
    per_step, peaks = [], []
    for step in range(SSM_STEPS):
        before = {k.name: k.counts() for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        if step == 0:
            with TrainRecorder(SSM_PROJ, (0,)) as rec, SsdWatch() as watch:
                state = trainer.train(state, num_steps=1)
            for r in rec.records:
                r["args"] = [a.cpu() if hasattr(a, "cpu") else a
                             for a in r["args"]]
                r["out"] = r["out"].cpu()
        else:
            state = trainer.train(state, num_steps=1)
        peaks.append(int(torch.cuda.max_memory_allocated()))
        per_step.append({k.name: {c: v - before[k.name][c]
                                  for c, v in k.counts().items()
                                  if c in ("launches", "tc", "recompute",
                                           "trans")}
                         for k in kernels})
    counts = {k.name: k.counts() for k in kernels}
    launches = {k.name: k.launches for k in kernels}
    eval_after = float(eval_step(state.params, batch0)["loss"])
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    norms = [r["grad_norm"] for r in hist]
    dts = [r["dt"] for r in hist]
    p50 = float(np.median(dts[1:]))
    over = watch.counts()
    failures = []
    # a layer-step: 6 projections, each forward, recompute, dgrad, wgrad
    want = 4 * len(SSM_PROJ) * cfg.n_layers
    got = [s_["qmm_stream"]["launches"] for s_ in per_step]
    if any(n != want for n in got):
        failures.append(f"qmm_stream launches a step {got}, not {want}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
        failures.append(f"non-finite loss or grad norm: {losses} {norms}")
    elif not eval_after < eval_before:
        failures.append(f"the loss on step 0's batch did not fall: "
                        f"{eval_before} -> {eval_after}")
    if launches["qmm_stream"] <= 0 or counts["qmm_stream"]["recompute"] <= 0:
        failures.append(f"qmm_stream never ran, or never in a recompute: "
                        f"{counts}")
    if counts["qmm_stream"]["tc"] != counts["qmm_stream"]["launches"]:
        failures.append(f"a qmm_stream launch left the tensor-core route: "
                        f"{counts}")
    if rec.n_fwd != len(SSM_PROJ) * cfg.n_layers or \
            len(over) != cfg.n_layers:
        failures.append(f"recorded {rec.n_fwd} forward matmuls, "
                        f"{len(over)} SSD calls in step 0")
    roles = sorted(r["role"].split()[0] for r in rec.records)
    if roles != sorted(["fwd", "dgrad", "wgrad"] * len(SSM_PROJ)):
        failures.append(f"recorded layer-0 calls {roles}")
    # layer 0's projection calls again on the CPU (the plain versions) on
    # the card's inputs, and the control: in_x's forward with its
    # activation left unquantized
    replay, _ = replay_train_ops(torch, rec.records, control_role=None)
    ctrl_rec = next(r for r in rec.records if r["role"] == "fwd in_x")
    impl, a, b, _, spec_b = ctrl_rec["args"]
    ctrl = ctrl_rec["fn"](impl, a, b, BF16_SPEC, spec_b, **ctrl_rec["kw"])
    y = ctrl_rec["out"].double()
    control = float((y - ctrl.double()).norm() / y.norm())
    del rec
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    if not worst <= bound or q_bad:
        failures.append(f"op replay: worst rel L2 {worst} (bound {bound}), "
                        f"{q_bad} quantized elements differ")
    if not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    timer = Timer(torch)
    ssd_fwd, ssd_fwd_bwd = ssd_fwd_bwd_ms(torch, cfg, timer)
    del timer
    emit({"phase": "train_ssm", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "d_inner": cfg.mamba.expand * cfg.d_model,
          "heads": cfg.mamba.expand * cfg.d_model // cfg.mamba.headdim,
          "d_state": cfg.mamba.d_state, "chunk": cfg.mamba.chunk,
          "vocab_size": cfg.vocab_size, "params": n_params,
          "global_batch": SSM_BATCH, "seq_len": SSM_SEQ,
          "steps": SSM_STEPS, "recipe": "paper_fp4",
          "optimizer": cfg.optimizer, "remat": cfg.remat_policy,
          "losses": losses, "grad_norms": norms,
          "plans": [r["recipe"] for r in hist],
          "batch0_loss_before_after": [eval_before, eval_after],
          "heads_past_exp_overflow_step0": {
              "total": sum(over), "of": int(est.numel()),
              "by_layer": over, "threshold": SSM_EXP_OVERFLOW,
              "from_init_softplus_dt_bias_A_x_255": heads_est},
          "init_s": init_s, "step_ms": [dt * 1e3 for dt in dts],
          "step_p50_ms_after_first": p50 * 1e3,
          "tokens_per_s": SSM_TOKENS / p50,
          "max_memory_allocated_per_step": peaks,
          "max_memory_allocated": max(peaks),
          "ssd_layer_ms": {"fwd": ssd_fwd, "fwd_bwd": ssd_fwd_bwd},
          "launches_per_step": per_step, "counts": counts,
          "op_replay": {"calls": len(replay), "layer": 0,
                        "rel_l2_max": worst, "bound": bound,
                        "quantized_differing": q_bad,
                        "rel_l2_by_role": {r["role"]: r["rel_l2"]
                                           for r in replay},
                        "control_in_x_activation_unquantized": control}})
    if failures:
        raise AssertionError("train_ssm phase: " + "; ".join(failures))
    profile_train_step(torch, trainer._step_fn(trainer.plan), state,
                       trainer._batch(pipeline, 0), card,
                       phase="train_ssm_profile", plan=trainer.plan.name,
                       spans=("ssd",))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_ssm(torch, card):
    """mamba2-780m at full width and depth through the packed-FP4
    ``ContinuousBatcher`` (module docstring): exact-length eager
    prefill, captured insert and decode over the state cache."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, DecodeEngine, quantize_weights_for_serving,
        serving_memory_report)

    cfg = get_config("mamba2-780m").replace(linear_impl="pallas")
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=1, dtype=torch.bfloat16, on_device=True),
        "fp4_e2m1"))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    mem = serving_memory_report(params)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(16, 513, size=SSM_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    # every projection is FFN-class (qmm_stream); the two-pass kernels are
    # counted too, and not required to launch
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)
    idle = ("quantize_rows", "tiled_mm")

    def make(jit):
        return ContinuousBatcher(model, params, n_slots=SSM_SLOTS,
                                 max_len=SSM_MAX_LEN, recipe=recipe,
                                 jit=jit)

    batcher = make(jit=True)
    engine = batcher.engine
    if engine._can_bucket or engine.bucket(lengths[0]) != lengths[0]:
        raise AssertionError("the SSM engine pads its prompts")
    state_bytes = {str(n): serve_cache_bytes(cfg, SSM_SLOTS, n)
                   for n in (SSM_MAX_LEN, 4 * SSM_MAX_LEN)}
    held = held_cache_bytes(engine.cache)
    if len(set(state_bytes.values())) != 1 or \
            held != state_bytes[str(SSM_MAX_LEN)]:
        raise AssertionError(f"state cache bytes {state_bytes}, held "
                             f"{held}")
    # Warm-up, not timed: captures insert and the batched step.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batcher.submit(prompts[0][:16], 2)
    batcher.run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    warm_counts = stage_counts(engine)
    out, launches, prefill_ms, step_ms, wall, peak = serve_run(
        torch, batcher, prompts, SSM_NEW, kernels, idle)
    counts = stage_counts(engine)
    run_counts = {name: {k: n - warm_counts[name][k] for k, n in c.items()}
                  for name, c in counts.items()}
    if any(c["captures"] for c in run_counts.values()) or \
            not run_counts["generate"]["replays"]:
        raise AssertionError(f"the timed run captured, or replayed no "
                             f"step: {run_counts}")
    t0 = time.perf_counter()
    eager_launches, eager_prefill_ms, eager_step_ms = engine_checks(
        torch, engine, prompts, out, make, SLICE_EAGER, kernels,
        "serve_ssm", idle)
    checks_s = time.perf_counter() - t0
    profile_decode(torch, engine, card, phase="serve_ssm_profile")
    del batcher, engine
    gc.collect()
    torch.cuda.empty_cache()

    # qmm_stream at this phase's shapes against its plain version: an
    # eager engine's prefill of request 2 and one batched decode step,
    # the first and the last layer's calls recorded and replayed
    rows, replay = engine_replay(torch, DecodeEngine(
        model, params, n_slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
        recipe=recipe, jit=False), prompts[2], SSM_REPLAY_LAYERS,
        "serve_ssm")
    got = {f"{stage} L{layer}": calls_by_layer(rows, stage, layer)
           for stage in ("prefill", "decode") for layer in SSM_REPLAY_LAYERS}
    narrow = [r for r in rows if r["shape"][2] == SSM_HEADS]
    if any(c != {"qmm_stream": len(SSM_PROJ)} for c in got.values()) or \
            len(narrow) != 2 * len(SSM_REPLAY_LAYERS):
        raise AssertionError(f"serve_ssm kernel replay: calls {got}, "
                             f"{len(narrow)} in_dt calls")
    n_gen = sum(len(v) for v in out)
    prefill = [v for vs in prefill_ms.values() for v in vs]
    emit({"phase": "serve_ssm", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "slots": SSM_SLOTS, "max_len": SSM_MAX_LEN,
          "requests": len(prompts), "new_tokens": SSM_NEW,
          "prompt_lengths": lengths, "jit": True, "pack_s": pack_s,
          "capture_warmup_s": capture_s,
          "stages_warmup": warm_counts, "stages_run": run_counts,
          "prefill_exact_length_ms_median": float(np.median(prefill)),
          "prefill_exact_length_ms_min_max": [min(prefill), max(prefill)],
          "decode_step_p50_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "eager": {"requests": SLICE_EAGER,
                    "decode_step_p50_ms": float(np.median(eager_step_ms)),
                    "decode_steps": len(eager_step_ms),
                    "prefill_ms_median": float(np.median(
                        [v for vs in eager_prefill_ms.values()
                         for v in vs])),
                    "launches": eager_launches,
                    "tokens_vs_captured": "equal"},
          "launches": launches, "tokens_per_s": n_gen / wall,
          "wall_s": wall, "max_memory_allocated": int(peak),
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "packed_params": mem["packed_params"],
          "dense_params": mem["dense_params"],
          "total_param_bytes": mem["total_bytes"],
          "state_cache_bytes_by_max_len": state_bytes,
          "engine_vs_sequential": "token-exact (requests 0-1)",
          "checks_s": checks_s,
          "kernel_replay": replay})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_layer_replay(torch, rec, what="hybrid", flash=True, no_dgrad=0,
                       on_card=False):
    """Step 0's calls of ``rec.layers`` (a ``TrainRecorder`` with names by
    layer: fwd, dgrad and wgrad of each product, and with ``flash`` an
    attention layer's flash forward; ``no_dgrad`` products a layer takes
    no dgrad of: a cross sublayer's K / V projections of the vision
    states) again on the CPU through the plain versions
    (``replay_train_ops``; with ``on_card`` on the card), with the
    control: the first attention layer's wq dgrad with its transposes
    off.  Returns the summary for the phase's line; raises on a missing
    call, a miss or a control within the bound."""
    failures = []
    for layer in rec.layers:
        names = (rec.names[layer] if isinstance(rec.names, dict)
                 else rec.names)
        n, attn = len(names), "wq" in names
        roles = [r["role"].split()[0] for r in rec.records
                 if r["layer"] == layer]
        got = {k: roles.count(k) for k in ("fwd", "dgrad", "wgrad", "flash")}
        want = {"fwd": n, "dgrad": n - no_dgrad * attn, "wgrad": n,
                "flash": int(attn and flash)}
        if got != want:
            failures.append(f"layer {layer} calls {got}, not {want}")
    replay, control = replay_train_ops(torch, rec.records, control_layer=next(
        layer for layer in rec.layers if "wq" in (
            rec.names[layer] if isinstance(rec.names, dict) else rec.names)),
        on_card=on_card)
    worst = max(r["rel_l2"] for r in replay)
    q_bad = sum(r["quantized_differing"] for r in replay)
    bound = OP_BOUND["bfloat16"]
    out = {"layers": list(rec.layers), "calls": len(replay),
           "rel_l2_max": worst, "bound": bound,
           "quantized_differing": q_bad,
           "rel_l2_max_by_call": {},
           "control_wq_dgrad_untransposed": control}
    for r in replay:
        key = f"L{r['layer']} {r['role']}"
        out["rel_l2_max_by_call"][key] = max(
            out["rel_l2_max_by_call"].get(key, 0.0), r["rel_l2"])
    if not worst <= bound or q_bad:
        failures.append(f"worst rel L2 {worst} (bound {bound}), {q_bad} "
                        "quantized elements differ")
    if control is None or not control > bound:
        failures.append(f"the control did not miss the bound: {control}")
    if failures:
        raise AssertionError(f"{what} train replay: {failures}; {out}")
    return out


def phase_hybrid(torch, card):
    """jamba-1.5-large-398b ``REDUCED`` on the card (module docstring), a
    correctness check: one captured engine whose decode step holds
    attention KV, mamba state and MoE, held to the eager engine and to
    ``generate``, and a kernel replay of layers 3 and 4; two training
    steps, step 0's calls of those layers replayed on the CPU.  Returns
    the path's launch counts (serving and training)."""
    import importlib
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.recipe import RECIPES
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, DecodeEngine, quantize_weights_for_serving)
    from repro_torch.train.trainer import Trainer

    cfg = importlib.import_module(
        "repro_torch.configs.jamba_1_5_large_398b").REDUCED.replace(
        linear_impl="pallas", attention_impl="pallas")
    specs = cfg.layer_specs()
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=2), "fp4_e2m1"))
    rng = np.random.default_rng(1)
    lengths = [int(n) for n in rng.integers(16, 129, size=HYB_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    gemm = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)

    def make(jit):
        return ContinuousBatcher(model, params, n_slots=HYB_SLOTS,
                                 max_len=HYB_MAX_LEN, recipe=recipe,
                                 kv_format="fp8_e4m3", jit=jit)
    batcher = make(jit=True)
    engine = batcher.engine
    kinds = sorted({tuple(sorted(layer["self"]))
                    for layer in engine.cache["stack"]["layers"]})
    batcher.submit(prompts[0][:16], 2)
    batcher.run()
    warm_counts = stage_counts(engine)
    out, launches, _, _, _, _ = serve_run(torch, batcher, prompts, HYB_NEW,
                                          gemm)
    batched = qmm_stream.KERNEL.batched_launches
    counts = stage_counts(engine)
    run_counts = {name: {k: n - warm_counts[name][k] for k, n in c.items()}
                  for name, c in counts.items()}
    if any(c["captures"] for c in run_counts.values()) or \
            not run_counts["generate"]["replays"] or batched <= 0:
        raise AssertionError(f"hybrid: the timed run captured, replayed no "
                             f"step or launched no expert batch: "
                             f"{run_counts}, batched {batched}")
    engine_checks(torch, engine, prompts, out, make, HYB_REQUESTS, gemm,
                  "hybrid")
    del batcher, engine
    # the GEMM kernels at this path's shapes against their plain versions
    rows, replay = engine_replay(torch, DecodeEngine(
        model, params, n_slots=HYB_SLOTS, max_len=HYB_MAX_LEN,
        recipe=recipe, kv_format="fp8_e4m3", jit=False), prompts[0],
        HYB_REPLAY_LAYERS, "hybrid")
    got = {f"{stage} L{layer}": calls_by_layer(rows, stage, layer)
           for stage in ("prefill", "decode") for layer in HYB_REPLAY_LAYERS}
    want = {f"{stage} L{layer}": calls
            for stage in ("prefill", "decode")
            for layer, calls in HYB_CALLS_PER_LAYER.items()}
    # layer 3's w_gate, w_up and w_down, one batched call each a stage
    expert_rows = [r for r in rows if len(r["shape"]) == 4]
    if got != want or len(expert_rows) != 2 * 3:
        raise AssertionError(f"hybrid kernel replay: calls {got}, "
                             f"{len(expert_rows)} expert calls")
    del params

    train_kernels = gemm + (flash_attention.KERNEL,)
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=2,
                       global_batch=HYB_TRAIN_BATCH, seq_len=HYB_TRAIN_SEQ,
                       log_every=0)
    trainer = Trainer(model, tcfg, SyntheticLM(
        cfg.vocab_size, HYB_TRAIN_SEQ, HYB_TRAIN_BATCH, seed=0))
    state = trainer.init_state(seed=0)
    for kern in train_kernels:
        kern.reset()
    names = {3: SSM_PROJ + TrainRecorder.SWIGLU[4:],
             4: TrainRecorder.SWIGLU}
    with TrainRecorder(names, HYB_REPLAY_LAYERS) as rec:
        state = trainer.train(state, num_steps=1)
    state = trainer.train(state, num_steps=1)
    train_launches = {k.name: k.launches for k in train_kernels}
    losses = [r["loss"] for r in trainer.history]
    norms = [r["grad_norm"] for r in trainer.history]
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))) or \
            min(train_launches.values()) <= 0:
        raise AssertionError(f"hybrid training: losses {losses}, grad "
                             f"norms {norms}, launches {train_launches}")
    train_replay = train_layer_replay(torch, rec)
    del rec
    emit({"phase": "hybrid", "card": card, "model": cfg.name,
          "config": "REDUCED", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model,
          "layers": [f"{s_.mixer}+{s_.ffn}" for s_ in specs],
          "cache_kinds": [list(k) for k in kinds],
          "slots": HYB_SLOTS, "max_len": HYB_MAX_LEN,
          "requests": len(prompts), "new_tokens": HYB_NEW,
          "prompt_lengths": lengths, "stages_run": run_counts,
          "launches": launches, "batched_launches": batched,
          "engine_vs_eager": f"token-exact ({HYB_REQUESTS} requests)",
          "engine_vs_sequential": "token-exact (requests 0-1)",
          "kernel_replay": {**replay, "expert_calls": len(expert_rows)},
          "train": {"steps": 2, "tokens": HYB_TRAIN_BATCH * HYB_TRAIN_SEQ,
                    "losses": losses, "grad_norms": norms,
                    "launches": train_launches,
                    "op_replay": train_replay}})
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + train_launches[k]
            for k in train_launches}


class StatesPipeline:
    """``SyntheticLM`` batches plus seeded cross states under ``key``
    (``vision`` or ``frames``, (batch, n, d) f32): ``banks`` batches of
    them drawn once, batch ``step`` taking bank ``step % banks``, so
    that no step pays for drawing them."""

    def __init__(self, lm, key, n, d, banks=2, seed=0):
        self.lm, self.key = lm, key
        rng = np.random.default_rng(seed)
        b = lm.global_batch
        self.bank = rng.standard_normal((banks, b, n, d), dtype=np.float32)

    def batch(self, step):
        out = self.lm.batch(step)
        out[self.key] = self.bank[step % len(self.bank)]
        return out


def generate_checked(torch, model, params, prompts, extras, new, recipe,
                     kernels, alone, what):
    """``train.serve.generate`` of ``prompts`` (B, S) with ``extras`` on
    captured stages: a warm-up run that captures the prefill and decode
    graphs, then the counted run (every counter of ``kernels`` set to 0
    first; launches, peak memory, wall time), then the same steps through
    ``make_prefill_fn`` / ``make_decode_fn`` on ``generate``'s cache, each
    stage timed to a device sync; the three runs' tokens must be equal,
    and each row in ``alone`` must equal that request generated alone.
    Raises on a miss or a kernel of ``kernels`` that never launched."""
    from repro_torch.train import serve
    b, s = prompts.shape

    def run():
        return serve.generate(model, params, prompts, max_new_tokens=new,
                              recipe=recipe, extras=extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    for kern in kernels:
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = int(torch.cuda.max_memory_allocated())
    prefill_fn = serve.make_prefill_fn(model, recipe)
    decode_fn = serve.make_decode_fn(model, recipe)
    cache = serve._generate_cache(model, b, s + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, prompts, cache, extras)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, step_ms = [prompts], []
    for i in range(new):
        cur = serve.sample_tokens(logits[:, -1])
        toks.append(cur.to(prompts.dtype))
        if i < new - 1:
            t0 = time.perf_counter()
            logits, cache = decode_fn(params, cur, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    timed = torch.cat(toks, dim=1)
    failures = []
    if not (torch.equal(warm, out) and torch.equal(out, timed)):
        failures.append("the warm-up, counted and timed runs' tokens differ")
    if min(launches.values()) <= 0:
        failures.append(f"a kernel of the path never ran: {launches}")
    for i in alone:
        one = serve.generate(model, params, prompts[i:i + 1],
                             max_new_tokens=new, recipe=recipe,
                             extras={k: v[i:i + 1] for k, v in
                                     extras.items()})
        if not torch.equal(one[0], out[i]):
            first = int((one[0] != out[i]).nonzero()[0])
            failures.append(f"row {i} != the request alone from position "
                            f"{first}")
    if failures:
        raise AssertionError(f"{what} generate: {failures}")
    return {"tokens": out, "launches": launches, "peak": peak,
            "wall_s": wall, "capture_warmup_s": capture_s,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "tokens_per_s": b * new / wall}


def phase_vlm(torch, card):
    """llama-3.2-vision-90b at full width, depth cut to VLM_LAYERS, served
    in packed FP4 from captured stages with vision states (module
    docstring); then REDUCED trained 2 steps as a correctness check.
    Returns the path's launch counts (serving and training)."""
    import importlib
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.recipe import RECIPES
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import (flash_attention, qmm_stream,
                                     quantize_rows, tiled_mm)
    from repro_torch.models import build_model
    from repro_torch.train import serve
    from repro_torch.train.serving_runtime import (
        quantize_weights_for_serving, serving_memory_report)
    from repro_torch.train.trainer import Trainer

    cfg = get_config("llama-3.2-vision-90b").replace(
        n_layers=VLM_LAYERS, scan_layers=False, linear_impl="pallas",
        kv_cache_format="fp8_e4m3")
    crosses = [i for i, s_ in enumerate(cfg.layer_specs()) if s_.cross]
    if crosses != [VLM_CROSS_LAYER]:
        raise AssertionError(f"vlm: cross sublayers on layers {crosses}")
    recipe = RECIPES["paper_fp4"]
    model = build_model(cfg)
    n_params = model.param_count()
    t0 = time.perf_counter()
    dense = model.init(seed=3, dtype=torch.bfloat16, on_device=True)
    # tanh(0) = 0: at the init's gate no logit would see the vision
    dense["stack"]["layers"][VLM_CROSS_LAYER]["cross_gate"].fill_(1.0)
    params = model.cast_params(quantize_weights_for_serving(
        model, dense, "fp4_e2m1"))
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    mem = serving_memory_report(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (VLM_PROMPTS, VLM_PROMPT_LEN),
                            generator=gen, device="cuda")
    shape = (VLM_PROMPTS, cfg.n_patches, cfg.d_model)
    vision, vision_b = (torch.randn(shape, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(2))
    gemm = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)
    res = generate_checked(torch, model, params, prompts,
                           {"vision": vision}, VLM_NEW, recipe, gemm,
                           alone=(0, 1), what="vlm")
    cache = serve._generate_cache(model, VLM_PROMPTS,
                                  VLM_PROMPT_LEN + VLM_NEW)
    cross = cache["stack"]["layers"][VLM_CROSS_LAYER]["cross"]
    cross_bytes = sum(t.numel() * t.element_size() for t in cross.values())

    # Cross control: the same prompts over other vision states
    prefill_fn = serve.make_prefill_fn(model, recipe)

    def last_logits(v):
        c = serve._generate_cache(model, VLM_PROMPTS,
                                  VLM_PROMPT_LEN + VLM_NEW)
        lg, _ = prefill_fn(params, prompts, c, {"vision": v})
        return lg[:, -1].float().clone()
    base, other = last_logits(vision), last_logits(vision_b)
    cross_rel = float((other - base).norm() / base.norm())
    if not cross_rel > OP_BOUND["bfloat16"]:
        raise AssertionError(f"vlm: other vision states moved the logits "
                             f"by only {cross_rel}")

    # Layer 3's kernel calls in an eager prefill and decode step
    with torch.no_grad():
        c1 = model.init_cache(VLM_PROMPTS, VLM_PROMPT_LEN + VLM_NEW)
        with KernelRecorder((VLM_CROSS_LAYER,)) as pre:
            lg, _ = model.prefill(params, prompts, c1, recipe,
                                  extras={"vision": vision})
        with KernelRecorder((VLM_CROSS_LAYER,)) as dec:
            model.decode_step(params, serve.sample_tokens(lg[:, -1]), c1,
                              recipe)
        del c1, lg
    rows, replay = replay_stages(torch, (("prefill", pre), ("decode", dec)),
                                 (VLM_CROSS_LAYER,), "vlm")
    got = {stage: calls_by_layer(rows, stage, VLM_CROSS_LAYER)
           for stage in ("prefill", "decode")}
    cross_kv = [r for r in rows if r["kernel"] == "tiled_mm"
                and r["shape"][0] == VLM_PROMPTS * cfg.n_patches]
    if got != VLM_CALLS or len(cross_kv) != 2:
        raise AssertionError(f"vlm kernel replay: calls {got}, "
                             f"{len(cross_kv)} cross K / V projections")
    del params, cache, cross, pre, dec
    serve._FN_CACHE.pop(model, None)
    gc.collect()
    torch.cuda.empty_cache()

    # REDUCED training, a correctness check: 2 steps with vision states,
    # flash causal, layer 3's calls of step 0 replayed on the CPU
    tcfg_m = importlib.import_module(
        "repro_torch.configs.llama_3_2_vision_90b").REDUCED.replace(
        linear_impl="pallas", attention_impl="pallas", scan_layers=False)
    tmodel = build_model(tcfg_m)
    trainer = Trainer(tmodel, TrainConfig(
        recipe="paper_fp4", total_steps=2, global_batch=VLM_TRAIN_BATCH,
        seq_len=VLM_TRAIN_SEQ, log_every=0), StatesPipeline(
            SyntheticLM(tcfg_m.vocab_size, VLM_TRAIN_SEQ, VLM_TRAIN_BATCH,
                        seed=0), "vision", tcfg_m.n_patches,
            tcfg_m.d_model))
    p0 = tmodel.init(seed=0)
    p0["stack"]["layers"][VLM_CROSS_LAYER]["cross_gate"].fill_(1.0)
    state = trainer.init_state(params=p0)
    train_kernels = gemm + (flash_attention.KERNEL,)
    for kern in train_kernels:
        kern.reset()
    with TrainRecorder({VLM_CROSS_LAYER: VLM_NAMES},
                       (VLM_CROSS_LAYER,)) as rec:
        state = trainer.train(state, num_steps=1)
    state = trainer.train(state, num_steps=1)
    train_launches = {k.name: k.launches for k in train_kernels}
    losses = [r["loss"] for r in trainer.history]
    norms = [r["grad_norm"] for r in trainer.history]
    gate_grad_moved = float(state.params["stack"]["layers"][
        VLM_CROSS_LAYER]["cross_gate"]) != 1.0
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))) or \
            min(train_launches.values()) <= 0 or not gate_grad_moved:
        raise AssertionError(f"vlm training: losses {losses}, grad norms "
                             f"{norms}, launches {train_launches}, gate "
                             f"moved {gate_grad_moved}")
    train_replay = train_layer_replay(torch, rec, "vlm", no_dgrad=2)
    del rec, trainer, state
    dec_ms = res["decode_step_ms"]
    emit({"phase": "vlm", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "cross_layers": crosses,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "n_patches": cfg.n_patches, "params": n_params,
          "prompts": VLM_PROMPTS, "prompt_len": VLM_PROMPT_LEN,
          "new_tokens": VLM_NEW, "jit": True, "pack_s": pack_s,
          "capture_warmup_s": res["capture_warmup_s"],
          "prefill_ms": res["prefill_ms"],
          "decode_step_p50_ms": float(np.median(dec_ms)),
          "decode_steps": len(dec_ms),
          "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
          "max_memory_allocated": res["peak"],
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "packed_params": mem["packed_params"],
          "dense_params": mem["dense_params"],
          "total_param_bytes": mem["total_bytes"],
          "cross_cache_bytes": cross_bytes,
          "launches": res["launches"],
          "rows_vs_alone": "token-exact (rows 0-1)",
          "cross_control_rel_l2": cross_rel,
          "kernel_replay": {**replay, "calls_by_stage": got},
          "train": {"config": "REDUCED", "steps": 2,
                    "tokens": VLM_TRAIN_BATCH * VLM_TRAIN_SEQ,
                    "losses": losses, "grad_norms": norms,
                    "launches": train_launches,
                    "op_replay": train_replay}})
    gc.collect()
    torch.cuda.empty_cache()
    return {k: res["launches"].get(k, 0) + train_launches[k]
            for k in train_launches}


def phase_audio(torch, card):
    """whisper-base at full width and depth (module docstring): trained
    AUD_STEPS steps with frames, its encoder run alone, then served from
    captured stages.  Returns the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.recipe import RECIPES
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        quantize_weights_for_serving, serving_memory_report)
    from repro_torch.train.train_step import make_optimizer
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("whisper-base").replace(linear_impl="pallas",
                                             attention_impl="pallas")
    model = build_model(cfg)
    if model.reads_cross:
        raise AssertionError("audio: a decoder layer has a cross sublayer")
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)
    tcfg = TrainConfig(recipe="paper_fp4", total_steps=AUD_STEPS,
                       global_batch=AUD_BATCH, seq_len=AUD_SEQ, log_every=0)
    pipeline = StatesPipeline(
        SyntheticLM(cfg.vocab_size, AUD_SEQ, AUD_BATCH, seed=0), "frames",
        cfg.n_frames, cfg.d_model)
    trainer = Trainer(model, tcfg, pipeline)
    state = trainer.init_state(params=model.init(0, on_device=True))
    enc0 = tree_map(torch.clone, state.params["encoder"])
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    for kern in kernels:
        kern.reset()
    per_step, peaks = [], []
    for step in range(AUD_STEPS):
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        if step == 0:
            with TrainRecorder(TrainRecorder.GPT2, AUD_REPLAY_LAYERS) as rec:
                state = trainer.train(state, num_steps=1)
        else:
            state = trainer.train(state, num_steps=1)
        peaks.append(int(torch.cuda.max_memory_allocated()))
        per_step.append({k.name: k.launches - before[k.name]
                         for k in kernels})
    train_launches = {k.name: k.launches for k in kernels}
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    norms = [r["grad_norm"] for r in hist]
    p50 = float(np.median([r["dt"] for r in hist][1:]))
    failures = []
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
        failures.append(f"non-finite loss or grad norm: {losses} {norms}")
    if min(train_launches.values()) <= 0:
        failures.append(f"a kernel never ran: {train_launches}")
    # The dead encoder: zero gradients, so AdamW's moments stay 0 and the
    # leaves move by its weight decay alone, bit for bit the same update
    # on zero gradients
    opt = make_optimizer(model, tcfg)
    want = tree_map(torch.clone, enc0)
    ost = opt.init(want)
    for r in hist:
        want, ost = opt.update(tree_map(torch.zeros_like, want), ost, want,
                               r["lr"])
    moments = [m for t in (state.opt_state.mu["encoder"],
                           state.opt_state.nu["encoder"])
               for m in tree_leaves(t)]
    enc_zero = all(not bool(m.any()) for m in moments)
    enc_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params["encoder"]), tree_leaves(want)))
    enc_moved = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params["encoder"]), tree_leaves(enc0)))
    if not (enc_zero and enc_equal and enc_moved):
        failures.append(f"encoder: moments zero {enc_zero}, equal to decay "
                        f"alone {enc_equal}, leaves moved {enc_moved}")
    train_replay = train_layer_replay(torch, rec, "audio", flash=False)
    del rec, want, ost, enc0

    # The encoder alone on 8 x 1500 frames, layers 0 and 5 replayed
    pc = model.cast_params(state.params)
    plan = model._plan(RECIPES["paper_fp4"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((AUD_ENC_BATCH, cfg.n_frames, cfg.d_model),
                         generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        with KernelRecorder(AUD_REPLAY_LAYERS) as enc_rec:
            enc_out = model._encode(pc, frames, plan)
        enc_finite = bool(torch.isfinite(enc_out).all())
        enc_ms = Timer(torch).ms(lambda: model._encode(pc, frames, plan),
                                 iters=5)
    del enc_out
    enc_rows, enc_replay = replay_stages(
        torch, (("encoder", enc_rec),), AUD_REPLAY_LAYERS, "audio encoder")
    enc_calls = {layer: calls_by_layer(enc_rows, "encoder", layer)
                 for layer in AUD_REPLAY_LAYERS}
    if not enc_finite or any(c != AUD_ENC_CALLS
                             for c in enc_calls.values()):
        failures.append(f"encoder finite {enc_finite}, calls {enc_calls}")
    del pc, enc_rec

    # Serving: packed fp4, fp8 KV, captured stages
    smodel = build_model(cfg.replace(kv_cache_format="fp8_e4m3"))
    sparams = smodel.cast_params(quantize_weights_for_serving(
        smodel, state.params, "fp4_e2m1"))
    mem = serving_memory_report(sparams)
    prompts = torch.tensor([AUD_SOT] * AUD_SERVE, device="cuda")
    sframes = torch.randn((AUD_SERVE, cfg.n_frames, cfg.d_model),
                          generator=gen, device="cuda").to(torch.bfloat16)
    res = generate_checked(torch, smodel, sparams, prompts,
                           {"frames": sframes}, AUD_NEW,
                           RECIPES["paper_fp4"], kernels, alone=(0,),
                           what="audio")
    # every row the same: the frames differ, but no decoder layer reads
    # them (reference property: no cross sublayer at a period of 1)
    rows_equal = bool((res["tokens"] == res["tokens"][:1]).all())
    if not rows_equal:
        failures.append("rows with other frames gave other tokens")
    dec_ms = res["decode_step_ms"]
    emit({"phase": "audio", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers,
          "n_encoder_layers": cfg.n_encoder_layers,
          "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
          "n_frames": cfg.n_frames, "params": n_params,
          "train": {"global_batch": AUD_BATCH, "seq_len": AUD_SEQ,
                    "steps": AUD_STEPS, "recipe": "paper_fp4",
                    "losses": losses, "grad_norms": norms,
                    "step_ms": [r["dt"] * 1e3 for r in hist],
                    "step_p50_ms_after_first": p50 * 1e3,
                    "tokens_per_s": AUD_BATCH * AUD_SEQ / p50,
                    "max_memory_allocated": max(peaks),
                    "launches_per_step": per_step,
                    "encoder_moments_zero": enc_zero,
                    "encoder_equals_decay_alone": enc_equal,
                    "encoder_leaves_moved": enc_moved,
                    "op_replay": train_replay},
          "encoder": {"batch": AUD_ENC_BATCH, "ms": enc_ms,
                      "kernel_replay": {**enc_replay,
                                        "calls_by_layer": enc_calls}},
          "serve": {"prompts": AUD_SERVE, "prompt": list(AUD_SOT),
                    "new_tokens": AUD_NEW, "jit": True,
                    "capture_warmup_s": res["capture_warmup_s"],
                    "prefill_ms": res["prefill_ms"],
                    "decode_step_p50_ms": float(np.median(dec_ms)),
                    "decode_steps": len(dec_ms),
                    "tokens_per_s": res["tokens_per_s"],
                    "wall_s": res["wall_s"],
                    "max_memory_allocated": res["peak"],
                    "packed_bytes_per_param": mem["bytes_per_packed_param"],
                    "launches": res["launches"],
                    "row0_vs_alone": "token-exact",
                    "rows_equal": rows_equal}})
    if failures:
        raise AssertionError("audio phase: " + "; ".join(failures))
    del trainer, state, sparams, smodel, model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: train_launches[k] + res["launches"][k]
            for k in train_launches}


class StepZeroRecorder(TrainRecorder):
    """``TrainRecorder`` keeping the calls of the first training step
    only (``done`` is set when it ends), each copied to the host at once:
    a step that fills the card leaves no room for the copies there."""

    done = False

    def _keep(self, layer, role, fn, args, kw, y):
        if not self.done and layer in self.layers:
            self.records.append({
                "layer": layer, "role": role, "fn": fn, "kw": kw,
                "args": [a.detach().cpu() if hasattr(a, "detach") else a
                         for a in args], "out": _clone(y, host=True)})


def qlint_on_card(torch):
    """``python -m repro_torch.analysis.qlint`` (QLINT_ARGV) in process on
    the card: the exit code, the output and each report (its cells'
    routes, kernel calls by role and kind, and the CUDA kernels the
    profiler trace shows under each role).  Raises unless it exits 0
    (no violation, no drift from the committed expectations) with no
    fallback, a port kernel in the trace under every pallas role (qlint
    itself requires one of each kind the role called) and every kernel
    call found in the trace."""
    import contextlib
    import io
    from repro_torch.analysis import qlint
    from repro_torch.analysis.trace import PORT_KERNELS
    port_kernels = {k for ks in PORT_KERNELS.values() for k in ks}
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "qlint.json")
        with contextlib.redirect_stdout(buf):
            rc = qlint.main([*QLINT_ARGV, "--json", path])
        with open(path) as f:
            reports = json.load(f)["reports"]
    torch.cuda.synchronize()
    out = {"argv": list(QLINT_ARGV), "rc": rc, "graphs": {}}
    failures = [] if rc == 0 else [f"exit code {rc}"]
    for r in reports:
        pallas_roles = sorted({c["role"] for c in r["cells"]
                               if c["route"] == "pallas"})
        traced = r["summary"].get("trace_role_ops", {})
        out["graphs"][r["label"]] = {
            "n_cells": len(r["cells"]), "n_violations": r["n_violations"],
            "n_fallbacks": r["n_fallbacks"],
            "kernel_calls_by_role": r["summary"]["pallas_calls"],
            "kernel_calls_by_kind": r["summary"]["kernels"],
            "qdq_markers": r["summary"]["qdq_markers"],
            "trace_role_ops": traced}
        if r["n_violations"] or r["n_fallbacks"]:
            failures.append(f"{r['label']}: {r['n_violations']} violations,"
                            f" {r['n_fallbacks']} fallbacks")
        missing = [role for role in pallas_roles
                   if not port_kernels & set(traced.get(role, {}))]
        out["graphs"][r["label"]].update(
            trace_calls_not_found=r["summary"]["trace_calls_not_found"],
            trace_kernels_left_over=r["summary"]["trace_kernels_left_over"])
        if missing:
            failures.append(f"{r['label']}: no CUDA kernel in the trace "
                            f"under roles {missing}")
        if r["summary"]["trace_calls_not_found"]:
            failures.append(f"{r['label']}: "
                            f"{r['summary']['trace_calls_not_found']} kernel"
                            f" call(s) not found in the profiler trace")
    text = buf.getvalue()
    out["expectations_match"] = "qlint: expectations match" in text
    if not out["expectations_match"]:
        failures.append("no 'expectations match' line: "
                        + " | ".join(line for line in text.splitlines()
                                     if "qlint:" in line)[:2000])
    if failures:
        raise AssertionError(f"qlint on the card: {failures}; {out}")
    return out


def phase_autotune(torch, card):
    """The tuning table on the card (module docstring): validate the
    committed table, sweep AUTOTUNE_JOBS again into a temporary table
    beside the committed winners, hold every built tiling bitwise against
    128 x 128 on them, and train gpt2-125m on an empty table and on the
    committed one (bitwise equal)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import autotune, fp4_matmul, qmm_stream
    from repro_torch.kernels.build import TILINGS
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    failures = []
    errors = autotune.validate_table(autotune.DEFAULT_TABLE_PATH)
    committed = autotune.TuningTable.load(autotune.DEFAULT_TABLE_PATH)
    unbuilt = [k for k in committed.entries
               if committed.lookup(k) not in TILINGS]
    if errors or unbuilt:
        failures.append(f"committed table: {errors} {unbuilt}")
    g = torch.Generator(device="cuda").manual_seed(0)
    sweeps, bitwise = [], []
    for job in AUTOTUNE_JOBS:
        job = {"trans_a": False, "trans_b": False, "dtype": "bfloat16",
               **job}
        times = {}
        autotune.autotune_qmm(**job, table=autotune.TuningTable(),
                              times=times)
        a = torch.randn(*((job["k"], job["m"]) if job["trans_a"] else
                          (job["m"], job["k"])), generator=g,
                        device="cuda").bfloat16()
        b = torch.randn(job["k"], job["n"], generator=g,
                        device="cuda").bfloat16() * 0.05
        kw = {k: job[k] for k in ("a_mode", "b_mode", "a_fmt", "b_fmt",
                                  "trans_a", "trans_b")}
        if job.get("b_sr"):
            kw.update(b_sr=True, seed_b=job["seed_b"])
        kw["collect_stats"] = bool(job.get("collect_stats"))
        _, key = fp4_matmul.resolve_qmm_tiles(
            a, b, kw["a_mode"], kw["b_mode"], kw["trans_a"], kw["trans_b"],
            bm=128)
        outs = {t: fp4_matmul.fused_qmm(a, b, bm=t[0], bn=t[1], **kw)
                for t in TILINGS}
        torch.cuda.synchronize()
        ref = outs[TILINGS[0]]
        for t, out in outs.items():
            y, stats = out if kw["collect_stats"] else (out, ())
            y0, stats0 = ref if kw["collect_stats"] else (ref, ())
            same = torch.equal(y.view(torch.int16), y0.view(torch.int16))
            same_stats = all(torch.equal(s, s0) for s, s0 in
                             zip(stats, stats0) if s is not None)
            bitwise.append({"key": key, "tiles": list(t[:2]),
                            "values": same, "stats": same_stats})
            if not (same and same_stats):
                failures.append(f"{key} at {t[:2]} differs from 128 x 128")
        sweeps.append({"key": key, "us": {f"{t[0]}x{t[1]}": v
                                          for t, v in times.items()},
                       "committed": committed.entries.get(key)})
        if key not in committed.entries:
            failures.append(f"{key} is not in the committed table")
        del a, b, outs, ref
    # gpt2-125m on an empty table, then on the committed one
    cfg = get_config("gpt2-125m").replace(linear_impl="pallas",
                                          attention_impl="pallas",
                                          remat=False)
    runs = {}
    for name, table in (("empty", autotune.TuningTable()),
                        ("committed", None)):
        autotune.set_table(table)
        tcfg = TrainConfig(recipe="paper_fp4", total_steps=TRAIN_STEPS,
                           global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           log_every=0)
        trainer = Trainer(build_model(cfg), tcfg, SyntheticLM(
            cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
        state = trainer.init_state(seed=0, on_device=True)
        before = dict(autotune.COUNTERS)
        qmm_stream.KERNEL.tile_launches.clear()
        state = trainer.train(state, num_steps=AUTOTUNE_STEPS)
        torch.cuda.synchronize()
        runs[name] = {
            "losses": [r["loss"] for r in trainer.history],
            "grad_norms": [r["grad_norm"] for r in trainer.history],
            "step_p50_ms": float(np.median(
                [r["dt"] for r in trainer.history[1:]])) * 1e3,
            "table": {c: autotune.COUNTERS[c] - before[c]
                      for c in before},
            "qmm_stream_tiles": {f"{t[0]}x{t[1]}": n for t, n in
                                 qmm_stream.KERNEL.tile_launches.items()},
            "params": [p.detach().clone()
                       for p in tree_leaves(state.params)]}
        del trainer, state
    autotune.set_table(None)
    e, c = runs["empty"], runs["committed"]
    params_equal = len(e["params"]) == len(c["params"]) and all(
        torch.equal(x, y) for x, y in zip(e["params"], c["params"]))
    if e["losses"] != c["losses"] or e["grad_norms"] != c["grad_norms"] \
            or not params_equal:
        failures.append("gpt2-125m on the committed table differs from "
                        "the empty table")
    if c["table"]["miss"] or not c["table"]["hit"]:
        failures.append(f"gpt2-125m's keys missed the table: {c['table']}")
    for r in runs.values():
        del r["params"]
    line = {"phase": "autotune", "card": card,
            "table": str(autotune.DEFAULT_TABLE_PATH.relative_to(ROOT)),
            "table_meta": committed.meta,
            "entries": len(committed.entries), "validate": errors,
            "sweeps": sweeps, "bitwise": bitwise,
            "gpt2_125m": runs, "params_equal": params_equal,
            "seconds": time.perf_counter() - t0,
            "budget_s": AUTOTUNE_BUDGET_S}
    emit(line)
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("autotune phase: " + "; ".join(failures))


def phase_train_cli(torch, card):
    """``launch/train.py`` trains llama3.2-3b at full width and depth in
    process (module docstring), then the qlint CLI audits tiny on the
    card.  Gate both; return the training run's launch counts."""
    import contextlib
    import io
    from repro_torch.kernels import (autotune, build, flash_attention,
                                     qmm_stream, quantize_rows, tiled_mm)
    from repro_torch.launch import train as cli
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    kernels = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL,
               flash_attention.KERNEL)
    for kern in build.KERNELS:
        kern.reset()
    autotune.set_table(None)     # the committed table, resolved afresh
    table_before = dict(autotune.COUNTERS)
    steps, record = [], Trainer._record
    rec = StepZeroRecorder(TrainRecorder.SWIGLU, CLI_REPLAY_LAYERS)

    def hooked(self, *args, **kw):
        rec.done = True
        torch.cuda.synchronize()
        steps.append({"peak": int(torch.cuda.max_memory_allocated()),
                      "counts": {k.name: k.counts() for k in kernels}})
        torch.cuda.reset_peak_memory_stats()
        return record(self, *args, **kw)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    Trainer._record = hooked
    try:
        with rec, contextlib.redirect_stdout(buf):
            res = cli.main(list(CLI_ARGV))
    finally:
        Trainer._record = record
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    counts = {k.name: k.counts() for k in kernels}
    launches = {k.name: k.launches for k in kernels}
    table = {c: autotune.COUNTERS[c] - table_before[c]
             for c in table_before}
    tiles = {k.name: {f"{t[0]}x{t[1]}": n
                      for t, n in sorted(k.tile_launches.items())}
             for k in (qmm_stream.KERNEL, tiled_mm.KERNEL)}
    trainer = res["trainer"]
    cfg, summ = trainer.model.cfg, res["step_time"]
    n_params = trainer.model.param_count()
    losses = [r["loss"] for r in trainer.history]
    switch = trainer.schedule.switch_step
    per_step, prev = [], {k.name: dict.fromkeys(k.counts(), 0)
                          for k in kernels}
    for st in steps:
        per_step.append({n: {c: v - prev[n][c] for c, v in cs.items()
                             if c in ("launches", "tc", "trans",
                                      "recompute")}
                         for n, cs in st["counts"].items()})
        prev = st["counts"]
    flash_shapes = sorted({tuple(r["args"][0].shape) for r in rec.records
                           if r["role"] == "flash"})
    failures = []
    if n_params != CLI_PARAMS or (cfg.n_layers, cfg.d_model, cfg.d_ff,
                                  cfg.vocab_size,
                                  cfg.resolved_head_dim) != CLI_DIMS:
        failures.append(f"not llama3.2-3b at full size: {n_params} "
                        f"parameters, {cfg}")
    if len(losses) != CLI_STEPS or not all(np.isfinite(losses)):
        failures.append(f"losses: {losses}")
    if min(launches.values()) <= 0 or \
            min(counts[k]["recompute"] for k in launches) <= 0:
        failures.append(f"a kernel of the path never ran, or never in a "
                        f"recompute: {counts}")
    if any(counts[k]["tc"] != counts[k]["launches"] for k in TC_SOURCES):
        failures.append(f"a GEMM or flash launch left the tensor-core "
                        f"route: {counts}")
    if flash_shapes != [(CLI_BATCH * cfg.n_heads, CLI_SEQ, CLI_DIMS[-1])]:
        failures.append(f"flash shapes {flash_shapes}")
    if table["miss"] or not table["hit"]:
        failures.append(f"a key of the step missed the tuning table: "
                        f"{table}")
    for prefix in ("eval:", "step-time:", "roofline["):
        if not any(line.startswith(prefix) for line in text.splitlines()):
            failures.append(f"no {prefix!r} line from the CLI")
    peaks = [st["peak"] for st in steps]
    line = {"phase": "train_cli", "card": card, "argv": list(CLI_ARGV),
            "model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
            "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "params": n_params, "remat": cfg.remat_policy if cfg.remat
            else "none", "switch_step": switch, "losses": losses,
            "plans": [r["recipe"] for r in trainer.history],
            "step_ms": [r["dt"] * 1e3 for r in trainer.history],
            "step_time": summ, "eval": res["eval"],
            "roofline": res["roofline"],
            "max_memory_allocated_per_step": peaks,
            "max_memory_allocated": max(peaks),
            "launches_per_step": per_step, "counts": counts,
            "tuning_table": table, "tile_launches": tiles,
            "flash_shapes": flash_shapes, "run_s": run_s,
            "cli_lines": [ln for ln in text.splitlines()
                          if not ln.startswith("step ")]}
    if failures:
        emit(line)
        raise AssertionError("train_cli phase: " + "; ".join(failures))
    profile_train_step(torch, trainer._step_fn(trainer.plan), res["state"],
                       trainer._batch(trainer.pipeline, 0), card,
                       phase="train_cli_profile", plan=trainer.plan.name)
    del res, trainer
    gc.collect()
    torch.cuda.empty_cache()
    line["op_replay"] = train_layer_replay(torch, rec, what="train_cli",
                                           on_card=True)
    del rec
    line["qlint"] = qlint_on_card(torch)
    line["phase_s"] = time.perf_counter() - t0
    emit(line)
    return launches


def phase_blockwise(torch, card):
    """``kernels.ops.quantize_blockwise`` over every 2-D weight of a seeded
    gpt2-125m (bf16): fp4 (128 x 128) tiles and fp8 (1 x 128) rows, each
    bitwise against the plain version; returns the launch count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qb
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    cfg = get_config("gpt2-125m").replace(scan_layers=False)
    weights = [p.to(torch.bfloat16) for p in
               tree_leaves(build_model(cfg).init(seed=0)) if p.dim() == 2]
    calls = [(w, fmt, per_row) for w in weights
             for fmt, per_row in (("fp4_e2m1", False), ("fp8_e4m3", True))]
    torch.cuda.synchronize()
    qb.KERNEL.reset()
    t0 = time.perf_counter()
    outs = [ops.quantize_blockwise(w, fmt, per_row=per_row)
            for w, fmt, per_row in calls]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = qb.KERNEL.launches
    bad = sum(not torch.equal(y.view(torch.int16), qb.quantize_blockwise_plain(
        w, fmt, per_row=per_row).view(torch.int16))
        for y, (w, fmt, per_row) in zip(outs, calls))
    emit({"phase": "blockwise", "card": card, "model": cfg.name,
          "weights": len(weights),
          "elements": sum(w.numel() for w in weights), "calls": len(calls),
          "launches": launches, "wall_ms": wall_ms,
          "outputs_differing": bad})
    if bad or launches != len(calls):
        raise AssertionError(f"blockwise: {bad} outputs differ from the "
                             f"plain version, {launches} launches for "
                             f"{len(calls)} calls")
    return {"quantize_blockwise": launches}


def main() -> int:
    # ``--phase slice`` / ``--phase serve_swa``: the build and that one
    # serving phase alone (an A/B of one path across checkouts); no
    # launches, kernels or ok line.
    solo = {"slice": phase_slice, "serve_swa": phase_serve_swa,
            "moe_kernels": phase_moe_kernels, "train_moe": phase_train_moe,
            "serve_moe": phase_serve_moe, "ssm_kernels": phase_ssm_kernels,
            "train_ssm": phase_train_ssm, "serve_ssm": phase_serve_ssm,
            "hybrid": phase_hybrid, "vlm": phase_vlm, "audio": phase_audio,
            "train_kernels": phase_train_kernels,
            "autotune": phase_autotune, "train_cli": phase_train_cli}
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--phase"
                 or args[1] not in solo):
        print(f"usage: chip_smoke.py [--phase {{{','.join(solo)}}}]",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    phase_build(card)
    if args:
        solo[args[1]](torch, card)
        print(f"card: {card}", flush=True)
        return 0
    seconds_at = {}   # seconds from the start when each phase ended

    def lap(name):
        torch.cuda.empty_cache()
        seconds_at[name] = time.perf_counter() - t0
    lap("build")
    phase_kernels(torch, card)
    rows = phase_train_kernels(torch, card)
    tel_rows = phase_telemetry_kernels(torch, card)
    moe_rows = phase_moe_kernels(torch, card)
    ssm_rows = phase_ssm_kernels(torch, card)
    lap("kernels")
    serve_launches = phase_slice(torch, card)
    lap("slice")
    swa_launches = phase_serve_swa(torch, card)
    lap("serve_swa")
    train_launches, paper_p50_ms = phase_train(torch, card)
    tel_launches = phase_train_telemetry(torch, card, paper_p50_ms)
    lap("train")
    with tempfile.TemporaryDirectory() as cal_dir:
        cal_path = phase_speed_factors(torch, card, cal_dir)
        adaptive_launches = phase_train_adaptive(torch, card, cal_path)
    lap("train_adaptive")
    large_launches = phase_train_large(torch, card)
    lap("train_large")
    phase_autotune(torch, card)
    lap("autotune")
    cli_launches = phase_train_cli(torch, card)
    lap("train_cli")
    moe_train_launches, moe_train_batched = phase_train_moe(torch, card)
    lap("train_moe")
    moe_serve_launches, moe_serve_batched = phase_serve_moe(torch, card)
    lap("serve_moe")
    moe_batched = {"train": moe_train_batched, "serve": moe_serve_batched}
    ssm_train_launches = phase_train_ssm(torch, card)
    lap("train_ssm")
    ssm_serve_launches = phase_serve_ssm(torch, card)
    lap("serve_ssm")
    hybrid_launches = phase_hybrid(torch, card)
    lap("hybrid")
    vlm_launches = phase_vlm(torch, card)
    lap("vlm")
    audio_launches = phase_audio(torch, card)
    lap("audio")
    block_launches = phase_blockwise(torch, card)
    by_path = {"serve": serve_launches, "serve_swa": swa_launches,
               "train": train_launches,
               "train_telemetry": tel_launches,
               "train_adaptive": adaptive_launches,
               "train_large": large_launches,
               "train_cli": cli_launches,
               "train_moe": moe_train_launches,
               "serve_moe": moe_serve_launches,
               "train_ssm": ssm_train_launches,
               "serve_ssm": ssm_serve_launches, "hybrid": hybrid_launches,
               "vlm": vlm_launches, "audio": audio_launches,
               "blockwise": block_launches}
    emit({"launches": by_path, "seconds": time.perf_counter() - t0,
          "seconds_at_end_of": seconds_at})

    # One record per kernel: launches from the path that runs it (this
    # slice's adaptive gpt2-125m train path; quantize_blockwise's own
    # entry point; every path's in "launches_by_path"), the call that the
    # row stands for (its first forward use at the gpt2-125m training
    # shapes).
    launches = {**adaptive_launches, **block_launches}
    main_role = {"qmm_stream": "fwd w_up", "quantize_rows": "fwd wq lhs",
                 "tiled_mm": "fwd wq", "flash_attention": "fwd",
                 "quantize_blockwise": "tile"}
    source = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {"quantize_rows": "src/repro/kernels/fp4_matmul.py:283",
                "qmm_stream": "src/repro/kernels/fp4_matmul.py:713",
                "tiled_mm": "src/repro/kernels/fp4_matmul.py:576",
                "flash_attention": "src/repro/kernels/flash_attention.py:33",
                "quantize_blockwise": "src/repro/kernels/quantize.py:25"}
    kernels = []
    for name in ("qmm_stream", "quantize_rows", "tiled_mm",
                 "flash_attention", "quantize_blockwise"):
        mine = [r for r in rows + tel_rows + moe_rows + ssm_rows
                if r["name"] == name]
        rep = next(r for r in mine
                   if r.get("role", r.get("mode")) == main_role[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source.format(name),
            "replaces": replaces[name], "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts
                                 in by_path.items() if name in counts},
            "batched_launches_by_path": {
                path: counts[name] for path, counts in (
                    ("train_moe", moe_batched["train"]),
                    ("serve_moe", moe_batched["serve"]))
                if name in counts},
            "batched_rows": [
                {k: r[k] for k in ("role", "shape", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err")}
                for r in moe_rows if r["name"] == name],
            "ssm_rows": [
                {k: r[k] for k in ("role", "shape", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err", "route")}
                for r in ssm_rows if r["name"] == name],
            "noncausal_rows": [
                {k: r[k] for k in ("role", "shape", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err", "route")}
                for r in rows if r["name"] == name
                and r.get("causal") is False],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": rep["shape"],
            "card": card})
    print(f"card: {card}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
