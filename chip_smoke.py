#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phase slice | --phase serve_swa]

With ``--phase`` it runs the build and that serving phase alone and
prints no ok line.  Phases, each printing one line (a failed phase raises: no ok line, exit
code 1):

1. build   — nvcc builds the five CUDA kernels of
   ``src/repro_torch/kernels/csrc`` for sm_90a, all at once.  For
   ``qmm_stream``, ``tiled_mm`` and ``flash_attention`` it counts the
   HGMMA instructions in ``cuobjdump -sass`` (gate: > 0, the products run
   on wgmma) and reads registers and spills of their tensor-core kernels
   from ptxas (gate: no spill, no serialized wgmma).
2. kernels — each kernel against its plain PyTorch version on the card,
   bf16, with CUDA-event times (L2 flushed before every launch) beside
   the plain version, the bound and ``torch.matmul`` / SDPA on the same
   inputs.  Serving shapes (M in {8, 16, 128, 512}, (K, N) in {(768, 768),
   (768, 3072), (3072, 768)}) and, in a second line (``train_kernels``),
   the training step's shapes at 8192 tokens: the FFN forward, its dgrad
   (w read transposed, pass x pass) and wgrad (x read transposed, K =
   8192, fp8 blocks), the attention linears' two-pass route forward,
   dgrad and wgrad (token modes, both trans flags), and flash attention
   at (96, 1024, 64) and (48, 1024, 128).  QDQ panels bitwise, GEMM
   outputs within one bf16 ulp (+1e-5 max|y|), the stream kernel bitwise
   against quantize_rows + tiled_mm in the same layout, attention within
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
3b. serve_swa — serves h2o-danube-3-4b at full width and depth (24
   layers, d 3840, 32 heads and 8 KV heads of 120, d_ff 10240, vocab
   32000, sliding window 4096; seeded init drawn on the card) through
   the packed-FP4
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
   ``quantize_rows``, ``tiled_mm`` and ``qmm_stream`` call of layers 0
   and 23 in one exact-length prefill (M = request 0's prompt) and one
   batched decode step (M = 4) of an eager engine, again through the
   plain versions on the card on the same inputs (quantize passes
   bitwise, products within OP_BOUND: K 3840 and 10240, the ragged N =
   960 of wk / wv, both routes), beside a control that must miss (layer
   0's first FFN product with its activation unquantized); the ring
   check: request 0's tokens teacher-forced past the window through an
   f32 engine
   (bf16 recipe, packed weights, bf16 KV) within RING_BOUND of the
   windowed no-cache forward, and the forward with no window (the
   control) beyond it.  A ``serve_swa_profile`` line splits 5 batched
   decode steps by kernel.
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
9. blockwise — ``kernels.ops.quantize_blockwise`` (the standalone QDQ,
   ``_q_kernel``'s port) over every 2-D weight of a seeded gpt2-125m, fp4
   tiles and fp8 rows, each output bitwise against the plain version.
10. the launch counts of each path's run, ``serve_swa``'s among them
   (every kernel of a path must have run in it) and the ``{"kernels": [...]}`` line (launches from the
   adaptive train path of phase 7, ``quantize_blockwise``'s from phase 9,
   every path's in ``launches_by_path``; times at the gpt2-125m training
   shapes); the card line; the ok line last.

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

Every phase keeps the full depth of its model.  Exits non-zero without
a result when there is no CUDA device or when the port is not beside
this script.
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
# The serve_swa phase: h2o-danube-3-4b at full width and depth, 4 slots
# over a cache of max_len 8192 (a ring of 4096 positions a layer), 8
# requests of 3840-4096 prompt tokens and 384 new tokens each: every one
# decodes past the window.
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
SWA_REPLAY_LAYERS = (0, 23)
SWA_CALLS_PER_LAYER = {"quantize_rows": 4, "tiled_mm": 4, "qmm_stream": 3}


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
    tok = [
        ("fwd wq", x, w, ("fp8_e4m3", "fp8_e4m3"), False, False),
        ("dgrad wq", g_d, w, ("fp8_e5m2", "fp8_e4m3"), False, True),
        ("wgrad wq", x, g_d, ("fp8_e4m3", "fp8_e5m2"), True, False),
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
    # is not a power of two, at the same bytes.
    for role, heads, dh in (("fwd", 12, 64), ("fwd d128", 6, 128)):
        bh, s_ = TRAIN_BATCH * heads, TRAIN_SEQ
        q, k, v = (rand(bh, s_, dh) for _ in range(3))
        o, route = routed(fa.KERNEL, lambda: fa.flash_attention_fwd(q, k, v))
        ref = fa.flash_attention_fwd_plain(q, k, v)
        err = (o.float() - ref.float()).abs()
        if not bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all()):
            raise AssertionError(f"flash_attention {role} out of tolerance: "
                                 f"max err {err.max().item()}")
        q4, k4, v4 = (x_.view(TRAIN_BATCH, heads, s_, dh)
                      for x_ in (q, k, v))
        flops = 2 * dh * s_ * (s_ + 1) * bh
        b_ms, b_by = _bound(2 * 4 * bh * s_ * dh, flops, H100_BF16_FLOPS)
        ms = timer.ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10)
        rows.append({
            "name": "flash_attention", "role": role, "shape": [bh, s_, dh],
            "trans": False, "max_abs_err": err.max().item(), "ms": ms,
            "plain_ms": timer.ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v), iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(
                lambda: F_nn.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), iters=10),
            "route": route, "tflops": flops / (ms * 1e-3) / 1e12,
            "bound_share": b_ms / ms})
    precision = flash_precision(torch, fa)
    torch.cuda.synchronize()
    emit({"phase": "train_kernels", "card": card, "dtype": "bfloat16",
          "tokens": t, "ok": True, "table": rows,
          "flash_precision_d128": precision})
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


def serve_run(torch, batcher, prompts, new_tokens, kernels):
    """Serve ``prompts`` through ``batcher`` with every counter of
    ``kernels`` set to 0 first; returns (tokens by request, launches by
    kernel, prefill ms by bucket, decode-step ms, wall s, peak bytes).
    Raises unless every request got ``new_tokens`` tokens and every
    kernel launched."""
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
    if min(launches.values()) <= 0:
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

    # The eager engine (jit=False) on the first SLICE_EAGER requests:
    # the same tokens, its decode p50 beside the captured one's.
    eager = make(jit=False)
    eager.submit(prompts[0][:16], 2)
    eager.run()
    eager_out, eager_launches, eager_prefill_ms, eager_step_ms, _, _ = \
        serve_run(torch, eager, prompts[:SLICE_EAGER], new_tokens, kernels)
    if eager_out != out[:SLICE_EAGER]:
        raise AssertionError("captured engine != eager engine")
    del eager

    # Engine vs the sequential reference, token-exact, for 2 requests.
    for i in range(2):
        check_sequential(torch, engine, prompts[i], out[i], f"request {i}")

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


def kv_cache_bytes(cfg, n_slots, max_len):
    """Bytes of the engine's per-slot KV cache (every layer, lengths
    included) from the cache spec, allocating nothing."""
    import torch
    from repro_torch.models.attention import attn_cache_spec
    spec = attn_cache_spec(cfg, n_slots, max_len, torch.bfloat16,
                           per_slot=True)
    per_layer = sum(int(np.prod(shape)) * torch.empty((), dtype=dt)
                    .element_size() for shape, dt in spec.values())
    return cfg.n_layers * per_layer + 4 * n_slots


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
        else:
            row["shape"] = [a.shape[0], a.shape[1], c["args"][1].shape[1]]
            row["rel_l2"] = rel(y, ref)
            row["max_abs_err"] = float((y.float() - ref.float()).abs().max())
            if c["name"] == "qmm_stream" and control is None:
                control = rel(y, c["plain"](*c["args"],
                                            **{**kw, "a_mode": "pass"}))
        rows.append(row)
    return rows, control


def swa_kernel_replay(torch, cfg, params, recipe, prompt):
    """The GEMM kernels at serve_swa's own shapes against their plain
    versions: one exact-length prefill of ``prompt`` and one batched
    decode step of an eager engine (``SWA_SLOTS`` slots, so M = 4),
    recorded in ``SWA_REPLAY_LAYERS`` and replayed (``replay_plain``).
    Raises on a miss, a missing call or a control within the bound."""
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import DecodeEngine
    engine = DecodeEngine(build_model(cfg), params, n_slots=SWA_SLOTS,
                          max_len=SWA_MAX_LEN, recipe=recipe,
                          kv_format="fp8_e4m3", jit=False)
    with KernelRecorder(SWA_REPLAY_LAYERS) as pre:
        tok, c1 = engine.prefill(prompt)
    engine.insert(c1, tok, 0)
    with KernelRecorder(SWA_REPLAY_LAYERS) as dec:
        engine.generate_step()
    del engine, c1
    bound = OP_BOUND["bfloat16"]
    failures = []
    rows, controls = [], []
    for stage, rec in (("prefill", pre), ("decode", dec)):
        for layer in SWA_REPLAY_LAYERS:
            got = {n: sum(c["layer"] == layer and c["name"] == n
                          for c in rec.calls) for n in SWA_CALLS_PER_LAYER}
            if got != SWA_CALLS_PER_LAYER:
                failures.append(f"{stage} layer {layer} calls {got}")
        r, ctrl = replay_plain(torch, rec.calls, stage)
        rows += r
        controls.append(ctrl)
        del rec.calls
    worst = max((r["rel_l2"] for r in rows if "rel_l2" in r), default=None)
    not_bitwise = [r for r in rows if r.get("bitwise") is False]
    shapes = {(r["kernel"], tuple(r["shape"])) for r in rows}
    want = {"ragged N 960": any(k == "tiled_mm" and s[2] == 960
                                for k, s in shapes),
            "K 10240": any(k == "qmm_stream" and s[1] == 10240
                           for k, s in shapes),
            "M 4": any(s[0] == SWA_SLOTS for _, s in shapes),
            "M prompt": any(s[0] == len(prompt) for _, s in shapes)}
    if worst is None or not worst <= bound:
        failures.append(f"worst product rel L2 {worst} (bound {bound})")
    if not_bitwise:
        failures.append(f"{len(not_bitwise)} quantize_rows calls not "
                        "bitwise")
    if not all(want.values()):
        failures.append(f"shapes not covered: {want}")
    if any(c is None or not c > bound for c in controls):
        failures.append(f"a control did not miss the bound: {controls}")
    by_shape = {}
    for r in rows:
        key = f"{r['stage']} {r['kernel']} {r['shape']} {r['route']}"
        by_shape[key] = max(by_shape.get(key, 0.0), r.get("rel_l2", 0.0))
    out = {"layers": list(SWA_REPLAY_LAYERS), "calls": len(rows),
           "rel_l2_max": worst, "bound": bound,
           "quantized_not_bitwise": len(not_bitwise),
           "rel_l2_max_by_call": by_shape,
           "control_ffn_activation_unquantized": dict(
               zip(("prefill", "decode"), controls))}
    if failures:
        raise AssertionError(f"serve_swa kernel replay: {failures}; {out}")
    return out


def phase_serve_swa(torch, card):
    """h2o-danube-3-4b at full width and depth through the packed-FP4
    ``ContinuousBatcher`` with its ring-window caches (module docstring,
    phase 3b)."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        ContinuousBatcher, quantize_weights_for_serving,
        serving_memory_report)

    cfg = get_config("h2o-danube-3-4b").replace(linear_impl="pallas")
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
    kv_bytes = {str(n): kv_cache_bytes(engine.model.cfg, SWA_SLOTS, n)
                for n in (cfg.sliding_window, SWA_MAX_LEN)}
    held = sum(t.numel() * t.element_size()
               for layer in engine.cache["stack"]["layers"]
               for t in layer["self"].values()) + \
        engine.cache["length"].numel() * 4
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
    w_gate before w_up); in the backward, dgrad reads the forward's
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
                name = self.names[j] if j < len(self.names) else f"mm{j}"
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


def _clone(y):
    """A detached copy of a kernel call's result: a tensor, or (y, (stats
    vectors or None))."""
    if isinstance(y, tuple):
        return tuple(_clone(v) for v in y)
    return None if y is None else y.detach().clone()


def replay_train_ops(torch, records, control_role="dgrad wq",
                     control_kw=None, control_layer=0):
    """Each recorded card call again on the CPU (the plain versions) on
    the card's inputs.  Returns per-record (layer, role, relative L2 of
    the output, quantized operand elements that differ, for a call with
    the stats epilogue its stats checks) and the control: layer
    ``control_layer``'s ``control_role`` replayed with ``control_kw``
    (default: trans_b off, from a paper_fp4 step's wq dgrad)."""
    from repro_torch.core.qlinear import ZERO_KEY, kernel_quant_mode
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.kernels.rounding import fold_seed

    def rel(y, ref):
        y, ref = y.cpu().double(), ref.double()
        return float((y - ref).norm() / max(float(ref.norm()), 1e-30))

    def q_diff(x, spec, trans, kw, which):
        """Elements of the card's quantization of operand ``x`` that differ
        from the plain version's on the CPU (two-pass layout; an SR spec
        with the seed its role folds)."""
        if spec.is_passthrough:
            return 0
        qkw = dict(mode=kernel_quant_mode(spec), fmt_name=spec.fmt,
                   trans=trans, emit_trans=trans)
        if spec.stochastic:
            qkw.update(sr=True, seed=fold_seed(ZERO_KEY, kw["salt"], which))
        got = qr.quantize_rows(x, **qkw).cpu()
        qkw.pop("sr", None)
        return int((got != qr.quantize_rows_plain(x.cpu(), **qkw)).sum())

    out, control = [], None
    for r in records:
        args = [a.cpu() if hasattr(a, "cpu") else a for a in r["args"]]
        ref = r["fn"](*args, **r["kw"])
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
            bad = r["fn"](*args, **{**r["kw"], **(
                control_kw or dict(trans_a=False, trans_b=False))})
            control = rel(y, bad[0] if isinstance(bad, tuple) else bad)
    return out, control


# Host-side phase spans of the train loop (telemetry.profiler.phase_span):
# user annotations in a trace, not device work.
PHASE_SPANS = ("data", "step", "host", "fwd", "bwd", "optim")


def profile_train_step(torch, fn, state, batch, card, phase="train_profile",
                       plan="paper_fp4") -> None:
    """Split of one training step (of ``plan``) from a ``torch.profiler``
    trace: device time by kernel group and the device's busy share of the
    step's wall time."""
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
        if ev.device_type == DeviceType.CPU or ev.key in PHASE_SPANS:
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
    emit({"phase": phase, "card": card, "plan": plan,
          "device_ops": n_launches,
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
    solo = {"slice": phase_slice, "serve_swa": phase_serve_swa}
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
    phase_kernels(torch, card)
    rows = phase_train_kernels(torch, card)
    tel_rows = phase_telemetry_kernels(torch, card)
    serve_launches = phase_slice(torch, card)
    torch.cuda.empty_cache()
    swa_launches = phase_serve_swa(torch, card)
    torch.cuda.empty_cache()
    train_launches, paper_p50_ms = phase_train(torch, card)
    tel_launches = phase_train_telemetry(torch, card, paper_p50_ms)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as cal_dir:
        cal_path = phase_speed_factors(torch, card, cal_dir)
        adaptive_launches = phase_train_adaptive(torch, card, cal_path)
    torch.cuda.empty_cache()
    large_launches = phase_train_large(torch, card)
    block_launches = phase_blockwise(torch, card)
    by_path = {"serve": serve_launches, "serve_swa": swa_launches,
               "train": train_launches,
               "train_telemetry": tel_launches,
               "train_adaptive": adaptive_launches,
               "train_large": large_launches, "blockwise": block_launches}
    emit({"launches": by_path, "seconds": time.perf_counter() - t0})

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
        mine = [r for r in rows + tel_rows if r["name"] == name]
        rep = next(r for r in mine
                   if r.get("role", r.get("mode")) == main_role[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source.format(name),
            "replaces": replaces[name], "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts
                                 in by_path.items() if name in counts},
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
