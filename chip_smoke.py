#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failed phase raises: no ok line, exit
code 1):

1. build   — nvcc builds the three CUDA kernels of
   ``src/repro_torch/kernels/csrc`` for sm_90a, all at once.
2. kernels — each kernel against its plain PyTorch version on the card at
   the serving slice's shapes (bf16; M in {8, 16, 128, 512}, (K, N) in
   {(768, 768), (768, 3072), (3072, 768)}): QDQ panels bitwise, GEMM
   outputs within one bf16 ulp (+1e-5 max|y|), and the stream kernel
   bitwise against quantize_rows + tiled_mm (equal summation order).
   Times with CUDA events, L2 flushed before every launch, beside the
   plain version and ``torch.matmul`` on the same pre-quantized operands.
3. slice   — serves gpt2-125m at full width (12 layers, d 768, d_ff 3072,
   vocab 50257; seeded init) through the packed-FP4 ``ContinuousBatcher``
   (fp8 KV, paper_fp4, linear_impl "pallas"): 8 slots, max_len 1024, 16
   requests with prompt lengths drawn with seed 0 in [16, 512] and 64 new
   tokens each.  Checks 2 requests token-exact against the sequential
   ``generate``, and one request's teacher-forced forward on the card
   against the same port on the CPU, in f32 and bf16: every linear and
   attention call replayed on the CPU on the card's inputs, and the bf16
   logits end to end beside a control that must miss (see OP_BOUND).  A
   ``profile`` line splits 5 batched decode steps by kernel from a
   ``torch.profiler`` trace.
4. the launch counts of the slice's run (every count must be > 0) and the
   ``{"kernels": [...]}`` line; the card line; the ok line last.

Exits non-zero without a result when there is no CUDA device or when the
port is not beside this script.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12          # dense bf16 tensor cores
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
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


def phase_build(card):
    from repro_torch.kernels import build
    seconds, logs = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "sources": list(build.SOURCES), "ptxas": ptxas})


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

    def bound(nbytes, flops, peak):
        t_b, t_o = nbytes / H100_BYTES_PER_S, flops / peak
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

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
            b_ms, b_by = bound(4 * m * k, 8 * m * k, H100_F32_FLOPS)
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
            y = qs.qmm_stream(a, w, **kw)
            err = gemm_err(y, qs.qmm_stream_plain(a, w, **kw))
            aq = qr.quantize_rows(a, mode="block", fmt_name="fp4_e2m1")
            if not torch.equal(y.view(torch.int16),
                               tm.tiled_mm(aq, w).view(torch.int16)):
                raise AssertionError(
                    f"qmm_stream ({m}, {k}, {n}) != quantize_rows + "
                    "tiled_mm bitwise")
            b_ms, b_by = bound(2 * (m * k + k * n + m * n), 2 * m * n * k,
                               H100_BF16_FLOPS)
            rows.append({
                "name": "qmm_stream", "shape": [m, k, n],
                "max_abs_err": err,
                "ms": timer.ms(lambda: qs.qmm_stream(a, w, **kw)),
                "plain_ms": timer.ms(lambda: qs.qmm_stream_plain(a, w,
                                                                 **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timer.ms(lambda: torch.matmul(aq, w))})
            if (k, n) == (768, 768):
                xq = qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3")
                err = gemm_err(tm.tiled_mm(xq, w), tm.tiled_mm_plain(xq, w))
                rows.append({
                    "name": "tiled_mm", "shape": [m, k, n],
                    "max_abs_err": err,
                    "ms": timer.ms(lambda: tm.tiled_mm(xq, w)),
                    "plain_ms": timer.ms(lambda: tm.tiled_mm_plain(xq, w)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": timer.ms(lambda: torch.matmul(xq, w))})
    torch.cuda.synchronize()
    emit({"phase": "kernels", "card": card, "dtype": "bfloat16",
          "ok": True, "table": rows})
    return rows


def profile_decode(torch, engine, card, steps: int = 5) -> None:
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
    groups = (("qmm_stream", ("qmm_stream_kernel",)),
              ("quantize_rows", ("quantize_rows_kernel",
                                 "tensor_amax_kernel")),
              ("tiled_mm", ("tiled_mm_kernel",)),
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
    emit({"phase": "profile", "card": card, "steps": steps,
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


def phase_slice(torch, card):
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
    from repro_torch.models import build_model
    from repro_torch.train.serve import generate
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

    batcher = ContinuousBatcher(model, params, n_slots=8, max_len=1024,
                                recipe=recipe, kv_format="fp8_e4m3")
    engine = batcher.engine
    # Warm-up request (cuBLAS handles, allocator), not counted.
    warm = ContinuousBatcher(model, params, n_slots=8, max_len=1024,
                             recipe=recipe, kv_format="fp8_e4m3")
    warm.submit(prompts[0][:16], 4)
    warm.run()
    del warm

    prefill_ms, step_ms = {}, []
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
        out = orig_step()           # ends in a device -> host copy
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.prefill, engine.generate_step = timed_prefill, timed_step
    ids = [batcher.submit(p, new_tokens) for p in prompts]
    for kern in (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL):
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in
                (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)}
    peak = torch.cuda.max_memory_allocated()
    engine.prefill, engine.generate_step = orig_prefill, orig_step
    if sorted(out) != sorted(ids) or any(len(out[i]) != new_tokens
                                         for i in ids):
        raise AssertionError("batcher did not serve every request in full")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # Engine vs the sequential reference, token-exact, for 2 requests.
    for rid in ids[:2]:
        ref = generate(engine.model, engine.params,
                       torch.from_numpy(prompts[rid])[None],
                       max_new_tokens=new_tokens, recipe=recipe)
        ref = ref[0, len(prompts[rid]):].tolist()
        if out[rid] != ref:
            first = next(i for i, (a, b) in enumerate(zip(out[rid], ref))
                         if a != b)
            raise AssertionError(f"request {rid}: engine != sequential "
                                 f"generate from token {first}")

    profile_decode(torch, engine, card)

    # Teacher-forced logits of request 0 (its prompt and generated
    # tokens, first TF_TOKENS), card vs CPU with the same packed weights;
    # the CPU runs the kernels' plain versions.
    seq = np.concatenate([prompts[0], np.asarray(out[ids[0]])])
    tf = teacher_forced(torch, cfg, params, recipe,
                        torch.from_numpy(seq[:TF_TOKENS])[None])

    n_gen = sum(len(v) for v in out.values())
    emit({"phase": "slice", "card": card, "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "requests": len(ids), "new_tokens": new_tokens,
          "prompt_lengths": [int(n) for n in lengths],
          "prefill_ms_by_bucket": {
              str(b): float(np.median(v)) for b, v in
              sorted(prefill_ms.items())},
          "prefill_count_by_bucket": {
              str(b): len(v) for b, v in sorted(prefill_ms.items())},
          "decode_step_p50_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "tokens_per_s": n_gen / wall, "wall_s": wall,
          "max_memory_allocated": int(peak),
          "packed_bytes_per_param": mem["bytes_per_packed_param"],
          "engine_vs_sequential": "token-exact (2 requests)",
          "teacher_forced_card_vs_cpu": tf})
    return launches


def main() -> int:
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
    card = card_line()
    phase_build(card)
    rows = phase_kernels(torch, card)
    launches = phase_slice(torch, card)
    emit({"launches": launches})

    main_shape = {"quantize_rows": [8, 768], "qmm_stream": [8, 768, 3072],
                  "tiled_mm": [8, 768, 768]}
    source = {"quantize_rows": "src/repro_torch/kernels/csrc/quantize_rows.cu",
              "qmm_stream": "src/repro_torch/kernels/csrc/qmm_stream.cu",
              "tiled_mm": "src/repro_torch/kernels/csrc/tiled_mm.cu"}
    replaces = {"quantize_rows": "src/repro/kernels/fp4_matmul.py:283",
                "qmm_stream": "src/repro/kernels/fp4_matmul.py:713",
                "tiled_mm": "src/repro/kernels/fp4_matmul.py:576"}
    kernels = []
    for name in ("qmm_stream", "quantize_rows", "tiled_mm"):
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == main_shape[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
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
