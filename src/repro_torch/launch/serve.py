"""Serving launcher CLI: continuous-batched generation (counterpart of
``repro.launch.serve``, with the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --requests 6 --weight-quant fp4_e2m1

SSM archs serve too (``--arch mamba2-780m``: the engine prefills at the
exact length and keeps a state cache of fixed size).

Runs on ``--device cuda`` (the default; the engine's stages are CUDA
graphs there) or ``--device cpu``.  The CLI serves with the
reference's ``RECIPES["bf16"]``: every activation passes through
unquantized, so each linear is a plain matmul (over the expanded panel
with ``--weight-quant``) and no ported kernel launches.  ``main(argv)``
returns {request id: tokens}.
"""
import argparse
import importlib
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.recipe import RECIPES
from repro_torch.models import build_model
from repro_torch.train.serving_runtime import (ContinuousBatcher,
                                               quantize_weights_for_serving)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--weight-quant", default="none",
                    help="none | fp8_e4m3 | fp4_e2m1 (weight-only serving)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)

    if args.reduced:
        cfg = importlib.import_module(
            "repro_torch.configs."
            + args.arch.replace("-", "_").replace(".", "_")).REDUCED
    else:
        cfg = get_config(args.arch)
    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    if args.weight_quant != "none":
        params = quantize_weights_for_serving(model, params,
                                              args.weight_quant,
                                              device=args.device)
        print(f"weights quantized to {args.weight_quant} (per-block-128)")

    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(model, params, n_slots=args.slots,
                                max_len=256, recipe=RECIPES["bf16"],
                                device=args.device)
    ids = []
    for _ in range(args.requests):
        n = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        ids.append(batcher.submit(prompt, args.max_new))
    t0 = time.time()
    out = batcher.run()
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} tok/s) with {args.slots} slots")
    for rid in ids[:3]:
        print(f"  req {rid}: {out[rid]}")
    return out


if __name__ == "__main__":
    main()
