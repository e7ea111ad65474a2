"""Training launcher CLI (counterpart of ``repro.launch.train``, with the
reference's flags that the port supports plus ``--device``,
``--linear-impl`` and ``--attention-impl``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-125m \\
        --recipe paper_fp4 --steps 1000 --batch 16 --seq 256 \\
        --ckpt /tmp/ck --resume

Runs on ``--device cuda`` (the default; the parameters are drawn on the
card) or ``--device cpu``.  ``--linear-impl`` / ``--attention-impl``
default to the config's own values (``qdq`` / ``chunked`` for every
config, as in the reference), so with no flag the CLI trains what the
reference's CLI trains; ``--linear-impl pallas --attention-impl pallas``
runs the quantized matmuls and the attention forward on the CUDA
kernels.  ``--grad-compression fp8`` compresses the gradients (error
feedback).  ``--mesh d,m`` trains on a (data, model) mesh of ``d * m``
ranks, ``--mesh p,d,m`` on a (pod, data, model) mesh of ``p * d * m``
(the batch and the fsdp blocks over the data axes; attention heads,
kv_heads, mlp, vocab, experts and mamba's SSD heads over ``model``,
tensor-parallel), launched with ``torchrun``, NCCL on ``--device cuda``
and ``gloo`` on ``--device cpu``::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --mesh 2,1 --grad-compression fp8 --no-fsdp
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --mesh 2,1 --telemetry --linear-impl pallas
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2,2 --recipe paper_fp4
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --arch mamba2-780m --reduced --mesh 1,2 --seq 128

(with no ``torchrun`` a mesh of one rank runs in this process alone).
Without compression the data-parallel step is the one-device step of the
global batch: quant groups that span the batch share one amax across the
ranks, and ``--telemetry`` (the quant stats and gradient norms in every
step's row) reduces its stats over them; a rank's token count must then
be a multiple of 128 wherever a block group runs along the tokens
(``ValueError`` otherwise).  A model axis larger than 1 raises
``NotImplementedError`` for a model with cross attention (``vlm``,
``audio``) and under ``--grad-compression fp8``.  Rank 0 prints.

Prints the reference's lines (the per-step log, ``eval:``, ``step-time:``
p50 / p95 / p99, tokens/s and MFU) and one ``roofline[...]`` line from
``analysis.roofline``: the step's model flops (6 N D), their compute-term
lower bound on ``HW_H100`` and the MFU of the median step against it.
``main(argv)`` returns the trainer, the final state and those numbers,
for callers that run it in process.
"""
import argparse
import importlib
import math
from typing import Any, Dict, Optional, Sequence

from repro_torch.analysis.roofline import HW_H100, model_flops, \
    roofline_terms
from repro_torch.configs.base import ShapeCell, TrainConfig, get_config
from repro_torch.core.qlinear import LINEAR_IMPLS
from repro_torch.data import make_pipeline
from repro_torch.distributed.mesh import init_distributed
from repro_torch.models import build_model
from repro_torch.train.trainer import Trainer

__all__ = ["main", "parse_args", "model_config", "train_config",
           "MESH_AXES"]

# --mesh's axes by its length
MESH_AXES = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--recipe", default="paper_fp4")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--mesh", default="",
                    help="mesh shape, e.g. '4,1' or '2,2' (axes "
                         "data,model) or '2,2,1' (pod,data,model); one "
                         "rank a device, under torchrun; empty = "
                         "single-device step")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate embed params over the data axes "
                         "(required with --grad-compression fp8)")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect the quant stats and gradient norms "
                         "every step (the history rows' tel/... keys)")
    ap.add_argument("--telemetry-jsonl", default="",
                    help="JSONL metrics log (written off the critical "
                         "path by the async writer)")
    ap.add_argument("--cost-calibration", default="",
                    help="measured speed-factor JSON (speed_factors.v1; "
                         "empty = paper theory factors)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--linear-impl", default=None, choices=LINEAR_IMPLS,
                    help="the quantized matmuls' impl (default: the "
                         "config's, qdq)")
    ap.add_argument("--attention-impl", default=None,
                    choices=("chunked", "pallas"),
                    help="the attention forward's impl (default: the "
                         "config's, chunked)")
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The arch's config (``REDUCED`` with ``--reduced``) with the impl
    flags applied."""
    if args.reduced:
        cfg = importlib.import_module(
            "repro_torch.configs."
            + args.arch.replace("-", "_").replace(".", "_")).REDUCED
    else:
        cfg = get_config(args.arch)
    impls = {k: v for k, v in (("linear_impl", args.linear_impl),
                               ("attention_impl", args.attention_impl))
             if v is not None}
    return cfg.replace(**impls) if impls else cfg


def train_config(args: argparse.Namespace) -> TrainConfig:
    """The ``TrainConfig`` of the flags, field for field the reference
    CLI's."""
    mesh_shape = (tuple(int(d) for d in args.mesh.split(","))
                  if args.mesh else None)
    mesh_axes = (MESH_AXES[len(mesh_shape)] if mesh_shape else None)
    return TrainConfig(
        recipe=args.recipe, total_steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, learning_rate=args.lr,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes, fsdp=not args.no_fsdp,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt,
        telemetry=args.telemetry, telemetry_jsonl=args.telemetry_jsonl,
        cost_calibration=args.cost_calibration,
        log_every=max(args.steps // 20, 1))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    cfg = model_config(args)
    tcfg = train_config(args)
    made = tcfg.mesh_shape is not None and init_distributed(args.device)
    try:
        return _run(args, cfg, tcfg)
    finally:
        if made:     # the group this call made ends with it
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, cfg, tcfg) -> Dict[str, Any]:
    model = build_model(cfg, args.device)
    pipe = make_pipeline(args.data, cfg.vocab_size, args.seq, args.batch)
    trainer = Trainer(model, tcfg, pipe)
    say = print if trainer.rank == 0 else (lambda *a: None)
    # what train() starts from with no state, in both packages (so with
    # or without --resume): the newest checkpoint, else a fresh init,
    # drawn on the card
    state = trainer.resume() or trainer.init_state(
        on_device=model.device.type == "cuda")
    state = trainer.train(state, log=print)
    ev = trainer.evaluate(state)
    say("eval:", ev)
    summ = trainer.step_time_summary()
    terms = None
    if summ.get("steps"):
        say("step-time: "
            + " ".join(f"{k}={summ[k]:.1f}" for k in
                       ("p50_ms", "p95_ms", "p99_ms") if k in summ)
            + (f" tokens/s={summ['tokens_per_sec']:.0f}"
               if "tokens_per_sec" in summ else "")
            + (f" mfu={summ['mfu']:.4f}" if "mfu" in summ else ""))
        cell = ShapeCell("cli", args.seq, args.batch, "train")
        flops = model_flops(cfg, cell, model.active_param_count())
        chips = math.prod(tcfg.mesh_shape or (1,))
        terms = roofline_terms(hlo_flops=flops / chips, hlo_bytes=0.0,
                               collective_bytes_eff=0.0, chips=chips,
                               hw=HW_H100, model_flops_total=flops)
        terms["mfu"] = flops / (summ["p50_ms"] / 1e3 * HW_H100.peak_flops
                                * chips)
        say(f"roofline[{HW_H100.name}]: model_flops={flops:.4e} "
            f"compute_bound_ms={terms['compute_s'] * 1e3:.4g} "
            f"mfu={terms['mfu']:.4f}")
    return {"trainer": trainer, "state": state, "eval": ev,
            "step_time": summ, "roofline": terms}


if __name__ == "__main__":
    main()
