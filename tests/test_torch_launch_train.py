"""The port's training CLI (``launch/train.py``) against the reference's:
one argv gives a ``TrainConfig`` (and a model config) equal field for
field to the reference CLI's, which is driven with ``sys.argv`` patched
and stopped where its ``Trainer`` would start; a 3-step ``--device cpu``
run prints the reference's line formats plus the roofline line; the
impl flags default to the config's own values, so with no flag neither
the training CLI nor the serving CLI runs a ported kernel (no kernel
call in a marking routing capture), and the serving CLI's default
tokens are those of the batcher it built before the flag; unported
flags raise.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.launch.train as j_cli  # noqa: E402
from repro_torch.analysis.roofline import HW_H100, model_flops  # noqa: E402
from repro_torch.configs.base import ShapeCell, get_config  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.core.recipe import RECIPES  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.serving_runtime import (  # noqa: E402
    ContinuousBatcher, quantize_weights_for_serving)
from torch_dist_workers import torch_threads as torch_threads  # noqa

ARGVS = [
    [],
    ["--arch", "llama-1b", "--recipe", "fine_grained_fp4", "--steps",
     "1000", "--batch", "16", "--seq", "256", "--lr", "3e-4",
     "--microbatch", "2", "--ckpt", "/tmp/ck", "--ckpt-every", "50",
     "--telemetry-jsonl", "t.jsonl", "--cost-calibration", "c.json",
     "--no-fsdp", "--resume"],
    ["--arch", "olmoe-1b-7b", "--reduced", "--data", "bytes", "--steps",
     "7"],
    ["--arch", "llama3.2-3b", "--mesh", "2,1", "--grad-compression", "fp8",
     "--steps", "3"],
]


class _Stop(Exception):
    pass


def _reference(argv, monkeypatch):
    """The reference CLI's (model config, TrainConfig) for ``argv``."""
    got = {}

    def trainer(model, tcfg, pipe):
        got["cfg"], got["tcfg"] = model.cfg, tcfg
        raise _Stop
    monkeypatch.setattr(j_cli, "Trainer", trainer)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(_Stop):
        j_cli.main()
    return got["cfg"], got["tcfg"]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "flags", "reduced",
                                             "mesh"])
def test_train_config_matches_reference_cli(argv, monkeypatch):
    jcfg, jtcfg = _reference(argv, monkeypatch)
    args = cli.parse_args(argv + ["--device", "cpu"])
    assert dataclasses.asdict(cli.train_config(args)) == \
        dataclasses.asdict(jtcfg)
    assert dataclasses.asdict(cli.model_config(args)) == \
        dataclasses.asdict(jcfg)


def test_impl_flags_default_to_the_config():
    cfg = cli.model_config(cli.parse_args(["--arch", "llama3.2-3b"]))
    assert cfg == get_config("llama3.2-3b")
    assert (cfg.linear_impl, cfg.attention_impl) == ("qdq", "chunked")
    cfg = cli.model_config(cli.parse_args(
        ["--arch", "llama3.2-3b", "--linear-impl", "pallas",
         "--attention-impl", "pallas"]))
    assert cfg == get_config("llama3.2-3b").replace(
        linear_impl="pallas", attention_impl="pallas")


def test_unported_flags_raise():
    """The flags the port once refused now train: ``--grad-compression
    fp8`` carries residuals, ``--mesh 1,1`` runs a mesh of this process
    alone (its group ends with ``main``); a mesh larger than the world
    raises ``ValueError`` (a model axis > 1: test_torch_train; the
    2-rank CLI under torchrun: test_torch_spmd_train)."""
    import torch.distributed as dist
    base = ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
            "32"]
    out = cli.main(base + ["--grad-compression", "fp8"])
    assert set(out["state"].comp_state) == set(out["state"].params)
    out = cli.main(base + ["--mesh", "1,1", "--grad-compression", "fp8",
                           "--no-fsdp"])
    assert out["trainer"].rules.dp_size == 1 and not dist.is_initialized()
    for mesh in ("2,1", "1,2"):
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            cli.main(base + ["--mesh", mesh])
    assert not dist.is_initialized()


def test_telemetry_and_three_axis_mesh_flags():
    """``--telemetry`` turns the stats on; a three-entry ``--mesh`` names
    its axes (pod, data, model), and ``--mesh 1,1,1`` runs a mesh of this
    process alone with both data axes in its rules (the 2- and 4-rank
    data-axis cases: test_torch_spmd_train)."""
    import torch.distributed as dist
    tcfg = cli.train_config(cli.parse_args(["--mesh", "2,2,1",
                                            "--telemetry"]))
    assert tcfg.mesh_axes == ("pod", "data", "model") and tcfg.telemetry
    out = cli.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                    "--seq", "32", "--mesh", "1,1,1", "--telemetry"])
    assert out["trainer"].rules.dp_axes == ("pod", "data")
    assert any(k.startswith("tel/") for k in out["trainer"].history[-1])
    assert not dist.is_initialized()


# The reference CLI's line formats (src/repro/launch/train.py and its
# Trainer's log), and the port's roofline line.
STEP = re.compile(r"^step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} "
                  r"lr \d\.\d{2}e[+-]\d{2} \[\w+\] \d+ms$")
EVAL = re.compile(r"^eval: \{'val_loss': [0-9.e+-]+, 'val_ppl': "
                  r"[0-9.e+-]+\}$")
STEP_TIME = re.compile(r"^step-time: p50_ms=\d+\.\d p95_ms=\d+\.\d "
                       r"p99_ms=\d+\.\d tokens/s=\d+ mfu=\d\.\d{4}$")
ROOFLINE = re.compile(r"^roofline\[nvidia_h100_sxm\]: model_flops=(\S+) "
                      r"compute_bound_ms=(\S+) mfu=\d\.\d{4}$")


def test_three_steps_on_cpu_print_the_reference_lines(capsys):
    argv = ["--device", "cpu", "--steps", "3", "--batch", "1", "--seq",
            "32"]
    with routing.capture(markers=True) as log:
        res = cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6
    assert all(STEP.match(line) for line in lines[:3]), lines
    assert EVAL.match(lines[3]) and STEP_TIME.match(lines[4]), lines
    m = ROOFLINE.match(lines[5])
    assert m, lines
    model = res["trainer"].model
    flops = model_flops(model.cfg, ShapeCell("cli", 32, 1, "train"),
                        model.active_param_count())
    assert float(m.group(1)) == float(f"{flops:.4e}")
    assert res["roofline"]["compute_s"] == flops / HW_H100.peak_flops
    assert len(res["trainer"].history) == 3
    # the defaults (qdq, chunked): no ported kernel ran
    assert log.kernel_calls == [] and log.qdq_calls


def test_pallas_flags_run_the_kernels(capsys):
    argv = ["--device", "cpu", "--steps", "1", "--batch", "1", "--seq",
            "128", "--linear-impl", "pallas", "--attention-impl", "pallas"]
    with routing.capture(markers=True) as log:
        cli.main(argv)
    names = {c.name for c in log.kernel_calls}
    assert names == {"qmm_stream", "quantize_rows", "tiled_mm",
                     "flash_attention"}
    assert "eval:" in capsys.readouterr().out


def test_serve_cli_default_tokens_unchanged(capsys):
    """The serving CLI's default run: the tokens of a batcher built by
    hand from the config as it is and RECIPES["bf16"], and no ported
    kernel ran (the bf16 recipe leaves every activation unquantized)."""
    argv = ["--arch", "tiny", "--device", "cpu", "--requests", "2",
            "--slots", "2", "--max-new", "3", "--weight-quant", "fp4_e2m1"]
    with routing.capture(markers=True) as log:
        out = serve_cli.main(argv)
    assert log.kernel_calls == []
    cfg = get_config("tiny")
    model = build_model(cfg, "cpu")
    params = quantize_weights_for_serving(model, model.init(seed=0),
                                          "fp4_e2m1", device="cpu")
    batcher = ContinuousBatcher(model, params, n_slots=2, max_len=256,
                                recipe=RECIPES["bf16"], device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        n = int(rng.integers(4, 24))
        batcher.submit(rng.integers(0, cfg.vocab_size, size=n).astype(
            np.int32), 3)
    assert batcher.run() == out
    capsys.readouterr()
