"""The JAX reference's ``Trainer`` on a (1, 2) mesh of forced CPU devices
against its own one-device run, per ``REDUCED`` config: per-step loss and
grad norm of each and their relative differences.

The port's mesh tests hold the port to the reference's 2-device run; this
shows where that run itself departs from the reference's one-device run
(jamba's hybrid stack), so that a test holds the port to the 1-device run
there instead.

    PYTHONPATH=src python tools/ref_mesh_spread.py mamba2_780m \\
        jamba_1_5_large_398b

paper_fp4, f32, 2 steps of 4 x 128 tokens at lr 1e-4 (the settings of
``tests/test_torch_ssm_parallel.py``); one JSON line a config.  Runs on
the CPU (a few minutes for jamba).
"""
import importlib
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"


def main(argv):
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models import build_model
    from repro.train.trainer import Trainer
    for arch in argv:
        cfg = importlib.import_module("repro.configs." + arch).REDUCED
        cfg = cfg.replace(dtype="float32")
        rows = {}
        for name, mesh in (("two_devices", (1, 2)), ("one_device", None)):
            kw = dict(recipe="paper_fp4", global_batch=4, seq_len=128,
                      learning_rate=1e-4, total_steps=2, log_every=0)
            if mesh:
                kw["mesh_shape"] = mesh
            tr = Trainer(build_model(cfg), TrainConfig(**kw),
                         SyntheticLM(cfg.vocab_size, 128, 4))
            tr.train(tr.init_state())
            rows[name] = {k: [float(r[k]) for r in tr.history]
                          for k in ("loss", "grad_norm")}
        rel = {k: [abs(a - b) / abs(b) for a, b in
                   zip(rows["two_devices"][k], rows["one_device"][k])]
               for k in ("loss", "grad_norm")}
        print(json.dumps({"arch": arch, **rows, "rel": rel}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
