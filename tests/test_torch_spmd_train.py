"""Data-parallel training and fp8 gradient compression in the port's
``Trainer`` (``train.train_step`` on ``distributed``), held to the JAX
reference and to its own single-device step.

Bars:
  * bitwise: a world-of-one (1,) mesh against the rules-free ``Trainer``,
    with and without compression (the reference's
    ``test_mesh_1x1_bit_exact``); a resume with residuals; the 2-rank fp8
    reduction against ``compressed_reduce_dp`` of the stacked local
    gradients; an elastic resume's restored arrays;
  * allclose (f32, float summation order only): the fp8 ``Trainer``
    against the reference's at ``test_torch_train``'s bf16 bars, and a
    2-rank ``gloo`` run on a (2, 1) mesh against the reference's
    ``Trainer`` on 2 forced CPU devices at ``MESH_TOL``.

Spawned ranks meet through a ``FileStore`` under ``tmp_path``
(``torch_dist_workers``); torchrun runs ``--standalone`` (a free port).
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.analysis import qlint  # noqa: E402
from repro_torch.analysis.trace import collective_bytes  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.optim import compressed_reduce_dp  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_dist_workers import _tiny_trainer, run_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(state):
    comp = (tree_leaves(state.comp_state)
            if isinstance(state.comp_state, dict) else [state.comp_state])
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu) + comp)


@pytest.mark.parametrize("compression", ["none", "fp8"])
def test_mesh_1x1_bit_exact(compression, world_of_one):
    """A (1,) mesh (fsdp on: the embed leaves 'shard' over a data axis of
    1) runs the single-device step: params, moments, residuals and every
    row bit for bit."""
    over = dict(grad_compression=compression)
    t0 = _tiny_trainer(dict(over))
    s0 = t0.train(t0.init_state(), num_steps=2)
    t1 = _tiny_trainer(dict(over, mesh_shape=(1,), mesh_axes=("data",)))
    assert t1.rules is not None and t1.rules.dp_size == 1
    s1 = t1.train(t1.init_state(), num_steps=2)
    for a, b in zip(_leaves(s0), _leaves(s1)):
        assert torch.equal(a, b)
    assert [r["loss"] for r in t0.history] == [r["loss"] for r in t1.history]
    if compression == "fp8":
        assert set(s1.comp_state) == set(s1.params)


# the bf16 bars of test_torch_train (f32, no quantized matmul: summation
# order alone, carried through the fp8 codes)
FP8_TOL = dict(loss=1e-5, grad_norm=1e-5, params=1e-4)
# residuals: the share of elements more than 1e-6 apart.  An input an
# ulp apart can round to the neighbouring fp8 code, which moves that
# element's residual by one code step (this comparison read 1 of 4096 in
# one leaf; the others 0)
RES_FLIPS = 1e-3


def test_fp8_trainer_matches_reference():
    """``grad_compression="fp8"`` on ``tiny`` (f32, bf16 recipe, 4 steps of
    2 x 64) from the reference's init: per-step loss and grad norm, the
    final params and residuals against the reference's ``Trainer``."""
    over = dict(dtype="float32")
    jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **over)
    kw = dict(recipe="bf16", total_steps=4, global_batch=2, seq_len=64,
              grad_compression="fp8", log_every=0)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw),
                   JSynthetic(jcfg.vocab_size, 64, 2, seed=0))
    js = jtr.init_state()
    ttr = _tiny_trainer(dict(global_batch=2, seq_len=64,
                             grad_compression="fp8"), steps=4)
    ts = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, js.params), ttr.model.cfg))
    js, ts = jtr.train(js), ttr.train(ts)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in ttr.history],
                                   [r[key] for r in jtr.history],
                                   rtol=FP8_TOL[key], err_msg=key)
    for tree_t, tree_j, what in ((ts.params, js.params, "params"),
                                 (ts.comp_state, js.comp_state, "res")):
        want = params_from_jax(jax.tree.map(np.asarray, tree_j),
                               ttr.model.cfg)
        for a, b in zip(tree_leaves(tree_t), tree_leaves(want)):
            if what == "params":
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=FP8_TOL["params"])
            else:   # a code that flipped moves its residual a whole step
                off = np.abs(a.numpy() - b.numpy()) > 1e-6
                assert off.mean() <= RES_FLIPS, off.mean()


def test_resume_with_residuals_bit_for_bit(tmp_path):
    """An fp8 run checkpointed at step 2 and resumed in a fresh
    ``Trainer`` ends bit for bit the uninterrupted run: params, moments
    and residuals; the checkpoint holds ``comp_state/...`` in the
    reference's key layout."""
    full = _tiny_trainer(dict(grad_compression="fp8"),
                         str(tmp_path / "a"), steps=4)
    s_full = full.train(full.init_state())
    part = _tiny_trainer(dict(grad_compression="fp8"),
                         str(tmp_path / "b"), steps=4)
    part.train(part.init_state(), num_steps=2)
    again = _tiny_trainer(dict(grad_compression="fp8"),
                          str(tmp_path / "b"), steps=4)
    s_res = again.train()
    assert again.history[0]["step"] == 2
    for a, b in zip(_leaves(s_full), _leaves(s_res)):
        assert torch.equal(a, b)
    with open(tmp_path / "b" / "step_00000002" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert "comp_state/embed" in keys and "params/embed" in keys


# 2-rank (2, 1) mesh vs the reference's 2-device mesh, f32, bf16 recipe:
# the same math in another summation order (a rank's rows, then a mean
# across ranks; the reference sums its sharded batch in one reduction);
# under fp8 compression the codes' rounding can flip on an ulp, so its
# bar is the fp8 step's (a flipped code moves one element by 2^-3 of it).
MESH_TOL = {"none": dict(loss=1e-5, grad_norm=1e-4, params=1e-4),
            "fp8": dict(loss=1e-4, grad_norm=1e-3, params=1e-3)}

REF_MESH = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs.base import TrainConfig, get_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import build_model
    from repro.train.trainer import Trainer
    out_dir = sys.argv[1]
    cfg = get_config("tiny").replace(dtype="float32")
    model = build_model(cfg)
    cases = {"fsdp": dict(), "nofsdp": dict(fsdp=False),
             "fp8": dict(fsdp=False, grad_compression="fp8")}
    res = {}
    for name, over in cases.items():
        tr = Trainer(model, TrainConfig(recipe="bf16", total_steps=3,
                                        global_batch=4, seq_len=32,
                                        log_every=0, mesh_shape=(2, 1),
                                        **over),
                     SyntheticLM(cfg.vocab_size, 32, 4))
        st = tr.init_state()
        if name == "fsdp":
            np.savez(os.path.join(out_dir, "init.npz"), **{
                jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(st.params)[0]})
        st = tr.train(st)
        res[name] = {"loss": [r["loss"] for r in tr.history],
                     "grad_norm": [r["grad_norm"] for r in tr.history]}
        np.savez(os.path.join(out_dir, name + ".npz"), *[
            np.asarray(v) for v in jax.tree.leaves(st.params)])
    print(json.dumps(res))
""")


def _unflatten(npz, like):
    """The reference's params (a tree like ``like``) from ``keystr``
    keys."""
    flat = jax.tree_util.tree_flatten_with_path(like)[0]
    leaves = [npz[jax.tree_util.keystr(p)] for p, _ in flat]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), leaves)


def test_two_rank_mesh_matches_reference(tmp_path):
    """2 gloo ranks on a (2, 1) mesh, fsdp on and off, and fp8 compression
    with fsdp off, against the reference's ``Trainer`` on 2 forced CPU
    devices, from the same init: per-step loss and grad norm, final
    params; the fsdp run's blocks are half the embed leaves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", REF_MESH, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(
        dtype="float32")
    like = j_build(jcfg).abstract_params()
    init = _unflatten(np.load(tmp_path / "init.npz"), like)
    for name, over in (("fsdp", dict()), ("nofsdp", dict(fsdp=False)),
                       ("fp8", dict(fsdp=False, grad_compression="fp8"))):
        tol = MESH_TOL["fp8" if name == "fp8" else "none"]
        ranks = run_ranks("train_mesh", 2, tmp_path / name, over, 3, "",
                          init)
        got = ranks[0]
        for r in ranks[1:]:
            assert [{k: v for k, v in h.items() if k != "dt"}
                    for h in r["history"]] == \
                [{k: v for k, v in h.items() if k != "dt"}
                 for h in got["history"]]
            for a, b in zip(r["params"], got["params"]):
                np.testing.assert_array_equal(a, b)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                [h[key] for h in got["history"]], ref[name][key],
                rtol=tol[key], err_msg=f"{name} {key}")
        want = np.load(tmp_path / f"{name}.npz")
        want = [want[f"arr_{i}"] for i in range(len(want.files))]
        port_tree = params_from_jax(
            jax.tree.unflatten(jax.tree.structure(like), want),
            importlib.import_module("repro_torch.configs.tiny").CONFIG)
        for a, b in zip(got["params"], tree_leaves(port_tree)):
            np.testing.assert_allclose(a, b.numpy(), rtol=0,
                                       atol=tol["params"], err_msg=name)
        if name == "fsdp":
            assert got["local_shapes"][0][-1] * 2 == got["params"][0].shape[-1]


def test_two_rank_fp8_reduction_bitwise(tmp_path):
    """Each rank's reduced gradients and new residual equal
    ``compressed_reduce_dp`` over the two stacked local gradients and
    residuals, computed in one process."""
    ranks = run_ranks("reduced_vs_local", 2, tmp_path)
    n = len(ranks[0]["local"])
    g = {str(i): torch.from_numpy(np.stack([r["local"][i] for r in ranks]))
         for i in range(n)}
    res = {str(i): torch.from_numpy(np.stack([r["res"][i] for r in ranks]))
           for i in range(n)}
    red, new = compressed_reduce_dp(g, res)
    for rank, r in enumerate(ranks):
        for i in range(n):
            np.testing.assert_array_equal(r["reduced"][i],
                                          red[str(i)].numpy())
            np.testing.assert_array_equal(r["new"][i],
                                          new[str(i)][rank].numpy())


def test_elastic_resume_2x1_to_1(tmp_path, world_of_one):
    """A (2, 1) fsdp run checkpoints full arrays at step 2; a (1,) mesh of
    one rank and a (4, 1) mesh of four resume them: the restored state is
    the checkpoint's arrays bit for bit, and their step-2 rows and final
    params agree with the 2-rank run's (summation order)."""
    ck = str(tmp_path / "ck")
    two = run_ranks("train_mesh", 2, tmp_path / "two", {}, 3, ck)[0]
    one = _tiny_trainer(dict(mesh_shape=(1,), mesh_axes=("data",)), ck,
                        steps=3)
    state = one.resume()
    assert state.step == 2
    from repro_torch.checkpoint.manager import load_pytree
    saved = load_pytree(os.path.join(ck, "step_00000002"),
                        one._full_like(torch.device("meta")),
                        device="cpu")
    for a, b in zip(tree_leaves(state.params),
                    tree_leaves(saved["params"])):
        assert torch.equal(a, b)
    state = one.train(state)
    np.testing.assert_allclose(one.history[0]["loss"],
                               two["history"][2]["loss"], rtol=1e-5)
    for a, b in zip(tree_leaves(state.params), two["params"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    four = run_ranks("resume_mesh", 4, tmp_path / "four", ck, 3)
    for r in four:
        assert r["start"] == 2
        np.testing.assert_allclose(r["history"][0]["loss"],
                                   two["history"][2]["loss"], rtol=1e-5)
        for a, b in zip(r["params"], two["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_census_and_audit_comms(tmp_path):
    """The recorded collectives of a 2-rank step: fp8 gradients travel as
    1-byte codes (audit clean), the amax reductions are f32 scale words;
    an uncompressed fsdp step moves f32 gradients (flagged when fp8 was
    expected), all-gathers its blocks, reduce-scatters their gradients
    and all-reduces their squared sums (every leaf of ``tiny`` has an
    embed dim: all are blocks).  qlint's ``--mesh 2,1`` audit of the ranks is clean."""
    fp8 = run_ranks("train_mesh", 2, tmp_path / "fp8",
                    dict(fsdp=False, grad_compression="fp8"), 1)[0]
    census, findings = qlint.audit_comms(fp8["census"], expect_fp8=True)
    assert findings == []
    assert census["grad_payload_dtypes"] == {"uint8": len(
        fp8["params"])}
    assert census["scale_allreduce_dtypes"] == {"float32": len(
        fp8["params"])}
    total = sum(p.size for p in fp8["params"])
    assert census["grad_payload_bytes"] == total
    b = collective_bytes(fp8["census"])
    assert b["raw_all-gather_uint8"] == total
    fs = run_ranks("train_mesh", 2, tmp_path / "fsdp", {}, 1)[0]
    census, findings = qlint.audit_comms(fs["census"], expect_fp8=True)
    assert findings and all(f.severity == "violation" for f in findings)
    ops = {(r.op, r.tag) for r in fs["census"]}
    assert {("all-gather", "param"), ("reduce-scatter", "grad"),
            ("all-reduce", "norm")} <= ops
    reports = run_ranks("qlint_mesh", 2, tmp_path / "qlint")[0]
    assert [r["label"] for r in reports] == ["train_unroll", "train_scan",
                                             "train_mesh2x1"]
    assert all(not [f for f in r["findings"]
                    if f["severity"] == "violation"] for r in reports)
    assert reports[-1]["summary"]["comms"]["grad_payload_dtypes"] == {
        "uint8": len(fp8["params"])}


def test_train_cli_under_torchrun():
    """``launch/train.py --grad-compression fp8 --mesh 2,1 --no-fsdp`` on 2
    CPU ranks under torchrun: exit 0, rank 0 prints the step lines and
    ``eval:`` once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--mesh", "2,1", "--grad-compression", "fp8",
         "--no-fsdp", "--steps", "2", "--batch", "4", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("eval:") for ln in lines) == 1
    assert sum(ln.startswith("step ") for ln in lines) == 2
