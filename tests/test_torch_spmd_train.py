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
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.analysis import qlint  # noqa: E402
from repro_torch.analysis.trace import collective_bytes  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.quantize import QuantSpec  # noqa: E402
from repro_torch.core.recipe import (MM_FFN_PAPER, MM_FP8,  # noqa: E402
                                     RECIPES)
from repro_torch.optim import compressed_reduce_dp  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_dist_workers import (_tiny_trainer, run_ranks,  # noqa: E402
                                start_ranks)
from torch_dist_workers import torch_threads as torch_threads  # noqa

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

# The data axis made whole (the uncompressed step is the one-device
# function of the global batch): paper_fp4 at 4 x 128 (a rank holds 256
# tokens, so the FFN's 128-token block groups end on rank boundaries),
# two steps, fsdp on (over "qdq", with telemetry) and off (over "pallas":
# the kernels' plain versions).  The shared amax makes each rank quantize
# the global batch's groups, so the runs differ from the reference's by
# f32 summation order and the FP4 / FP8 roundings it flips (the port's
# single-device paper_fp4 gap, test_torch_train's TRAIN_TOL); bars ten
# times MESH_TOL["none"] (read: loss 4.8e-6, grad norm 1.3e-4, params
# 2.7e-4).  The learning rate is 1e-4: AdamW's first updates are +-lr
# wherever a gradient is not near zero, so an element that a flip moves
# across zero moves by 2 lr, 1.2e-3 at the default 6e-4 (read after one
# step on 12 of 8192 elements), past the params bar.  The split itself is
# held tight against the port's one process (ONE_TOL).  Telemetry ("qdq"
# on both sides: the reference's forward stats there are sampled, as the
# port's), step 0: taps and the forward-side counts (clip, underflow)
# bitwise, the backward-side rates within 5e-4 (test_torch_telemetry's
# bar), the rest within TEL_RTOL of the reference and 1e-5 of the port's
# one process.  adafactor with fsdp and the (2, 2, 1) mesh with the embed
# leaves over "data" alone: bf16, MESH_TOL["none"] (adafactor read: loss
# 8.1e-8, params 3.0e-8).
FP4 = dict(recipe="paper_fp4", global_batch=4, seq_len=128,
           learning_rate=1e-4)
FP4_TOL = {k: 10 * v for k, v in MESH_TOL["none"].items()}
# the 2 ranks against the port's one process on the whole batch: the
# ranks' partial sums are the only difference (read: loss 8e-8, params 0;
# a rank's local amax instead of the shared one reads 1.1e-3 on the
# step-1 loss and 2.2e-3 on the params)
ONE_TOL = 1e-6
# the float stats against the reference (step 0): its activations and
# cotangents differ from the port's in f32 summation order, which moves an
# element across an FP4 / FP8 rounding edge now and then (read: dgrad_g
# rel_err 6.1e-4, layer 1's FFN wgrad_x rel_err 1.1e-4, gnorm 5.8e-5,
# relative; the reference's own 1- and 2-device rows agree to 1e-5)
TEL_RTOL = 2e-3
NEW_CASES = {
    "fp4_fsdp": (dict(), dict(FP4, telemetry=True), 2),
    "fp4_nofsdp": (dict(linear_impl="pallas"), dict(FP4, fsdp=False), 2),
    "adafactor": (dict(optimizer="adafactor"), dict(), 2),
}
# Tensor parallelism (the model axis): tiny on (1, 2) under paper_fp4 (the
# kernels' plain versions: the FFN's block and tile groups span the two
# ranks' 64 of d_ff; two steps) and fp8 (token groups along the split
# heads), and on (2, 2) under paper_fp4 (one step each: the test time),
# against the reference's Trainer on the same
# meshes at FP4_TOL, and against the port's one process on the step-0
# loss (the same parameters) at TP_ONE_TOL: unlike a data split, a model
# split changes the order of float summation in the forward (a
# row-parallel output is the sum of the ranks' partial products), and a
# last-bit difference moves a downstream FP4 / FP8 element by a whole
# grid step (read: 4.8e-6 relative on tp_fp4's step-0 loss, 0 on tp_fp8's).
# Later steps also carry AdamW's +-lr moves of the gradient elements such
# a flip takes across zero (tp_fp8's step-1 loss read 1.7e-4 off one
# process, within FP4_TOL of the reference): they are held to the
# reference alone.
TP_ONE_TOL = 2e-5
TP_CASES = {
    "tp_fp4": (dict(linear_impl="pallas"), dict(FP4, mesh_shape=(1, 2)),
               2),
    "tp_fp8": (dict(), dict(FP4, recipe="fp8", mesh_shape=(1, 2)), 1),
    "tp_fp4_2x2": (dict(linear_impl="pallas"),
                   dict(FP4, mesh_shape=(2, 2)), 1),
}

# a (2, 2, 1) (pod, data, model) mesh with the embed leaves over "data"
PARTIAL_CASE = {"partial": (dict(), dict(
    mesh_shape=(2, 2, 1), mesh_axes=("pod", "data", "model"),
    embed_axes=("data",)), 3)}

REF_MESH = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs.base import TrainConfig, get_config
    from repro.data.pipeline import SyntheticLM
    from repro.distributed.mesh import make_mesh
    from repro.distributed.sharding import default_rules
    from repro.models import build_model
    from repro.train.trainer import Trainer
    out_dir = sys.argv[1]
    new_cases = json.loads(sys.argv[2])
    cfg = get_config("tiny").replace(dtype="float32")
    cases = {"fsdp": ({}, dict(), 3), "nofsdp": ({}, dict(fsdp=False), 3),
             "fp8": ({}, dict(fsdp=False, grad_compression="fp8"), 3),
             **new_cases, "partial": ({}, dict(), 3)}
    res = {}
    for name, (model_over, over, steps) in cases.items():
        # the port's impl choice changes no reference number
        model_over = {k: v for k, v in model_over.items()
                      if k != "linear_impl"}
        model = build_model(cfg.replace(**model_over))
        kw = dict(recipe="bf16", total_steps=steps, global_batch=4,
                  seq_len=32, log_every=0, mesh_shape=(2, 1))
        kw.update(over)
        rules = None
        if name == "partial":
            kw.pop("mesh_shape")
            rules = default_rules(
                make_mesh((2, 2, 1), ("pod", "data", "model")), cfg,
                overrides={"embed": ("data",)})
        tr = Trainer(model, TrainConfig(**kw),
                     SyntheticLM(cfg.vocab_size, kw["seq_len"],
                                 kw["global_batch"]), rules=rules)
        st = tr.init_state()
        if name == "fsdp":
            np.savez(os.path.join(out_dir, "init.npz"), **{
                jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(st.params)[0]})
        st = tr.train(st)
        res[name] = {"loss": [r["loss"] for r in tr.history],
                     "grad_norm": [r["grad_norm"] for r in tr.history]}
        if over.get("telemetry"):
            res[name]["rows"] = [{k: float(v) for k, v in r.items()
                                  if k.startswith("tel/")}
                                 for r in tr.history]
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


@pytest.fixture(scope="module")
def ref_start(tmp_path_factory):
    """The reference's runs started (one subprocess, 4 forced CPU
    devices) and, meanwhile, the init they all start from, drawn here as
    its ``Trainer`` draws it: (the process, its output directory, the
    init, the params' abstract tree)."""
    out_dir = tmp_path_factory.mktemp("ref_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REF_MESH, str(out_dir),
                             json.dumps({**NEW_CASES, **TP_CASES})],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(
            dtype="float32")
        model = j_build(jcfg)
        init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                   jnp.float32))
        yield proc, out_dir, init, model.abstract_params()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref_mesh(ref_start):
    """The reference's runs: its rows by case, its final params'
    directory, the shared init (the subprocess's own, checked equal to
    the one the ranks started from) and the params' abstract tree."""
    proc, out_dir, init, like = ref_start
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    saved = _unflatten(np.load(out_dir / "init.npz"), like)
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(init)):
        np.testing.assert_array_equal(a, b)
    return ref, out_dir, init, like


def _check_run(ranks, ref, out_dir, like, name, tol):
    """Every rank's rows and params equal; rank 0's per-step loss and
    grad norm and its final params against the reference's case
    ``name``."""
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
    want = np.load(out_dir / f"{name}.npz")
    want = [want[f"arr_{i}"] for i in range(len(want.files))]
    port_tree = params_from_jax(
        jax.tree.unflatten(jax.tree.structure(like), want),
        importlib.import_module("repro_torch.configs.tiny").CONFIG)
    for a, b in zip(got["params"], tree_leaves(port_tree)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0,
                                   atol=tol["params"], err_msg=name)
    return got


# the first data-parallel cases: bf16 on (2, 1), 3 steps each
MESH_CASES = {"fsdp": (dict(), dict(), 3),
              "nofsdp": (dict(), dict(fsdp=False), 3),
              "fp8": (dict(), dict(fsdp=False, grad_compression="fp8"), 3)}


def test_two_rank_mesh_matches_reference(new_ranks, ref_mesh):
    """2 gloo ranks on a (2, 1) mesh, fsdp on and off, and fp8 compression
    with fsdp off, against the reference's ``Trainer`` on 2 forced CPU
    devices, from the same init: per-step loss and grad norm, final
    params; the fsdp run's blocks are half the embed leaves."""
    ref, out_dir, init, like = ref_mesh
    for name in MESH_CASES:
        tol = MESH_TOL["fp8" if name == "fp8" else "none"]
        ranks = [r[name] for r in new_ranks]
        got = _check_run(ranks, ref, out_dir, like, name, tol)
        if name == "fsdp":
            assert got["local_shapes"][0][-1] * 2 == got["params"][0].shape[-1]


# port-only: the kernels' stats vectors (linear_impl "pallas", flash) on
# 2 ranks against one process (the same code on the whole batch)
PORT_CASES = {"telemetry_pallas": (
    dict(linear_impl="pallas", attention_impl="pallas"),
    dict(FP4, telemetry=True), 1)}


def _port_over(model_over, over):
    return dict(over, model=model_over)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory, ref_start):
    """Every case of the 2-rank meshes in one process group and the
    4-rank ones (the (2, 2) model axis, the partial data axes) in another,
    both groups running while the reference runs."""
    init = ref_start[2]
    cases = {**MESH_CASES, **NEW_CASES, **PORT_CASES, **TP_CASES}
    two = [(name, _port_over(*case[:2]), case[2])
           for name, case in cases.items()
           if math.prod(case[1].get("mesh_shape", (2,))) == 2]
    four = [(name, _port_over(*case[:2]), case[2])
            for name, case in {**TP_CASES, **PARTIAL_CASE}.items()
            if math.prod(case[1].get("mesh_shape", (2,))) == 4]
    tmp = tmp_path_factory.mktemp("new")
    two = start_ranks("train_cases", 2, tmp / "two", two, init)
    four = start_ranks("train_cases", 4, tmp / "four", four, init)
    return {"two": two(), "four": four()}


@pytest.fixture(scope="module")
def new_ranks(rank_runs):
    """The 2-rank cases' results, rank by rank."""
    return rank_runs["two"]


@pytest.mark.parametrize("name", ["fp4_fsdp", "fp4_nofsdp"])
def test_two_rank_paper_fp4_matches_reference(name, ref_mesh, new_ranks):
    """paper_fp4 on 2 ranks (fsdp on over "qdq" with telemetry, off over
    "pallas") against the reference's 2-device ``Trainer``: quant groups
    that span
    the batch share one amax, so each rank quantizes the global batch's
    groups, within ten times the bf16 bars."""
    ref, out_dir, init, like = ref_mesh
    got = _check_run([r[name] for r in new_ranks], ref, out_dir, like,
                     name, FP4_TOL)
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    # the last step's collectives: the shared amax words, audit clean
    census, findings = qlint.audit_comms(got["census"], expect_fp8=False)
    assert findings == []
    assert census["amax_allreduces"] > 0 and census["amax_words"] > 0
    # the same step in one process of the port on the whole batch
    model_over, over, steps = NEW_CASES[name]
    one = _tiny_trainer(_port_over(model_over, over), steps=steps)
    state = one.train(one.init_state(params=params_from_jax(
        init, one.model.cfg)))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   [h[key] for h in one.history],
                                   rtol=ONE_TOL, err_msg=key)
    for a, b in zip(got["params"], tree_leaves(state.params)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=ONE_TOL)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tensor_parallel_matches_reference(name, rank_runs, ref_mesh):
    """tiny on a model axis of 2 ((1, 2) over 2 gloo ranks, (2, 2) over
    4): heads, kv_heads, mlp and the vocab (gathered for the embedding and
    the head) split over the model group, quant groups meeting the split
    sharing their amax; against the reference's ``Trainer`` on the same
    mesh at FP4_TOL, and the port's one process on the step-0 loss at
    TP_ONE_TOL;
    the step's collectives audit clean, the row-parallel sums and the
    model group's amax words counted apart."""
    ref, out_dir, init, like = ref_mesh
    model_over, over, steps = TP_CASES[name]
    world = math.prod(over["mesh_shape"])
    ranks = [r[name] for r in rank_runs["two" if world == 2 else "four"]]
    got = _check_run(ranks, ref, out_dir, like, name, FP4_TOL)
    assert got["local_shapes"][0][0] * 2 == got["params"][0].shape[0]
    census, findings = qlint.audit_comms(got["census"], expect_fp8=False)
    assert findings == []
    assert census["tp_sums"] > 0 and census["amax_model_ops"] > 0
    one_over = {k: v for k, v in over.items() if k != "mesh_shape"}
    one = _tiny_trainer(_port_over(model_over, one_over), steps=steps)
    one.train(one.init_state(params=params_from_jax(init, one.model.cfg)))
    np.testing.assert_allclose(got["history"][0]["loss"],
                               one.history[0]["loss"], rtol=TP_ONE_TOL)


def _assert_tel_rows(got_rows, ref_rows, what, float_rtol=1e-5):
    """Each row's ``tel/...`` stats: the taps and the forward-side counts
    (clip, underflow) equal, the backward-side rates within 5e-4, every
    other stat within ``float_rtol``; every miss is reported."""
    misses = []
    for got, ref in zip(got_rows, ref_rows):
        got = {k: v for k, v in got.items() if k.startswith("tel/")}
        assert set(got) == set(ref), (what, set(got) ^ set(ref))
        for key, want in ref.items():
            stat = key.rsplit("/", 1)[1]
            have = float(got[key])
            if stat == "taps" or (stat in ("clip", "underflow")
                                  and not key.startswith("tel/bwd/")):
                ok = have == want
            elif stat in ("clip", "underflow"):
                ok = abs(have - want) <= 5e-4
            else:
                ok = abs(have - want) <= float_rtol * abs(want) + 1e-12
            if not ok:
                misses.append((key, have, want))
    assert not misses, (what, len(misses), misses[:12])


def test_two_rank_telemetry_matches_reference(ref_mesh, new_ranks):
    """Telemetry on (2, 1) without compression: every rank's stats rows
    equal; step 0's taps and forward-side counts bitwise the reference's
    2-device ``Trainer``'s, the rest within the stated bars; and the
    kernels' stats vectors (summed, min'd, max'd over the ranks) against
    one process of the port on the whole batch."""
    ref, out_dir, _, like = ref_mesh
    got = _check_run([r["fp4_fsdp"] for r in new_ranks], ref, out_dir,
                     like, "fp4_fsdp", FP4_TOL)
    # step 0 (the same parameters): later rows follow the runs' flips
    _assert_tel_rows(got["history"][:1], ref["fp4_fsdp"]["rows"][:1],
                     "reference", float_rtol=TEL_RTOL)
    for name, rows in (("fp4_fsdp", got["history"]), ("telemetry_pallas",
                       new_ranks[0]["telemetry_pallas"]["history"])):
        model_over, over, steps = {**NEW_CASES, **PORT_CASES}[name]
        one = _tiny_trainer(_port_over(model_over, over), steps=steps)
        one.train(one.init_state(params=params_from_jax(
            ref_mesh[2], one.model.cfg)))
        _assert_tel_rows(rows, [{k: float(v) for k, v in h.items()
                                 if k.startswith("tel/")}
                                for h in one.history], f"one process {name}")
    assert any("/fwd_x/" in k for k in rows[0])


def test_two_rank_adafactor_fsdp_matches_reference(ref_mesh, new_ranks):
    """adafactor with fsdp on (2, 1): the factored moments reduce over the
    sharded embed dim; against the reference's 2-device ``Trainer``, and
    the gathered factors have the full leaves' shapes."""
    ref, out_dir, _, like = ref_mesh
    got = _check_run([r["adafactor"] for r in new_ranks], ref, out_dir,
                     like, "adafactor", MESH_TOL["none"])
    assert got["local_shapes"][0][-1] * 2 == got["params"][0].shape[-1]
    assert got["mu"] and len(got["mu"]) == 2 * len(got["params"])


def test_partial_data_axes_matches_reference(rank_runs, ref_mesh):
    """A (2, 2, 1) (pod, data, model) mesh of 4 gloo ranks whose embed
    leaves shard over "data" alone (a ``default_rules`` override): blocks
    gathered and reduce-scattered over the data sub-group, all-reduced
    over pod; against the reference on 4 forced CPU devices."""
    ref, out_dir, init, like = ref_mesh
    ranks = [r["partial"] for r in rank_runs["four"]]
    got = _check_run(ranks, ref, out_dir, like, "partial",
                     MESH_TOL["none"])
    assert got["local_shapes"][0][-1] * 2 == got["params"][0].shape[-1]
    ops = {(r.op, r.tag, r.group_size) for r in got["census"]}
    assert {("all-gather", "param", 2), ("reduce-scatter", "grad", 2),
            ("all-reduce", "grad", 2)} <= ops


# one MM_FP8 linear's wgrad operands, its tensor-scaled variant, and
# fine_grained_fp4's SR wgrad (the kernels' plain versions, SR keyed by
# the global rows), 512 tokens on 2 ranks; a block group straddling the
# rank boundary (2 x 96 tokens) under paper_fp4's FFN wgrad
TENSOR_WGRAD = dataclasses.replace(
    MM_FP8, wgrad_x=QuantSpec("fp8_e4m3", "tensor"),
    wgrad_g=QuantSpec("fp8_e5m2", "tensor"))
OPERAND_CASES = [
    ("token_qdq", "qdq", MM_FP8, 512),
    ("token_pallas", "pallas", MM_FP8, 512),
    ("tensor_qdq", "qdq", TENSOR_WGRAD, 512),
    ("tensor_pallas", "pallas", TENSOR_WGRAD, 512),
    ("sr_block_pallas", "pallas", RECIPES["fine_grained_fp4"].ffn_linear,
     512),
    ("straddle_qdq", "qdq", MM_FFN_PAPER, 192),
    ("straddle_pallas", "pallas", MM_FFN_PAPER, 192)]


@pytest.fixture(scope="module")
def operand_ranks(tmp_path_factory):
    return run_ranks("wgrad_operands", 2, tmp_path_factory.mktemp("ops"),
                     OPERAND_CASES, "fp8")


@pytest.mark.parametrize("name", [c[0] for c in OPERAND_CASES
                                  if not c[0].startswith("straddle")])
def test_wgrad_operands_bitwise(name, operand_ranks):
    """On 2 ranks each holding 256 of 512 tokens, a linear's wgrad
    operands Q(x^T) and Q(g) (token, tensor, SR block groups) equal the
    same rows of one process's bit for bit, and the ranks' dw sum to its
    dw; the control (the rank's local amax, SR keyed from 0) misses on
    some rank."""
    missed = False
    for r in operand_ranks:
        case = r[name]
        for got, want in zip(case["split"][:2], case["whole"][:2]):
            np.testing.assert_array_equal(got, want)
        missed |= any(not np.array_equal(a, b) for a, b in
                      zip(case["local"][:2], case["whole"][:2]))
    assert missed
    np.testing.assert_allclose(
        sum(r[name]["split"][2] for r in operand_ranks),
        operand_ranks[0][name]["whole"][2], rtol=1e-5, atol=1e-4)


def test_moe_load_balance_under_a_split(operand_ranks):
    """olmoe-1b-7b ``REDUCED`` under fp8 (token groups: the experts'
    wgrads share their amax) on 2 ranks of two router groups each: the
    ranks' mean loss, load-balancing and z-losses, drop fraction and
    their gradients' sum (each weighted by the rank's half of the
    targets) are one process's on the whole batch.  The load-balancing
    loss multiplies two means over every token: its expert-count
    fractions are all-reduced over the group."""
    split = [r["moe"]["split"] for r in operand_ranks]
    whole = operand_ranks[0]["moe"]["whole"]
    np.testing.assert_allclose(np.mean([s_["loss"] for s_ in split]),
                               whole["loss"], rtol=1e-6)
    for key in ("moe_load_balance", "moe_router_z", "moe_frac_dropped"):
        np.testing.assert_allclose(
            np.mean([s_["metrics"][key] for s_ in split]),
            whole["metrics"][key], rtol=1e-6, err_msg=key)
    for i, want in enumerate(whole["grads"]):
        got = 0.5 * (split[0]["grads"][i] + split[1]["grads"][i])
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"grad {i}")


@pytest.mark.parametrize("name", ["straddle_qdq", "straddle_pallas"])
def test_straddling_block_group_raises(name, operand_ranks):
    """A 128-token block group along the tokens that straddles the rank
    boundary (96 tokens a rank) raises ``ValueError`` naming the rows."""
    for r in operand_ranks:
        assert "error" in r[name]
        assert "96 token rows" in r[name]["error"]


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


def test_census_and_audit_comms(tmp_path, new_ranks):
    """The recorded collectives of a 2-rank step (the last step of the
    (2, 1) runs): fp8 gradients travel as 1-byte codes (audit clean), the
    amax reductions are f32 scale words; an uncompressed fsdp step moves
    f32 gradients (flagged when fp8 was expected), all-gathers its
    blocks, reduce-scatters their gradients and all-reduces their squared
    sums (every leaf of ``tiny`` has an embed dim: all are blocks).
    qlint's ``--mesh 2,1`` audit of the ranks is clean."""
    fp8 = new_ranks[0]["fp8"]
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
    fs = new_ranks[0]["fsdp"]
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
