"""Mamba on the ``model`` axis in the port (a rank holds whole SSD
heads), held to the JAX reference and to the port's own single process.

The layout is the reference's default rules: ``mamba_inner`` /
``mamba_heads`` split in whole heads where the head count divides the
axis, ``mamba_groups`` where the group count does (mamba2-780m's one
group stays whole; jamba ``REDUCED``'s two split one a rank).

Bars:
  * bitwise: which mamba leaves split, and the blocks' shapes, against
    the reference's ``default_rules`` specs on (1, 2), (1, 3) and (1, 4)
    meshes of mamba2-780m and jamba (full and ``REDUCED``); on 2 gloo
    ranks, the mixer sublayer's norm input (the pre-norm ``y`` times the
    gate: per-head SSD math on the rank's heads) as one process's
    columns, and every whole leaf's gradient equal on both ranks;
  * allclose: the sublayer's output, its input's cotangent and every
    leaf's gradient (a split leaf's as one process's block) against one
    process at ``SUBLAYER_TOL`` (the row-parallel ``out_proj`` and the
    norm's statistic are sums of the ranks' partials: f32 summation
    order); the controls (each rank's own norm statistic; the statistic
    summed in the forward only) miss by more than ``CONTROL_MISS``;
  * the (1, 2) ``Trainer``, paper_fp4, 2 steps of 4 x 128 tokens, from
    the reference's init: mamba2 against the reference's ``Trainer`` on 2
    forced CPU devices at ``FP4_TOL`` (as
    ``tests/test_torch_spmd_train.py``'s model axis), its update (params
    minus init) within ``UPDATE_RTOL``; jamba against the reference's
    1-device ``Trainer`` (its own 2-device run departs from it: ROADMAP
    queue C), step 0 at ``FP4_TOL`` and the params at ``FP4_TOL``'s
    params bar; its second step within ``JAMBA_TOL``;
  * jamba's (1, 2) ``Trainer`` against the port's own one process from
    the same init (``ONE_TOL``): the paper_fp4 run at step 0; with every
    token routed to every expert (no top-k choice, no drop) and the bf16
    recipe (no FP4 rounding) every split run's losses and update, and a
    control run with the mamba leaves whole on both ranks;
  * telemetry: mamba2's (1, 2) step-0 rows against the port's one
    process, the taps equal and every stat within ``TEL_RTOL``.

The reference runs its two cases in two subprocesses beside the ranks;
the ranks run every case in one process group
(``torch_dist_workers.ssm_axis``).
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
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import default_rules as j_rules  # noqa
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.analysis import qlint  # noqa: E402
from repro_torch.configs.base import MoESettings, get_config  # noqa
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import AbstractMesh, default_rules  # noqa
from repro_torch.distributed.comms import CollectiveRecord  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.ssm import mamba_param_specs  # noqa: E402
from repro_torch.nn.params import spec_leaves  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_dist_workers import _tiny_trainer, start_ranks  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAMBA2, JAMBA = "mamba2-780m", "jamba-1.5-large-398b"
# (name, arch, config fields, recipe, impl), f32: paper_fp4 over "qdq"
# and over the kernels' plain versions (in_dt holds 4 of 8 heads; the
# out_proj's 64 of d_inner's 128 straddle its K blocks), and
# fine_grained_fp4 (the dgrad's fp8_e5m2 token groups run along the
# split N and share their amax; the wgrad's SR keyed by global columns)
SUBLAYER_CASES = [
    ("m2_qdq", MAMBA2, dict(dtype="float32"), "paper_fp4", "qdq"),
    ("m2_pallas", MAMBA2, dict(dtype="float32"), "paper_fp4", "pallas"),
    ("m2_fine_pallas", MAMBA2, dict(dtype="float32"), "fine_grained_fp4",
     "pallas"),
    ("jamba_qdq", JAMBA, dict(dtype="float32"), "paper_fp4", "qdq"),
    ("jamba_pallas", JAMBA, dict(dtype="float32"), "paper_fp4", "pallas"),
]
# against one process, relative to each one's max |.| (read on the CPU:
# 3.5e-7 on y, 3.9e-7 on dx, 1.3e-6 on a_log's gradient)
SUBLAYER_TOL = 1e-5
# the controls miss one process by far more (read: the rank's own
# statistic 0.46 on y and dx; the forward-only sum 0.26 on dx)
CONTROL_MISS = 1e-2
FP4 = dict(recipe="paper_fp4", global_batch=4, seq_len=128,
           learning_rate=1e-4)
# tests/test_torch_spmd_train.py's FP4_TOL (ten times the bf16 mesh bars)
FP4_TOL = dict(loss=1e-4, grad_norm=1e-3, params=1e-3)
# mamba2's update (params - init) against the reference's (read 3.3e-5)
UPDATE_RTOL = 1e-3
# jamba's second step against the reference's 1-device run: the split's
# f32 sums (out_proj, the norm's statistic) move a token's MoE routing
# and so the step-1 loss (read: 1.7e-3 loss, 1.2e-2 grad norm, the
# update 7.4e-2; the port's one process on the same config reads 6e-4
# and 5.9e-3 off the same run, the reference's own 2-device run 3.7e-3
# on the loss)
JAMBA_TOL = dict(loss=5e-3, grad_norm=3e-2, update=0.2)
# jamba's (1, 2) runs against the port's one process on the same
# config and init.  Under paper_fp4 any f32 reordering (the mamba norm's
# statistic, out_proj's or the attention's row-parallel sums) moves a
# routed token or an FP4 rounding: the split run, and a run with only
# the mamba leaves whole, read the same step-0 loss, 3.9e-5 off.  With
# ROUTE_ALL and the bf16 recipe nothing discrete is left: the split run
# reads 0 on both losses and 3.6e-5 on the update, the mamba-whole
# control 7.4e-8 and 1.4e-5 (under paper_fp4 with ROUTE_ALL the mamba
# split alone reads 1.9e-4 at step 0: FP4 flips, not the split's sums).
ROUTE_ALL = MoESettings(num_experts=4, top_k=4, capacity_factor=1.0,
                        every_k_layers=2, group_size=64)
MAMBA_AXES = ("mamba_inner", "mamba_heads", "mamba_groups")
ONE_TOL = {"jamba": dict(loss0=FP4_TOL["loss"]),
           "jamba_bf16": dict(loss=1e-6, update=1e-4),
           "jamba_bf16_mamba_whole": dict(loss=1e-6, update=1e-4)}
# name -> (the port's one-process run it is held to, TrainConfig and
# config fields beside FP4's and jamba's, rules' axes kept whole)
ONE_BF16 = dict(recipe="bf16", model=dict(linear_impl="qdq",
                                          moe=ROUTE_ALL))
ONE_CASES = {"jamba": ("jamba", dict(model=dict(linear_impl="qdq")), ()),
             "jamba_bf16": ("jamba_bf16", ONE_BF16, ()),
             "jamba_bf16_mamba_whole": ("jamba_bf16", ONE_BF16,
                                        MAMBA_AXES)}
# telemetry under the split: mamba2's (1, 2) step 0 against the port's
# one process ("qdq": the forward stats are sampled there on both), the
# taps equal, the stats within TEL_RTOL (read 0 misses at 2e-3)
TEL_CASE = dict(FP4, arch="mamba2_780m", telemetry=True, mesh_shape=(1, 2),
                model=dict(linear_impl="qdq"))
TEL_RTOL = 2e-3
# name -> (arch, the port's linear_impl, reference mesh or None)
TRAIN_CASES = {
    "mamba2": (MAMBA2, "pallas", [1, 2]),
    "jamba": (JAMBA, "qdq", None),
}

REF = textwrap.dedent("""
    import os, sys, json, importlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models import build_model
    from repro.train.trainer import Trainer
    out_dir, fp4, cases = sys.argv[1], json.loads(sys.argv[2]), \\
        json.loads(sys.argv[3])
    res = {}
    for name, (arch, _impl, mesh) in cases.items():
        mod = arch.replace("-", "_").replace(".", "_")
        cfg = importlib.import_module("repro.configs." + mod).REDUCED
        cfg = cfg.replace(dtype="float32")
        kw = dict(fp4, total_steps=2, log_every=0)
        if mesh:
            kw["mesh_shape"] = tuple(mesh)
        tr = Trainer(build_model(cfg), TrainConfig(**kw),
                     SyntheticLM(cfg.vocab_size, kw["seq_len"],
                                 kw["global_batch"]))
        st = tr.train(tr.init_state())
        np.savez(os.path.join(out_dir, name + ".npz"),
                 *[np.asarray(v) for v in jax.tree.leaves(st.params)])
        res[name] = {"loss": [r["loss"] for r in tr.history],
                     "grad_norm": [r["grad_norm"] for r in tr.history]}
    print(json.dumps(res))
""")


def _mod(arch):
    return arch.replace("-", "_").replace(".", "_")


def _cfgs(arch, reduced=True):
    """(the reference's config, the port's), f32."""
    if not reduced:
        return j_get_config(arch), get_config(arch)
    return tuple(importlib.import_module(f"{pkg}.configs.{_mod(arch)}")
                 .REDUCED.replace(dtype="float32")
                 for pkg in ("repro", "repro_torch"))


def _one_over(name, mesh):
    """``ONE_CASES[name]``'s ``_tiny_trainer`` fields, on the (1, 2) mesh
    or in one process."""
    _, over, whole = ONE_CASES[name]
    over = dict(FP4, arch=_mod(JAMBA), **over)
    if mesh:
        over.update(mesh_shape=(1, 2), whole=whole)
    return over


def _one_process(name, init):
    """jamba's one-process run ``name`` of ``ONE_CASES`` from ``init``
    (the reference's numpy tree): (losses, params)."""
    tr = _tiny_trainer(_one_over(name, False), steps=2)
    st = tr.train(tr.init_state(params=params_from_jax(init,
                                                       tr.model.cfg)))
    return ([h["loss"] for h in tr.history],
            [t.detach().numpy() for t in tree_leaves(st.params)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a subprocess a case, side by side) and the
    2 ranks' results, with the init both start from; the port's one
    process of the telemetry case and of jamba's ``ONE_CASES``, run
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("ssm_axis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF, str(tmp), json.dumps(FP4),
         json.dumps({name: case})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, case in TRAIN_CASES.items()]
    try:
        inits = {name: jax.tree.map(np.asarray, j_build(_cfgs(arch)[0]).init(
                     jax.random.PRNGKey(0), jnp.float32))
                 for name, (arch, *_) in TRAIN_CASES.items()}
        train = [(name, dict(FP4, mesh_shape=(1, 2), arch=_mod(arch),
                             model=dict(linear_impl=impl)), 2)
                 for name, (arch, impl, _) in TRAIN_CASES.items()]
        train.append(("telemetry", TEL_CASE, 1))
        train += [(name, _one_over(name, True), 2) for name in ONE_CASES
                  if name not in TRAIN_CASES]
        ranks = start_ranks("ssm_axis", 2, tmp, SUBLAYER_CASES, train,
                            dict(inits, telemetry=None, **{
                                name: inits["jamba"] for name in ONE_CASES}))
        one = _tiny_trainer(dict(TEL_CASE, mesh_shape=None), steps=1)
        one.train(one.init_state())
        ones = {name: _one_process(name, inits["jamba"])
                for name in {c[0] for c in ONE_CASES.values()}}
        ranks = ranks()
        ref = {"telemetry": [{k: float(v) for k, v in h.items()
                              if k.startswith("tel/")} for h in one.history],
               "one": ones}
        for proc in refs:
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            ref.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in refs:
            if proc.poll() is None:
                proc.kill()
    return ref, ranks, tmp, inits


def _block(want, got, rank):
    """The rank's block of one process's ``want`` along the one dim where
    ``got`` is smaller (``want`` itself for a whole leaf)."""
    if got.shape == want.shape:
        return want
    dim = next(d for d, (a, b) in enumerate(zip(got.shape, want.shape))
               if a != b)
    n = got.shape[dim]
    return np.take(want, range(rank * n, (rank + 1) * n), axis=dim)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", [c[0] for c in SUBLAYER_CASES])
def test_mixer_sublayer_on_the_model_axis(name, runs):
    """Whole SSD heads on 2 ranks: each rank's norm input is one
    process's columns bit for bit; the output, the input's cotangent and
    every leaf's gradient (a split leaf's as its block) within
    ``SUBLAYER_TOL`` of one process; every whole leaf's gradient equal on
    both ranks; both statistic controls miss; the statistic travels as
    ``tp_norm``, one f32 word a token each way, and the step's
    collectives audit clean."""
    ranks = runs[1]
    arch = next(c[1] for c in SUBLAYER_CASES if c[0] == name)
    for rank, r in enumerate(ranks):
        case = r["sublayer"][name]
        labels = ["norm_in", "y", "dx"] + case["keys"]
        split = case["split"]
        want0 = _block(case["whole"][0], split[0], rank)
        assert split[0].shape != case["whole"][0].shape
        np.testing.assert_array_equal(split[0], want0, err_msg=name)
        for lab, got, want in zip(labels[1:], split[1:], case["whole"][1:]):
            want = _block(want, got, rank)
            assert got.shape == want.shape, (name, lab)
            assert _rel(got, want) <= SUBLAYER_TOL, (name, lab,
                                                     _rel(got, want))
        # the controls: the rank's own statistic misses the output; the
        # forward-only sum gives the output but misses the cotangent
        assert _rel(case["own"][1], case["whole"][1]) > CONTROL_MISS
        assert _rel(case["forward"][1], case["whole"][1]) <= SUBLAYER_TOL
        assert _rel(case["forward"][2], case["whole"][2]) > CONTROL_MISS
        recs = [CollectiveRecord(**c) for c in case["census"]]
        census, findings = qlint.audit_comms(recs, expect_fp8=False)
        assert findings == []
        tokens = 2 * 128
        assert census["tp_norm_ops"] == 2
        assert census["tp_norm_bytes_by_layer"] == {"-": 2 * 4 * tokens}
        assert census["tp_sums"] > 0 and census["amax_model_ops"] > 0
        if "fine" in name:      # the dgrad's token groups share the amax
            assert any(c.tag == "amax_model" and c.op == "all-reduce"
                       for c in recs)
        bad = [dict(c, dtype="bfloat16") if c["tag"] == "tp_norm" else c
               for c in case["census"]]
        _, found = qlint.audit_comms([CollectiveRecord(**c) for c in bad],
                                     expect_fp8=False)
        assert len(found) == 2
    # whole leaves: the same gradient on every rank; jamba's groups split
    keys = ranks[0]["sublayer"][name]["keys"]
    split_keys = set(ranks[0]["sublayer"][name]["split_keys"])
    whole = [k for k in keys if k not in split_keys]
    assert {"dt_bias", "a_log", "d_skip"} <= set(whole)
    assert ({"in_b", "conv_wb"} <= set(whole)) == (arch == MAMBA2)
    for i, k in enumerate(keys):
        if k in whole:
            np.testing.assert_array_equal(
                ranks[0]["sublayer"][name]["split"][3 + i],
                ranks[1]["sublayer"][name]["split"][3 + i], err_msg=k)


def _update_rel(got, want, init):
    """The L2 norm of ``got - want`` over that of ``want``'s update from
    ``init`` (param lists)."""
    diff = sum(float(((a - b).astype(np.float64) ** 2).sum())
               for a, b in zip(got, want)) ** 0.5
    upd = sum(float(((b - c).astype(np.float64) ** 2).sum())
              for b, c in zip(want, init)) ** 0.5
    return diff / max(upd, 1e-30)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_ssm_trainer_matches_reference(name, runs):
    """mamba2-780m and jamba ``REDUCED`` on a (1, 2) mesh of 2 gloo ranks
    (mamba2: 4 of 8 heads a rank, its one group whole; jamba: the same
    heads and one of 2 groups a rank, 2 of 4 attention heads, 1 of 2 KV
    heads and 2 of 4 experts), paper_fp4, from the reference's init:
    every rank's rows and params equal; each leaf's block the rules'
    slice; the steps' collectives audit clean with the norm's statistic
    in the census; loss, grad norm, params and the update against the
    reference's ``Trainer`` (module docstring)."""
    ref, ranks, out_dir, inits = runs
    arch, _, mesh = TRAIN_CASES[name]
    got = ranks[0][name]
    for a, b in zip(ranks[1][name]["params"], got["params"]):
        np.testing.assert_array_equal(a, b)
    assert [h["loss"] for h in ranks[1][name]["history"]] == \
        [h["loss"] for h in got["history"]]
    jcfg, tcfg = _cfgs(arch)
    specs = build_model(tcfg, "meta").param_specs()
    rules = default_rules(AbstractMesh((1, 2), ("data", "model")), tcfg)
    want_local = []
    for sp in spec_leaves(specs):
        shape = list(sp.shape)
        for d, names in rules.param_sharding(sp).dim_axes().items():
            shape[d] //= 2 if "model" in names else 1
        want_local.append(tuple(shape))
    assert got["local_shapes"] == want_local
    census, findings = qlint.audit_comms(got["census"], expect_fp8=False,
                                         compute_dtype="float32")
    assert findings == []
    n_mamba = sum(s.mixer == "mamba" for s in tcfg.layer_specs())
    # a layer's statistic: forward, the remat recompute, backward
    assert census["tp_norm_ops"] == 3 * n_mamba
    assert all(v == 3 * 4 * 4 * 128 for v in
               census["tp_norm_bytes_by_layer"].values())
    if name == "jamba":
        assert census["ep_ops"] and census["tp_sums"] > 0
    hist = {k: [h[k] for h in got["history"]] for k in ("loss",
                                                        "grad_norm")}
    assert all(np.isfinite(hist["loss"]))
    like = j_build(jcfg).abstract_params()
    want = np.load(out_dir / f"{name}.npz")
    want = params_from_jax(jax.tree.unflatten(
        jax.tree.structure(like),
        [want[f"arr_{i}"] for i in range(len(want.files))]), tcfg)
    want = [b.numpy() for b in tree_leaves(want)]
    init = [t.numpy() for t in tree_leaves(params_from_jax(inits[name],
                                                           tcfg))]
    rel = _update_rel(got["params"], want, init)
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=FP4_TOL["params"],
                                   err_msg=name)
    if name == "mamba2":
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(hist[key], ref[name][key],
                                       rtol=FP4_TOL[key], err_msg=key)
        assert rel <= UPDATE_RTOL, rel
    else:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(hist[key][0], ref[name][key][0],
                                       rtol=FP4_TOL[key], err_msg=key)
            np.testing.assert_allclose(hist[key], ref[name][key],
                                       rtol=JAMBA_TOL[key], err_msg=key)
        assert rel <= JAMBA_TOL["update"], rel


@pytest.mark.parametrize("name", list(ONE_CASES))
def test_jamba_trainer_matches_one_process(name, runs):
    """jamba ``REDUCED`` on the (1, 2) mesh against the port's own one
    process from the same init (``ONE_TOL``): under paper_fp4 step 0's
    loss; with every token routed to every expert under the bf16 recipe
    the split run's and the mamba-whole control's every loss and their
    update (params minus init)."""
    ref, ranks, _, inits = runs
    one_name = ONE_CASES[name][0]
    losses, params = ref["one"][one_name]
    got = ranks[0][name]
    have = [h["loss"] for h in got["history"]]
    tol = ONE_TOL[name]
    if "loss0" in tol:
        assert abs(have[0] - losses[0]) <= tol["loss0"] * abs(losses[0]), \
            (have, losses)
        return
    np.testing.assert_allclose(have, losses, rtol=tol["loss"])
    # ROUTE_ALL changes no leaf's shape: the default config converts
    init = [t.numpy() for t in tree_leaves(params_from_jax(
        inits["jamba"], _cfgs(JAMBA)[1]))]
    rel = _update_rel(got["params"], params, init)
    assert rel <= tol["update"], (name, rel)


MESHES = ((1, 2), (1, 3), (1, 4))


@pytest.mark.parametrize("arch,reduced", [(MAMBA2, False), (MAMBA2, True),
                                          (JAMBA, False), (JAMBA, True)])
def test_mamba_layout_matches_reference(arch, reduced):
    """On ``AbstractMesh`` (1, 2), (1, 3) and (1, 4): which mamba leaves
    split over ``model``, and how, equals the reference's
    ``default_rules`` specs; the heads split where their count divides
    the axis (then whole heads a rank), the groups where theirs does,
    and the per-head ``dt_bias`` / ``a_log`` / ``d_skip`` never."""
    jcfg, tcfg = _cfgs(arch, reduced)
    jspecs = j_build(jcfg).param_specs()
    jlayer = jspecs["stack"]["groups"]["l00"]["mixer"]
    tspecs = mamba_param_specs(tcfg)
    st = tcfg.mamba
    nheads = st.expand * tcfg.d_model // st.headdim
    for shape in MESHES:
        axes = ("data", "model")
        jr = j_rules(JAbstractMesh(shape, axes), jcfg)
        tr = default_rules(AbstractMesh(shape, axes), tcfg)
        m = shape[1]
        for k, sp in tspecs.items():
            # the reference's scan-stacked spec leads with the layers
            jspec = tuple(jr.param_sharding(jlayer[k]).spec)[1:]
            jspec = (jspec + (None,) * len(sp.shape))[:len(sp.shape)]
            tspec = tuple(tr.param_sharding(sp).spec)
            tspec = (tspec + (None,) * len(sp.shape))[:len(sp.shape)]
            assert tspec == jspec, (arch, reduced, shape, k)
            split = "model" in tspec
            if k in ("dt_bias", "a_log", "d_skip"):
                assert not split
            elif k in ("in_b", "in_c", "conv_wb", "conv_wc", "conv_bb",
                       "conv_bc"):
                assert split == (st.n_groups % m == 0), (k, shape)
            else:
                assert split == (nheads % m == 0), (k, shape)
                if split:      # whole heads a rank
                    dim = tspec.index("model")
                    per = sp.shape[dim] // m
                    assert per % (st.headdim if k != "in_dt" else 1) == 0


def test_mamba_telemetry_matches_one_process(runs):
    """Telemetry on mamba2's (1, 2) split (the taps of the column- and
    row-parallel linears, their stats reduced over the model group):
    step 0's keys and tap counts equal the port's one process's, every
    stat within ``TEL_RTOL``, the same on both ranks."""
    ref, ranks = runs[:2]
    want = ref["telemetry"][0]
    got = {k: v for k, v in ranks[0]["telemetry"]["history"][0].items()
           if k.startswith("tel/")}
    assert set(got) == set(want) and any("/ssm/" in k for k in want)
    misses = [(k, got[k], w) for k, w in want.items()
              if (got[k] != w if k.endswith("/taps")
                  else abs(got[k] - w) > TEL_RTOL * abs(w) + 1e-9)]
    assert not misses, misses[:10]
    assert {k: v for k, v in ranks[1]["telemetry"]["history"][0].items()
            if k.startswith("tel/")} == got
