"""Tensor parallelism on the ``model`` axis (the Megatron layout) in the
port, held to the JAX reference's layout and to the port's own single
process.

Bars:
  * bitwise: each leaf's block on (1, 2), (2, 2), (1, 4) and (1, 16)
    meshes of ``tiny``, gpt2-125m, olmoe-1b-7b and mixtral-8x22b (full and
    ``REDUCED``) against the slice the
    reference's ``default_rules(...).param_sharding`` spec gives (KV heads
    kept whole where their count does not divide the axis, gpt2's odd
    vocab kept whole), and the blocks the ranks of a live mesh hold; on
    two gloo ranks, every QDQ'd operand of a column- and a row-parallel
    linear (token, tensor, block and tile groups, SR) against the same
    block of one process's QDQ of the whole operand, the straddling block
    and tile groups of ``tiny``'s FFN (a rank holds 64 of a 128 group)
    included; the control (each rank's own amax, SR keyed from 0) misses;
  * allclose: the linears' outputs and gradients against one process's
    (f32, float summation order: rtol 1e-5, atol 1e-5 * max|.|); the
    (1, 4) mesh, whose KV heads are whole on every rank, one step against
    one process: loss rtol 1e-6, params atol 1e-6 under bf16, loss rtol
    1e-6 under paper_fp4 (the partial sums' order flips a quantized
    element now and then, which moves the gradient, not the loss);
  * raises: a local K that neither divides the 128 group nor is a
    multiple of it (``ValueError``, both impls); the cross-attention
    families, and fp8 compression, on a model axis > 1
    (``NotImplementedError``).

The reference end to end (its ``Trainer`` on (1, 2) and (2, 2)) is in
``tests/test_torch_spmd_train.py``, beside its other meshes.  Spawned
ranks meet through a ``FileStore`` (``torch_dist_workers``).
"""
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.distributed.sharding import default_rules as j_rules  # noqa
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.analysis import qlint  # noqa: E402
from repro_torch.configs.base import TrainConfig, get_config  # noqa: E402
from repro_torch.core.quantize import QuantSpec, model_span  # noqa: E402
from repro_torch.core.recipe import MM_FP8, RECIPES  # noqa: E402
from repro_torch.distributed import AbstractMesh, default_rules  # noqa
from repro_torch.models import build_model  # noqa: E402
from repro_torch.nn.params import spec_leaves  # noqa: E402
from repro_torch.train.train_step import (DataParallel,  # noqa: E402
                                          check_rules, make_train_step)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_dist_workers import _tiny_trainer, run_ranks  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (1, 16): the production model axis, where mixtral's 8 experts take
# d_ff inside every expert
MESHES = ((1, 2), (2, 2), (1, 4), (1, 16))


def _config(name):
    if name.endswith("-reduced"):
        mod = name[:-len("-reduced")].replace("-", "_").replace(".", "_")
        return (importlib.import_module("repro.configs." + mod).REDUCED,
                importlib.import_module("repro_torch.configs." + mod).REDUCED)
    return j_get_config(name), get_config(name)


def _ref_local(spec, shape, sizes):
    out = list(shape)
    for d, e in enumerate(tuple(spec)[:len(shape)]):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            out[d] //= sizes[a]
    return tuple(out)


def _port_local(sharding, shape):
    """One rank's block of a tensor of ``shape`` laid out by the port's
    ``sharding`` (on an ``AbstractMesh``)."""
    sizes = dict(zip(sharding.mesh.axis_names, sharding.mesh.axis_sizes))
    out = list(shape)
    for d, names in sharding.dim_axes().items():
        for n in names:
            out[d] //= sizes[n]
    return tuple(out)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", ["tiny", "gpt2-125m-reduced",
                                  "gpt2-125m", "olmoe-1b-7b",
                                  "olmoe-1b-7b-reduced", "mixtral-8x22b",
                                  "mixtral-8x22b-reduced"])
def test_local_blocks_match_reference(arch):
    """Each leaf's block on every mesh equals the slice of the
    reference's spec, leaf for leaf; KV heads whose count does not
    divide the model axis and an odd vocab stay whole; an MoE model's
    expert leaves split over the experts where their count divides the
    axis, else over each expert's d_ff."""
    jcfg, tcfg = _config(arch)
    jflat = jax.tree_util.tree_flatten_with_path(
        j_build(jcfg).param_specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
    jspecs = {"/".join(_key(k) for k in path): sp for path, sp in jflat}
    tspecs = _port_paths(build_model(tcfg, "meta").param_specs())
    assert set(jspecs) == set(tspecs)
    for shape in MESHES:
        axes = ("data", "model")
        sizes = dict(zip(axes, shape))
        jr = j_rules(JAbstractMesh(shape, axes), jcfg)
        tr = default_rules(AbstractMesh(shape, axes), tcfg)
        for path, sp in tspecs.items():
            got = _port_local(tr.param_sharding(sp), sp.shape)
            want = _ref_local(jr.param_sharding(jspecs[path]).spec,
                              sp.shape, sizes)
            assert got == want, (arch, shape, path)
            m = dict(zip(sp.axes, range(len(sp.axes))))
            if "kv_heads" in m:
                whole = tcfg.n_kv_heads % shape[1] != 0
                assert (got[m["kv_heads"]] == sp.shape[m["kv_heads"]]) \
                    == whole, (arch, shape, path)
            if "vocab" in m:
                assert (got[m["vocab"]] == tcfg.vocab_size) == bool(
                    tcfg.vocab_size % shape[1]), (arch, shape, path)
            if "experts" in m:
                ep = tcfg.moe.num_experts % shape[1] == 0
                assert (got[m["experts"]] < sp.shape[m["experts"]]) == ep
                assert (got[m["mlp"]] < sp.shape[m["mlp"]]) == (not ep)


def test_model_span():
    """How a quant group meets a model-split axis a rank holds n of."""
    assert model_span("token", 128, 64, True) == "share"
    assert model_span("token", 128, 64, False) is None
    assert model_span("tensor", 128, 256, False) == "share"
    assert model_span("block", 128, 64, True) == "window"
    assert model_span("block", 128, 64, False) is None
    assert model_span("tile", 128, 32, False) == "window"
    assert model_span("tile", 128, 256, True) is None
    with pytest.raises(ValueError, match="holds 96"):
        model_span("block", 128, 96, True)
    with pytest.raises(ValueError, match="holds 192"):
        model_span("tile", 128, 192, False)
    # an edge over the whole axis (mamba2's in_dt: 48 heads, 24 a rank)
    assert model_span("tile", 128, 24, False, 2) == "share"
    assert model_span("block", 128, 24, True, 2) == "share"
    with pytest.raises(ValueError, match="holds 96"):
        model_span("block", 128, 96, True, 2)


TENSOR_FWD = dataclasses.replace(
    MM_FP8, fwd_x=QuantSpec("fp8_e4m3", "tensor"),
    fwd_w=QuantSpec("fp8_e4m3", "tensor"),
    dgrad_g=QuantSpec("fp8_e5m2", "tensor"))
ATTN, FFN = ("paper_fp4", "attn_linear"), ("paper_fp4", "ffn_linear")
SR_FFN = ("fine_grained_fp4", "ffn_linear")
# (name, impl, recipe, tp, (m, k, n)); a rank holds half of k (row) or n
# (col).  tiny's FFN: d_ff 128 on 2 ranks, 64 a rank of every 1 x 128
# block and 128 x 128 tile along it; a K of 192 leaves 96 a rank
OPERAND_CASES = [
    ("attn_col_qdq", "qdq", ATTN, "col", (256, 128, 256)),
    ("attn_row_qdq", "qdq", ATTN, "row", (256, 256, 128)),
    ("attn_col_pallas", "pallas", ATTN, "col", (256, 128, 256)),
    ("attn_row_pallas", "pallas", ATTN, "row", (256, 256, 128)),
    ("tensor_col_pallas", "pallas", TENSOR_FWD, "col", (256, 128, 256)),
    ("tensor_row_qdq", "qdq", TENSOR_FWD, "row", (256, 256, 128)),
    ("ffn_up_qdq", "qdq", FFN, "col", (256, 64, 128)),
    ("ffn_down_qdq", "qdq", FFN, "row", (256, 128, 64)),
    ("ffn_up_pallas", "pallas", FFN, "col", (256, 64, 128)),
    ("ffn_down_pallas", "pallas", FFN, "row", (256, 128, 64)),
    ("sr_up_pallas", "pallas", SR_FFN, "col", (256, 128, 256)),
    ("straddle_qdq", "qdq", FFN, "row", (256, 192, 128)),
    ("straddle_pallas", "pallas", FFN, "row", (256, 192, 128)),
]


@pytest.fixture(scope="module")
def operand_ranks(tmp_path_factory):
    return run_ranks("model_operands", 2,
                     tmp_path_factory.mktemp("tp_ops"), OPERAND_CASES)


@pytest.mark.parametrize("name", [c[0] for c in OPERAND_CASES
                                  if not c[0].startswith("straddle")])
def test_model_split_operands_bitwise(name, operand_ranks):
    """On 2 ranks each holding half of the split axis, every quantized
    operand of the three roles equals the same block of one process's
    bit for bit; the control (no model split: each rank's own amax, SR
    keyed from 0) misses on some rank; y, dx and dw are one process's
    (a row-parallel y and a column-parallel dx summed over the ranks)."""
    tp = next(c[3] for c in OPERAND_CASES if c[0] == name)
    missed = False
    for rank, r in enumerate(operand_ranks):
        case = r[name]
        assert len(case["split"]) == len(case["whole"]) >= 4
        for (role, side, got), want in zip(case["split"], case["whole"]):
            assert got.shape == want.shape, (name, role, side)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {role} {side}")
        missed |= any(a.shape != b.shape or not np.array_equal(a, b)
                      for a, b in zip(case["local"], case["whole"]))
        y, dx, dw = case["outs"]
        wy, wdx, wdw = case["outs_whole"]
        n_y, n_k = y.shape[1], dx.shape[1]
        cut = {"col": (wy[:, rank * n_y:(rank + 1) * n_y], wdx,
                       wdw[:, rank * n_y:(rank + 1) * n_y]),
               "row": (wy, wdx[:, rank * n_k:(rank + 1) * n_k],
                       wdw[rank * n_k:(rank + 1) * n_k])}[tp]
        for got, want in zip((y, dx, dw), cut):
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    assert missed, name


@pytest.mark.parametrize("name", ["straddle_qdq", "straddle_pallas"])
def test_straddling_model_split_raises(name, operand_ranks):
    """A block group along a row-parallel K of 192 (96 a rank: neither a
    divisor nor a multiple of 128) raises ``ValueError`` naming it."""
    for r in operand_ranks:
        assert "holds 96" in r[name]["error"]


def test_unsplit_families_raise():
    """Cross-attention models (whisper, the vlm), and fp8 compression, on
    a model axis > 1 raise ``NotImplementedError``; on a model axis of 1
    they take no model split; the MoE family and mamba (mamba2, and
    jamba's hybrid) pass the check (tests/test_torch_expert_parallel.py
    and tests/test_torch_ssm_parallel.py train them)."""
    mesh = AbstractMesh((1, 2), ("data", "model"))
    for arch in ("olmoe_1b_7b", "mixtral_8x22b", "mamba2_780m",
                 "jamba_1_5_large_398b"):
        cfg = importlib.import_module("repro_torch.configs." + arch).REDUCED
        check_rules(default_rules(mesh, cfg), build_model(cfg, "meta"))
    for arch in ("llama-3.2-vision-90b", "whisper-base"):
        cfg = importlib.import_module(
            "repro_torch.configs." + arch.replace("-", "_").replace(
                ".", "_")).REDUCED
        model = build_model(cfg, "meta")
        with pytest.raises(NotImplementedError, match="model axis"):
            DataParallel.of(model, default_rules(mesh, cfg))
        one = default_rules(AbstractMesh((1, 1), ("data", "model")), cfg)
        assert DataParallel.of(model, one) is None
    cfg = get_config("tiny")
    with pytest.raises(NotImplementedError, match="compression"):
        make_train_step(build_model(cfg, "meta"),
                        TrainConfig(grad_compression="fp8"), RECIPES["bf16"],
                        rules=default_rules(mesh, cfg))


# the (1, 4) mesh: tiny's 2 KV heads stay whole on every rank (4 query
# heads, one a rank), its d_ff of 128 leaves 32 a rank of every FFN group
KV_CASES = [
    ("bf16", dict(mesh_shape=(1, 4), global_batch=4, seq_len=128,
                  learning_rate=1e-4), 1),
    ("fp4", dict(mesh_shape=(1, 4), recipe="paper_fp4", global_batch=4,
                 seq_len=128, learning_rate=1e-4, telemetry=True,
                 model=dict(linear_impl="pallas")), 1)]
# telemetry under the model split against one process (step 0): taps and
# keys equal; the cotangent-side rates within 5e-4 (test_torch_telemetry's
# bar: a flip of the partial sums' order moves a count); the forward-side
# stats within TEL_RTOL; the cotangent-side floats and the gradient norms
# within BWD_RTOL (the cotangents carry those flips: read dgrad_g rel_err
# 4.5e-4; test_torch_spmd_train's TEL_RTOL against the reference is 2e-3)
TEL_RTOL, BWD_RTOL = 1e-4, 2e-3


@pytest.fixture(scope="module")
def kv_ranks(tmp_path_factory):
    """The (1, 4) cases on 4 gloo ranks; the bf16 one checkpoints its
    step (``ckpt`` in its result: the directory)."""
    tmp = tmp_path_factory.mktemp("tp_kv")
    ckpt = str(tmp / "ckpt")
    cases = [(n, dict(o, checkpoint_every=1, checkpoint_dir=ckpt)
              if n == "bf16" else o, s_) for n, o, s_ in KV_CASES]
    ranks = run_ranks("train_cases", 4, tmp, cases)
    ranks[0]["bf16"]["ckpt"] = ckpt
    return ranks


@pytest.mark.parametrize("name", [c[0] for c in KV_CASES])
def test_whole_kv_heads_match_one_process(name, kv_ranks):
    """(1, 4): each rank projects the whole KV heads and reads the one
    its query head uses, the cotangent of K / V summed over the ranks;
    every rank's rows and params equal, one step against the port's one
    process (module docstring's bars); each rank's blocks are the rules'
    slices; the step's collectives audit clean (row-parallel sums by
    layer, shared amax words); the bf16 run's checkpoint holds the full
    arrays."""
    over, steps = next((o, s) for n, o, s in KV_CASES if n == name)
    got = kv_ranks[0][name]
    for r in kv_ranks[1:]:
        assert [h["loss"] for h in r[name]["history"]] == \
            [h["loss"] for h in got["history"]]
        for a, b in zip(r[name]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    one_over = {k: v for k, v in over.items() if k != "mesh_shape"}
    one = _tiny_trainer(one_over, steps=steps)
    state = one.train(one.init_state())
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in one.history], rtol=1e-6)
    if name == "bf16":
        for a, b in zip(got["params"], tree_leaves(state.params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-6)
        # the checkpoint holds full arrays: a trainer with no mesh
        # restores the ranks' gathered params bit for bit
        back = _tiny_trainer(dict(one_over, checkpoint_every=1,
                                  checkpoint_dir=got["ckpt"]),
                             steps=steps).resume()
        assert back.step == steps
        for a, b in zip(got["params"], tree_leaves(back.params)):
            np.testing.assert_array_equal(a, b.numpy())
    if name == "fp4":
        want = {k: v for k, v in one.history[0].items()
                if k.startswith("tel/")}
        have = {k: v for k, v in got["history"][0].items()
                if k.startswith("tel/")}
        assert set(have) == set(want) and want
        for k, w in want.items():
            if k.endswith("/taps"):
                assert have[k] == w, k
            elif k.startswith("tel/bwd/") and k.rsplit("/", 1)[1] in (
                    "clip", "underflow"):
                assert abs(have[k] - w) <= 5e-4, (k, have[k], w)
            else:
                rtol = (BWD_RTOL if k.startswith(("tel/bwd/", "tel/gnorm"))
                        else TEL_RTOL)
                assert abs(have[k] - w) <= rtol * abs(w) + 1e-9, \
                    (k, have[k], w)
    specs = one.model.param_specs()
    rules = default_rules(AbstractMesh((1, 4), ("data", "model")),
                          one.model.cfg)
    assert got["local_shapes"] == [
        _port_local(rules.param_sharding(sp), sp.shape)
        for sp in spec_leaves(specs)]
    census, findings = qlint.audit_comms(got["census"], expect_fp8=False)
    assert findings == []
    assert census["tp_sums"] > 0
    assert set(census["tp_bytes_by_layer"]) == {"tp_fwd", "tp_bwd"}
    assert {"L0", "L1"} <= set(census["tp_bytes_by_layer"]["tp_fwd"])
    if name == "fp4":
        assert census["amax_model_ops"] > 0


def test_train_cli_mesh_2x2_under_torchrun():
    """``launch/train.py --mesh 2,2 --recipe paper_fp4`` on 4 CPU ranks
    under torchrun (2 x 128 tokens a data rank: the FFN wgrad's block
    groups end on its boundary): exit 0, rank 0 prints the step lines and
    ``eval:`` once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--mesh", "2,2", "--recipe", "paper_fp4",
         "--steps", "2", "--batch", "4", "--seq", "128"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("eval:") for ln in lines) == 1
    assert sum(ln.startswith("step ") for ln in lines) == 2
