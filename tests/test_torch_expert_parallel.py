"""Mixture-of-experts layers on the ``model`` axis in the port, held to
the JAX reference and to the port's own single process.

Where the expert count divides the model axis each rank holds whole
experts (expert parallelism: olmoe-1b-7b ``REDUCED``'s 8 experts, 4 a
rank); where it does not, every rank holds its block of each expert's
``d_ff`` (the same config with 3 experts).

Bars:
  * bitwise: on 2 gloo ranks, the expert-parallel MoE sublayer (layer 0
    of ``init(0)``, f32 and bf16, the kernels' plain versions and
    ``qdq``) against one process on whole experts: its output, its
    input's cotangent and the router's gradient on every rank, and each
    expert leaf's gradient as the same experts' slice; the control (a
    rank's combine over its own experts alone) misses;
  * allclose: the ``d_ff``-split sublayer against one process (a
    row-parallel output is the sum of the ranks' partial products: f32
    summation order, ``SUBLAYER_TOL``); the port's (1, 2) ``Trainer``
    against the reference's ``Trainer`` on 2 forced CPU devices from the
    same init, paper_fp4, 2 steps of 4 x 128 tokens (``FP4_TOL``, as
    ``tests/test_torch_spmd_train.py``'s model axis, and the update,
    params minus init, within ``UPDATE_RTOL`` of the reference's update:
    at lr 1e-4 an element moves ~2e-4, under FP4_TOL's params bar), with
    telemetry rows on the expert-parallel run (step 0 within
    ``TEL_RTOL``);
  * against the port's own one process (``ONE_TOL``): the (1, 2) runs,
    and one with the attention's heads whole on both ranks (the experts
    alone split), whose forward is one process's bits.

The reference runs in one subprocess beside the ranks; the ranks run
every case in one process group (``torch_dist_workers.moe_axis``), the
4-rank case in another beside it, and the one-process runs meanwhile.
"""
import dataclasses
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

from repro.models import build_model as j_build  # noqa: E402
from repro_torch.analysis import qlint  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import AbstractMesh, default_rules  # noqa
from repro_torch.distributed.comms import CollectiveRecord  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.nn.params import spec_leaves  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_dist_workers import _tiny_trainer, start_ranks  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "olmoe-1b-7b"
# (name, arch, config fields, recipe, impl): expert parallelism (8 of 8
# experts split 4 a rank) and d_ff inside every expert (3 experts: 32 of
# d_ff's 64 a rank, every FFN block / tile group straddling the ranks)
SUBLAYER_CASES = [
    ("ep_f32_pallas", ARCH, dict(dtype="float32"), "paper_fp4", "pallas"),
    ("ep_bf16_pallas", ARCH, dict(), "paper_fp4", "pallas"),
    ("ep_bf16_qdq", ARCH, dict(), "fp8", "qdq"),
    ("tp_f32_pallas", ARCH, dict(dtype="float32", experts=3), "paper_fp4",
     "pallas"),
]
# the d_ff split against one process: y and dx are sums of the ranks'
# partials (read: 3e-7 on y, 6e-7 on dx, 1e-5 on the router's gradient,
# relative to each one's max |.|: f32 order, which may flip an FP4
# element of the router's cotangent path)
SUBLAYER_TOL = 1e-4
FP4 = dict(recipe="paper_fp4", global_batch=4, seq_len=128,
           learning_rate=1e-4)
# tests/test_torch_spmd_train.py's FP4_TOL (ten times the bf16 mesh bars)
FP4_TOL = dict(loss=1e-4, grad_norm=1e-3, params=1e-3)
TEL_RTOL = 2e-3
# the final params' update (params - init) against the reference's: the
# L2 norm of the difference over that of the reference's update (read
# on the CPU: 1.0e-4 ep, 1.1e-4 tp, bars ten times that; fp8 AdamW on
# (2, 2) 1.8e-2: its first step moves an element by +-lr, so a gradient
# element near zero that flips sign differs by 2 lr)
UPDATE_RTOL = {"ep": 1e-3, "tp": 1e-3, "ep_2x2": 1e-1}
# against the port's one process: step 0's loss where a row-parallel sum
# changes the forward's order (tests/test_torch_spmd_train.py's
# TP_ONE_TOL), and the update as UPDATE_RTOL (read 1.0e-4 ep, 5.8e-5 tp);
# with the heads whole the forward is one process's bits and only
# adafactor's update RMS sums over the model group: every loss within
# 1e-6, the update 2e-5 (read 2.0e-6) and each param 1e-6 (read 3e-8)
ONE_TOL = {"loss": 2e-5, "ep": 1e-3, "tp": 1e-3, "ep_heads": 2e-5,
           "params": 1e-6}
# name -> (experts, the port's linear_impl, optimizer, TrainConfig
# fields, steps); telemetry over "qdq" (the reference's forward stats are
# sampled there, as the port's; the kernels' epilogue reads whole
# operands), the d_ff split over the kernels' plain versions (the
# batched amax-in entry); adafactor's factored moments over expert
# leaves split on dim 0 (experts) and on dims 1 / 2 (d_ff)
TRAIN_CASES = {
    "ep": (8, "qdq", "adafactor",
           dict(FP4, mesh_shape=(1, 2), telemetry=True), 2),
    "tp": (3, "pallas", "adafactor", dict(FP4, mesh_shape=(1, 2)), 2),
    # a data axis as well: fp8's token groups (a rank's expert buffer of
    # 4 groups x 20 slots = 80 rows would straddle paper_fp4's 128-row
    # wgrad blocks, which raises)
    "ep_2x2": (8, "pallas", "adamw",
               dict(FP4, recipe="fp8", mesh_shape=(2, 2)), 2),
}

# the port's own (1, 2) run with the attention's heads whole on both
# ranks (the experts alone split), against the port's one process
PORT_CASES = {
    "ep_heads": (8, "qdq", "adafactor",
                 dict(FP4, mesh_shape=(1, 2), telemetry=True,
                      whole_heads=True), 2),
}
# name -> the one-process run it is held to (the same config, no mesh)
ONE_OF = {"ep": "ep", "tp": "tp", "ep_heads": "ep"}


def _update_rel(got, want, init):
    """The L2 norm of ``got - want`` over that of ``want``'s update from
    ``init`` (param lists)."""
    diff = sum(float(((a - b).astype(np.float64) ** 2).sum())
               for a, b in zip(got, want)) ** 0.5
    upd = sum(float(((b - c).astype(np.float64) ** 2).sum())
              for b, c in zip(want, init)) ** 0.5
    return diff / max(upd, 1e-30)


REF = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from repro.configs.base import TrainConfig
    from repro.configs.olmoe_1b_7b import REDUCED
    from repro.data.pipeline import SyntheticLM
    from repro.models import build_model
    from repro.train.trainer import Trainer
    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    res = {}
    for name, (experts, _impl, opt, over, steps) in cases.items():
        cfg = REDUCED.replace(dtype="float32", optimizer=opt,
                              moe=dataclasses.replace(
                                  REDUCED.moe, num_experts=experts))
        kw = dict(total_steps=steps, log_every=0, **over)
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
        tr = Trainer(build_model(cfg), TrainConfig(**kw),
                     SyntheticLM(cfg.vocab_size, kw["seq_len"],
                                 kw["global_batch"]))
        st = tr.train(tr.init_state())
        np.savez(os.path.join(out_dir, name + ".npz"),
                 *[np.asarray(v) for v in jax.tree.leaves(st.params)])
        res[name] = {"loss": [r["loss"] for r in tr.history],
                     "grad_norm": [r["grad_norm"] for r in tr.history],
                     "rows": [{k: float(v) for k, v in r.items()
                               if k.startswith("tel/")}
                              for r in tr.history]}
    print(json.dumps(res))
""")


def _jcfg(experts):
    from repro.configs.olmoe_1b_7b import REDUCED
    return REDUCED.replace(dtype="float32", moe=dataclasses.replace(
        REDUCED.moe, num_experts=experts))


def _tcfg(experts):
    cfg = importlib.import_module("repro_torch.configs.olmoe_1b_7b").REDUCED
    return cfg.replace(dtype="float32", moe=dataclasses.replace(
        cfg.moe, num_experts=experts))


# the (1, 2) cases checkpoint their last step: a checkpoint holds full
# arrays, gathered from expert leaves split on dim 0 and on dims 1 / 2
CKPT_CASES = ("ep", "tp")


def _port_over(name, tmp, mesh=True):
    """``torch_dist_workers._tiny_trainer``'s fields of case ``name``
    (without its mesh: one process restoring its checkpoint)."""
    e, impl, opt, over, steps = {**TRAIN_CASES, **PORT_CASES}[name]
    over = dict(over, arch=ARCH, model=dict(linear_impl=impl, experts=e,
                                            optimizer=opt))
    if name in CKPT_CASES:
        over.update(checkpoint_every=steps,
                    checkpoint_dir=str(tmp / f"ckpt_{name}"))
    if not mesh:
        over.pop("mesh_shape")
        over.pop("whole_heads", None)
    return over


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rows (a subprocess on 2 forced CPU devices) and
    the 2 ranks' results; the init both start from."""
    tmp = tmp_path_factory.mktemp("moe_axis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, str(tmp), json.dumps(TRAIN_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        inits = {name: jax.tree.map(np.asarray, j_build(_jcfg(e)).init(
                     jax.random.PRNGKey(0), jnp.float32))
                 for name, (e, *_) in TRAIN_CASES.items()}
        inits["ep_heads"] = inits["ep"]
        train = {name: (name, _port_over(name, tmp), steps) for name, (
            *_, steps) in {**TRAIN_CASES, **PORT_CASES}.items()}
        two = [c for n, c in train.items() if n != "ep_2x2"]
        ranks = start_ranks("moe_axis", 2, tmp, SUBLAYER_CASES, two, inits)
        ranks4 = start_ranks("train_cases", 4, tmp / "four",
                             [train["ep_2x2"]], inits["ep_2x2"])
        one = {name: _one_process(name, tmp, inits[name])
               for name in set(ONE_OF.values())}
        ranks, ranks4 = ranks(), ranks4()
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), ranks, tmp, ranks4, \
        one, inits


def _one_process(name, tmp, init):
    """Case ``name``'s config trained in this process on the whole batch
    from ``init`` (a reference numpy tree): (losses, params)."""
    over = _port_over(name, tmp, mesh=False)
    over.pop("checkpoint_every", None)
    over.pop("checkpoint_dir", None)
    tr = _tiny_trainer(over, steps=TRAIN_CASES[name][-1])
    st = tr.train(tr.init_state(params=params_from_jax(init,
                                                       tr.model.cfg)))
    return ([h["loss"] for h in tr.history],
            [t.detach().numpy() for t in tree_leaves(st.params)])


def _init_leaves(runs, name):
    """Case ``name``'s init as the port's leaves."""
    experts = {**TRAIN_CASES, **PORT_CASES}[name][0]
    return [t.numpy() for t in tree_leaves(params_from_jax(
        runs[5][name], _tcfg(experts)))]


def _slice(want, got, rank, key, ep):
    """The rank's block of one process's gradient ``want`` of ``key``."""
    if got.shape == want.shape:
        return want
    if ep:
        n = got.shape[0]
        return want[rank * n:(rank + 1) * n]
    return np.split(want, 2, axis=1 if key == "w_down" else 2)[rank]


@pytest.mark.parametrize("name", [c[0] for c in SUBLAYER_CASES
                                  if c[0].startswith("ep")])
def test_expert_parallel_sublayer_bitwise(name, runs):
    """Expert parallelism on 2 ranks: each rank's MoE output, input
    cotangent and router gradient are one process's bit for bit, its
    expert gradients the same experts' slice of one process's; the
    control (each rank's combine over its own experts) misses; the
    forward gathers the expert outputs once (``ep_fwd``) and the backward
    the experts' input cotangents once (``ep_bwd``), in the compute
    dtype."""
    for rank, r in enumerate(runs[1]):
        case = r["sublayer"][name]
        assert case["ep"]
        labels = ["y", "dx"] + case["keys"]
        for lab, got, want in zip(labels, case["split"], case["whole"]):
            want = _slice(want, got, rank, lab, True)
            assert got.shape == want.shape, (name, lab)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {lab}")
        assert not np.array_equal(case["partial"][0], case["whole"][0])
        recs = [CollectiveRecord(**c) for c in case["census"]]
        assert [(c.tag, c.op) for c in recs] == [
            ("ep_fwd", "all-gather"), ("ep_bwd", "all-gather")]
        dtype = "float32" if "f32" in name else "bfloat16"
        census, findings = qlint.audit_comms(recs, expect_fp8=False,
                                             compute_dtype=dtype)
        assert findings == [] and census["ep_ops"] == {"ep_fwd": 1,
                                                       "ep_bwd": 1}
        bad, found = qlint.audit_comms(
            recs, expect_fp8=False,
            compute_dtype="bfloat16" if dtype == "float32" else "float32")
        assert len(found) == 2


def test_expert_tensor_parallel_sublayer(runs):
    """3 experts on 2 ranks: d_ff split inside every expert (column-
    parallel gate / up, row-parallel down, the block and tile groups
    along d_ff maxed over both ranks): output, input cotangent and router
    gradient within ``SUBLAYER_TOL`` of one process, each expert leaf's
    gradient its d_ff block; the sums and the shared amax travel as
    ``tp_fwd`` / ``tp_bwd`` / ``amax_model``."""
    for rank, r in enumerate(runs[1]):
        case = r["sublayer"]["tp_f32_pallas"]
        assert not case["ep"]
        labels = ["y", "dx"] + case["keys"]
        for lab, got, want in zip(labels, case["split"], case["whole"]):
            want = _slice(want, got, rank, lab, False)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=SUBLAYER_TOL * np.abs(want).max(),
                err_msg=lab)
        tags = {c["tag"] for c in case["census"]}
        assert tags == {"tp_fwd", "tp_bwd", "amax_model"}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_moe_trainer_matches_reference(name, runs):
    """olmoe-1b-7b ``REDUCED`` on a (1, 2) mesh of 2 gloo ranks, 8
    experts (4 a rank, telemetry on) and 3 experts (d_ff split in each),
    both under adafactor, and 8 experts on a (2, 2) mesh of 4 (AdamW), against the reference's
    ``Trainer`` on as many forced devices from the same init: every
    rank's rows and params equal;
    per-step loss and grad norm and the final params within ``FP4_TOL``;
    each leaf's block the rules' slice; the step's collectives audit
    clean (the expert gathers by layer, or the row-parallel sums); the
    (1, 2) runs' checkpoints hold the full arrays."""
    ref, ranks, out_dir, ranks4 = runs[:4]
    ranks = ranks4 if name == "ep_2x2" else ranks
    got = ranks[0][name]
    for r in ranks[1:]:
        assert [h["loss"] for h in r[name]["history"]] == \
            [h["loss"] for h in got["history"]]
        for a, b in zip(r[name]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    experts, _, _, over, _ = TRAIN_CASES[name]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   ref[name][key], rtol=FP4_TOL[key],
                                   err_msg=f"{name} {key}")
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    cfg = _tcfg(experts)
    specs = build_model(cfg, "meta").param_specs()
    mesh = over["mesh_shape"]
    sizes = dict(zip(("data", "model"), mesh))
    rules = default_rules(AbstractMesh(mesh, ("data", "model")), cfg)
    want_local = []
    for sp in spec_leaves(specs):
        shape = list(sp.shape)
        for d, names in rules.param_sharding(sp).dim_axes().items():
            for a in names:
                shape[d] //= sizes[a]
        want_local.append(tuple(shape))
    assert got["local_shapes"] == want_local
    assert want_local != [tuple(sp.shape) for sp in spec_leaves(specs)]
    census, findings = qlint.audit_comms(got["census"], expect_fp8=False,
                                         compute_dtype="float32")
    assert findings == []
    if name.startswith("ep"):
        # a layer's gather again in its remat recompute
        assert census["ep_ops"] == {"ep_fwd": 4, "ep_bwd": 2}
        assert set(census["ep_bytes_by_layer"]["ep_fwd"]) == {"L0", "L1"}
    else:
        assert census["tp_sums"] > 0 and census["amax_model_ops"] > 0
        assert not census["ep_ops"]
    if name == "ep_2x2":     # the token groups shared over the data axis
        assert census["amax_allreduces"] > 0
    if name in CKPT_CASES:
        # a trainer with no mesh restores the ranks' gathered params and
        # adafactor factors bit for bit
        back = _tiny_trainer(_port_over(name, out_dir, mesh=False),
                             steps=TRAIN_CASES[name][-1]).resume()
        assert back.step == TRAIN_CASES[name][-1]
        for a, b in zip(got["params"], tree_leaves(back.params)):
            np.testing.assert_array_equal(a, b.numpy())
        factors = tree_leaves([back.opt_state.vr, back.opt_state.vc])
        assert len(got["mu"]) == len(factors)
        for a, b in zip(got["mu"], factors):
            np.testing.assert_array_equal(a, b.numpy())
    # the final params against the reference's, from the same init
    like = j_build(_jcfg(experts)).abstract_params()
    want = np.load(out_dir / f"{name}.npz")
    want = params_from_jax(jax.tree.unflatten(
        jax.tree.structure(like),
        [want[f"arr_{i}"] for i in range(len(want.files))]), cfg)
    want = [b.numpy() for b in tree_leaves(want)]
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=FP4_TOL["params"],
                                   err_msg=name)
    # the update itself, over its own size
    rel = _update_rel(got["params"], want, _init_leaves(runs, name))
    assert rel <= UPDATE_RTOL[name], (name, rel)


@pytest.mark.parametrize("name", list(ONE_OF))
def test_moe_trainer_matches_one_process(name, runs):
    """The port's (1, 2) runs against its own one process on the whole
    batch from the same init.  With the heads whole on both ranks
    (``ep_heads``: the experts alone split, the MoE sublayer one
    process's bits) the forward is one process's: every loss within
    1e-6 (step 0's equal), the update and each param within
    ``ONE_TOL``; with the attention split as well (``ep``) or d_ff split
    inside every expert (``tp``) the row-parallel sums change the
    forward's summation order: step 0's loss and the update within
    ``ONE_TOL``."""
    got = runs[1][0][name]
    losses, params = runs[4][ONE_OF[name]]
    have = [h["loss"] for h in got["history"]]
    rel = _update_rel(got["params"], params, _init_leaves(runs, name))
    assert rel <= ONE_TOL[name], (name, rel)
    if name == "ep_heads":
        assert have[0] == losses[0]
        np.testing.assert_allclose(have, losses, rtol=1e-6)
        for a, b in zip(got["params"], params):
            np.testing.assert_allclose(a, b, rtol=0, atol=ONE_TOL["params"])
    else:
        assert abs(have[0] - losses[0]) <= ONE_TOL["loss"] * abs(losses[0])


def test_expert_parallel_telemetry_matches_reference(runs):
    """The expert-parallel run's step-0 telemetry rows: the keys and tap
    counts equal the reference's, the forward-side stats (each rank's 4
    experts' means summed over both ranks over 8) and the rest within
    ``TEL_RTOL``, the backward-side rates within 5e-4."""
    ref, ranks = runs[:2]
    got = {k: v for k, v in ranks[0]["ep"]["history"][0].items()
           if k.startswith("tel/")}
    want = ref["ep"]["rows"][0]
    assert set(got) == set(want) and want
    misses = []
    for k, w in want.items():
        stat, have = k.rsplit("/", 1)[1], float(got[k])
        if stat == "taps":
            ok = have == w
        elif stat in ("clip", "underflow") and k.startswith("tel/bwd/"):
            ok = abs(have - w) <= 5e-4
        else:
            ok = abs(have - w) <= TEL_RTOL * abs(w) + 1e-9
        if not ok:
            misses.append((k, have, w))
    assert not misses, misses[:10]
    assert any("/moe/" in k and "/fwd_w/" in k for k in got)
    for r in ranks[1:]:
        assert {k: v for k, v in r["ep"]["history"][0].items()
                if k.startswith("tel/")} == got
