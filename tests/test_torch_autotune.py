"""The port's tuning table (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``) on the same inputs, on the CPU.

Held bitwise: key strings over a grid of dims, dtypes, modes, trans
pairs and blocks; table files (either package loads the other's, equal
entries save to byte-equal JSON); ``validate_table``'s error lists on
both committed tables and on crafted bad ones; ``resolve_tiles`` and
``COUNTERS`` in lockstep over hits, misses and ``set_table`` swaps,
but for the one documented difference (a tile the port's kernels are
not built for, 384 or 512, is a hit in the reference and a miss here);
the key a ragged call resolves (the port masks, the reference pads
first); the keys one training step resolves.  Then the port's own
rule: a table hit reaches the kernel wrapper and is bitwise equal to a
miss, partial explicit tiles skip the table, an unbuilt explicit tile
raises.  Shapes stay at 256-384, the reference's own tests' size.
"""
import importlib
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.quantize import QuantSpec as JSpec  # noqa: E402
from repro.core.recipe import PrecisionPlan as JPlan  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.kernels import autotune as ja  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import train_step as j_step  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.quantize import QuantSpec  # noqa: E402
from repro_torch.core.recipe import PrecisionPlan  # noqa: E402
from repro_torch.kernels import autotune as ta  # noqa: E402
from repro_torch.kernels import fp4_matmul as fm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.build import TILINGS  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train.train_step import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

# the module (``repro.kernels`` exports a function of the same name)
j_fm = importlib.import_module("repro.kernels.fp4_matmul")
F32, BF16 = ("float32", "float32"), ("bfloat16", "bfloat16")


@pytest.fixture(autouse=True)
def _restore_tables():
    """Every test swaps both process-wide tables; re-arm the lazy JSON
    loads afterwards."""
    yield
    ja.set_table(None)
    ta.set_table(None)


def _tables(entries):
    """The same table in both packages: entries key -> (bm, bn, bk)."""
    out = []
    for mod in (ja, ta):
        t = mod.TuningTable()
        for key, tiles in entries.items():
            t.record(key, *tiles, 1.5)
        out.append(t)
    return out


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_tuning_key_matches_reference(trans, block):
    for m, n, k in ((256, 384, 256), (8192, 3072, 768), (128, 1024, 3456)):
        for dtypes in (F32, BF16, ("float32", "bfloat16")):
            for modes in (("block", "tile"), ("pass", "pass"),
                          ("token", "token"), ("block", "block"),
                          ("tile", "pass")):
                want = ja.tuning_key(m, n, k, dtypes, modes, trans, block)
                assert ta.tuning_key(m, n, k, dtypes, modes, trans,
                                     block) == want
                assert ta._KEY_RE.match(want)


def test_tables_cross_load_and_save_byte_equal(tmp_path):
    entries = {ja.tuning_key(256, 384, 256, BF16, ("block", "tile"),
                             (False, True)): (128, 128, 128),
               ja.tuning_key(256, 256, 384, F32, ("token", "token"),
                             (True, False)): (256, 128, 128)}
    jt, tt = _tables(entries)
    for t in (jt, tt):
        t.meta = {"note": "same"}
    jt.save(tmp_path / "ref.json")
    tt.save(tmp_path / "port.json")
    assert (tmp_path / "ref.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    # either package loads the other's file
    assert ta.TuningTable.load(tmp_path / "ref.json").entries == jt.entries
    assert ja.TuningTable.load(tmp_path / "port.json").entries == tt.entries
    for key, tiles in entries.items():
        assert ta.TuningTable.load(tmp_path / "ref.json").lookup(key) == \
            ja.TuningTable.load(tmp_path / "port.json").lookup(key) == tiles


def _bad_tables(tmp_path):
    """Crafted tables, each with the problem its name says."""
    key = ja.tuning_key(256, 256, 256, F32, ("block", "tile"),
                        (False, False))
    out = {}
    t = ja.TuningTable()
    t.record(key, 96, 256, 128, us=3.5)          # 96 not a block multiple
    t.record("not a key", 128, 128, 128, us=1.0)  # malformed key
    t.record(ja.tuning_key(256, 256, 256, F32, ("block", "block"),
                           (False, False)), 512, 128, 128, us=1.0)
    out["three_errors"] = t
    t = ja.TuningTable()
    t.record(ja.tuning_key(384, 384, 384, BF16, ("pass", "pass"),
                           (False, True)), 256, 128, 128, us=2.0)
    out["non_dividing"] = t
    t = ja.TuningTable()
    t.record(key, 128, 128, 128, us=0.0)
    out["non_positive_us"] = t
    paths = {}
    for name, table in out.items():
        paths[name] = tmp_path / f"{name}.json"
        table.save(paths[name])
    raw = {"schema_wrong": {"schema": "other.v0", "entries": {}},
           "entries_empty": {"schema": ja.SCHEMA, "entries": {}},
           "entry_malformed": {"schema": ja.SCHEMA,
                               "entries": {key: {"bm": 128, "bn": 128}}}}
    for name, payload in raw.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(payload))
    paths["not_json"] = tmp_path / "not_json.json"
    paths["not_json"].write_text("{not json")
    paths["absent"] = tmp_path / "absent.json"
    return paths


@pytest.mark.parametrize("which", [
    "reference_committed", "port_committed", "three_errors", "non_dividing",
    "non_positive_us", "schema_wrong", "entries_empty", "entry_malformed",
    "not_json", "absent"])
def test_validate_table_matches_reference(tmp_path, which):
    path = {"reference_committed": ja.DEFAULT_TABLE_PATH,
            "port_committed": ta.DEFAULT_TABLE_PATH}.get(which)
    if path is None:
        path = _bad_tables(tmp_path)[which]
    want = ja.validate_table(path)
    assert ta.validate_table(path) == want
    assert bool(want) == (which not in ("reference_committed",
                                         "port_committed"))
    if which == "absent":
        assert want and want[0].startswith("unreadable table")


def test_port_committed_table_is_the_cards():
    """The committed table is valid, names the card it was measured on and
    holds only tilings the kernels are built for."""
    assert ta.validate_table(ta.DEFAULT_TABLE_PATH) == []
    table = ta.TuningTable.load(ta.DEFAULT_TABLE_PATH)
    assert table.meta["backend"] == "cuda" and "H100" in table.meta["card"]
    assert "--autotune" in table.meta["command"]
    assert {table.lookup(k) for k in table.entries} <= set(TILINGS)
    assert ta.DEFAULT_TABLE_PATH != ja.DEFAULT_TABLE_PATH


def _both_resolve(m, n, k, dtypes, modes, trans):
    got = []
    for mod in (ja, ta):
        before = dict(mod.COUNTERS)
        tiles = mod.resolve_tiles(m, n, k, dtypes=dtypes, modes=modes,
                                  trans=trans)
        got.append((tiles, {c: mod.COUNTERS[c] - before[c]
                            for c in before}))
    return got


def test_resolve_tiles_and_counters_in_lockstep():
    """Hits, misses (absent key, tiles that do not divide), cached
    repeats (no count) and ``set_table`` swaps (the cache dropped): the
    same tiles and the same counter moves in both packages."""
    nn, tn = (False, False), (True, False)
    k1 = ja.tuning_key(256, 256, 256, BF16, ("block", "tile"), nn)
    k2 = ja.tuning_key(384, 256, 384, BF16, ("token", "token"), tn)
    k3 = ja.tuning_key(384, 384, 384, F32, ("block", "tile"), nn)
    first = {k1: (256, 128, 128), k2: (128, 256, 128),
             k3: (256, 128, 128)}                 # k3 does not divide
    calls = [(256, 256, 256, BF16, ("block", "tile"), nn),
             (384, 256, 384, BF16, ("token", "token"), tn),
             (384, 384, 384, F32, ("block", "tile"), nn),
             (256, 256, 384, BF16, ("block", "tile"), nn),    # absent
             (256, 256, 256, BF16, ("block", "tile"), nn)]    # cached
    for table in (first, {k1: (128, 256, 128)}, {}):
        jt, tt = _tables(table)
        ja.set_table(jt)
        ta.set_table(tt)
        for call in calls:
            want, got = _both_resolve(*call)
            assert got == want, (table, call)
    # and the moves themselves: two hits and a miss on the first table's
    # first three calls were seen (not only equal)
    jt, tt = _tables(first)
    ja.set_table(jt)
    ta.set_table(tt)
    seen = [_both_resolve(*c)[1] for c in calls]
    assert [s[0] for s in seen] == [(256, 128, 128), (128, 256, 128), None,
                                    None, (256, 128, 128)]
    assert [s[1] for s in seen] == [{"hit": 1, "miss": 0}] * 2 + \
        [{"hit": 0, "miss": 1}] * 2 + [{"hit": 0, "miss": 0}]


@pytest.mark.parametrize("tiles", [(384, 128, 128), (512, 512, 128),
                                   (128, 128, 256), (256, 256, 128)])
def test_unbuilt_tile_is_a_hit_in_the_reference_and_a_miss_here(tiles):
    """The documented difference: a tiling valid for the reference (a
    multiple of the block that divides the dims) that the port's kernels
    are not built for."""
    m = n = k = 1536                   # divisible by 128, 256, 384, 512
    key = ja.tuning_key(m, n, k, BF16, ("block", "tile"), (False, False))
    jt, tt = _tables({key: tiles})
    ja.set_table(jt)
    ta.set_table(tt)
    (want, jmove), (got, tmove) = _both_resolve(
        m, n, k, BF16, ("block", "tile"), (False, False))
    assert want == tiles and jmove == {"hit": 1, "miss": 0}
    assert got is None and tmove == {"hit": 0, "miss": 1}


def _spy(monkeypatch, mod):
    """Record the arguments of every ``mod.resolve_tiles`` call."""
    seen, orig = [], mod.resolve_tiles

    def spy(m, n, k, *, dtypes, modes, trans, block=128):
        seen.append((m, n, k, tuple(dtypes), tuple(modes), tuple(trans),
                     block))
        return orig(m, n, k, dtypes=dtypes, modes=modes, trans=trans,
                    block=block)
    spy.cache_clear = orig.cache_clear
    monkeypatch.setattr(mod, "resolve_tiles", spy)
    return seen


RAGGED = [((130, 200, 96), "block", "tile", (False, False)),
          ((300, 384, 960), "token", "token", (False, True)),
          ((256, 130, 330), "block", "block", (True, False)),
          ((96, 3392, 256), "pass", "pass", (True, True))]


@pytest.mark.parametrize("mkn,mode_a,mode_b,trans", RAGGED)
def test_ragged_call_keys_as_the_reference_ops_path(monkeypatch, mkn,
                                                    mode_a, mode_b, trans):
    """A ragged call (h2o's N = 960, llama-1b's d_ff 3392 among them)
    resolves the key the reference's ``ops.pallas_qmm`` resolves after its
    padding: one pair's dims rounded up to the block.  The reference's
    kernel is stubbed (only its lookup matters here)."""
    (m, k, n), (ta_, tb_) = mkn, trans
    rng = np.random.default_rng(0)
    a = rng.standard_normal((k, m) if ta_ else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if tb_ else (k, n)).astype(np.float32)
    fmt = {"pass": "bf16", "token": "fp8_e4m3"}.get(mode_a, "fp4_e2m1")
    spec = f"{fmt}@block128" if mode_a != "pass" else "bf16"
    jseen = _spy(monkeypatch, ja)
    monkeypatch.setattr(j_fm, "_fused_qmm", lambda a_, b_, **kw: jnp.zeros(
        (a_.shape[kw["trans_a"]], b_.shape[1 - kw["trans_b"]])))
    j_ops.pallas_qmm(jnp.asarray(a), jnp.asarray(b), JSpec.from_str(spec),
                     JSpec.from_str(spec), mode_a=mode_a, mode_b=mode_b,
                     trans_a=ta_, trans_b=tb_)
    tseen = _spy(monkeypatch, ta)
    ops.pallas_qmm(torch.from_numpy(a), torch.from_numpy(b),
                   QuantSpec.from_str(spec), QuantSpec.from_str(spec),
                   mode_a=mode_a, mode_b=mode_b, trans_a=ta_, trans_b=tb_)
    assert tseen == jseen and len(jseen) == 1
    assert tseen[0][:3] == tuple(-(-d // 128) * 128 for d in (m, n, k))


def test_training_step_resolves_the_references_keys(monkeypatch):
    """One paper_fp4 training step of ``tiny`` (2 layers, f32, both
    impls "pallas", unrolled, remat on): the set of lookups equals the
    reference's (its step traced with ``jax.make_jaxpr``, its
    ``resolve_tiles`` spied), fwd, dgrad and wgrad on both routes."""
    kw = dict(dtype="float32", linear_impl="pallas", attention_impl="pallas",
              scan_layers=False, n_layers=2)
    jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(**kw)
    tcfg = importlib.import_module(
        "repro_torch.configs.tiny").CONFIG.replace(**kw)
    jp = JPlan.uniform(J_RECIPES["paper_fp4"], 2)
    tp = PrecisionPlan.from_dict(jp.to_dict())
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 65))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    j_tcfg = JTrainConfig(total_steps=8, global_batch=2, seq_len=64)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    fn = j_step.make_train_step(jm, j_tcfg, jp, jit=False, donate=False)
    jseen = _spy(monkeypatch, ja)
    jax.make_jaxpr(fn)(params, j_step.make_optimizer(jm, j_tcfg).init(params),
                       jnp.zeros((), jnp.float32),
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.zeros((), jnp.int32), jnp.ones((), jnp.float32))
    tm = t_build(tcfg, "cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    t_tcfg = TrainConfig(total_steps=8, global_batch=2, seq_len=64)
    step = make_train_step(tm, t_tcfg, tp)
    tseen = _spy(monkeypatch, ta)
    with ta.recording() as jobs:
        step(tparams, make_optimizer(tm, t_tcfg).init(tparams), None,
             {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert set(tseen) == set(jseen)
    assert {(m, n, k) for m, n, k, *_ in jseen} >= {(128, 128, 128)}
    assert {t[5] for t in jseen} >= {(False, False), (False, True),
                                     (True, False)}
    # the record of the calls holds every key resolved, once
    assert set(jobs) == {ta.tuning_key(*t) for t in tseen}
    # a table of those keys: every lookup of the next step hits
    tt = ta.TuningTable()
    for key in jobs:
        tt.record(key, 128, 128, 128, 1.0)
    ta.set_table(tt)
    before = dict(ta.COUNTERS)
    step(tparams, make_optimizer(tm, t_tcfg).init(tparams), None,
         {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert ta.COUNTERS["miss"] == before["miss"]
    assert ta.COUNTERS["hit"] - before["hit"] == len(jobs)


def _operands(m, k, n, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                             ).to(dtype),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * 0.05).to(dtype))


@pytest.mark.parametrize("tiles", TILINGS[1:])
@pytest.mark.parametrize("modes,pipeline", [(("block", "tile"), "stream"),
                                            (("token", "token"), "two_pass"),
                                            (("block", "tile"), "two_pass")])
def test_table_tiling_reaches_the_wrapper_and_is_bitwise(monkeypatch, tiles,
                                                         modes, pipeline):
    """A table hit is consulted (the hit counter grows), applied (the
    kernel wrapper receives its (bm, bn)) and bitwise equal to a miss
    (128 x 128), on both routes; stats too."""
    m = n = k = 256
    a, b = _operands(m, k, n, torch.bfloat16)
    wrapper = "qmm_stream" if pipeline == "stream" else "tiled_mm"
    applied, orig = [], getattr(fm, wrapper)

    def spy(*args, **kw):
        applied.append((kw["bm"], kw["bn"]))
        return orig(*args, **kw)
    monkeypatch.setattr(fm, wrapper, spy)
    kw = dict(a_mode=modes[0], b_mode=modes[1], a_fmt="fp8_e4m3",
              b_fmt="fp4_e2m1", pipeline=pipeline, collect_stats=True)
    ta.set_table(ta.TuningTable())
    y_miss, st_miss = fm.fused_qmm(a, b, **kw)
    assert applied[-1] == (128, 128)
    key = ta.tuning_key(m, n, k, BF16, modes, (False, False))
    ta.set_table(_tables({key: tiles})[1])
    hits = ta.COUNTERS["hit"]
    y_hit, st_hit = fm.fused_qmm(a, b, **kw)
    assert ta.COUNTERS["hit"] == hits + 1, "table was not consulted"
    assert applied[-1] == tiles[:2], "table tiling was not applied"
    assert torch.equal(y_hit.view(torch.int16), y_miss.view(torch.int16))
    for s_hit, s_miss in zip(st_hit, st_miss):
        assert torch.equal(s_hit, s_miss)


def test_partial_explicit_tiles_skip_the_table(monkeypatch):
    """Any explicit tile disables the lookup (explicit wins), and the rest
    take 128."""
    m = n = k = 256
    a, b = _operands(m, k, n)
    applied, orig = [], fm.qmm_stream

    def spy(*args, **kw):
        applied.append((kw["bm"], kw["bn"]))
        return orig(*args, **kw)
    monkeypatch.setattr(fm, "qmm_stream", spy)
    key = ta.tuning_key(m, n, k, F32, ("block", "tile"), (False, False))
    ta.set_table(_tables({key: (128, 256, 128)})[1])
    ta.resolve_tiles.cache_clear()
    before = dict(ta.COUNTERS)
    fm.fused_qmm(a, b, a_mode="block", b_mode="tile", bm=256)
    assert dict(ta.COUNTERS) == before, "partial tiles must skip the lookup"
    assert applied == [(256, 128)]
    fm.fused_qmm(a, b, a_mode="block", b_mode="tile")
    assert applied[-1] == (128, 256)


@pytest.mark.parametrize("tiles", [dict(bm=384), dict(bm=256, bn=256),
                                   dict(bk=256), dict(bm=64, bn=128,
                                                      bk=128)])
def test_explicit_unbuilt_tiling_raises(tiles):
    a, b = _operands(256, 256, 256)
    with pytest.raises(ValueError, match="no kernel is built"):
        fm.fused_qmm(a, b, a_mode="block", b_mode="tile", **tiles)


def test_batched_call_keys_on_one_pair():
    """A 3-D (expert) call looks up one pair's dims, as the reference's
    ``jax.vmap`` over ``fused_qmm`` does."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((3, 130, 256))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 256, 384))
                         .astype(np.float32))
    tiles, key = fm.resolve_qmm_tiles(a, b, "block", "tile", False, False)
    assert key == ja.tuning_key(256, 384, 256, F32, ("block", "tile"),
                                (False, False))
    assert tiles == (128, 128, 128)
    with ta.recording() as jobs:
        y = fm.fused_qmm(a, b, a_mode="block", b_mode="tile")
    assert y.shape == (3, 130, 384)
    assert jobs[key]["batch"] == 3 and jobs[key]["m"] == 130


def test_cli_validate_matches_reference(tmp_path):
    """``python -m repro_torch.kernels.autotune --validate PATH``: exit 0
    and the entry count on the committed table; exit 1 and one FAIL line
    per reference error on a bad one."""
    import os
    import subprocess
    import sys
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH")) if p)}
    bad = _bad_tables(tmp_path)["three_errors"]
    for path, rc in ((ta.DEFAULT_TABLE_PATH, 0), (bad, 1)):
        out = subprocess.run([sys.executable, "-m",
                              "repro_torch.kernels.autotune", "--validate",
                              str(path)], capture_output=True, text=True,
                             env=env, timeout=300)
        assert out.returncode == rc, out.stderr
        want = [f"FAIL {e}" for e in ja.validate_table(path)]
        got = [ln for ln in out.stdout.splitlines() if ln.startswith("FAIL")]
        assert got == want
        if rc == 0:
            n = len(ta.TuningTable.load(path).entries)
            assert f"{n} entries valid" in out.stdout


def test_training_jobs_do_not_depend_on_depth():
    """``--autotune``'s jobs: one launch/train.py step (tiny here, on the
    CPU) records a job per key, each job's dims key back to its key, and
    one layer gives the keys of two (TRAIN_JOBS runs one layer)."""
    argv = ("--arch", "tiny", "--recipe", "paper_fp4", "--linear-impl",
            "pallas", "--attention-impl", "pallas", "--batch", "2",
            "--seq", "128")
    one = ta.training_jobs(argv, n_layers=1, device="cpu")
    two = ta.training_jobs(argv, n_layers=2, device="cpu")
    assert set(one) == set(two) and len(one) >= 4
    for key, job in one.items():
        dims = (-(-job[d] // 128) * 128 for d in ("m", "n", "k"))
        assert ta.tuning_key(*dims, (job["dtype"],) * 2,
                             (job["a_mode"], job["b_mode"]),
                             (job["trans_a"], job["trans_b"])) == key
    assert {j["pipeline"] for j in one.values()} == {"stream", "two_pass"}
