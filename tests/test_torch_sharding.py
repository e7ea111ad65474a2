"""Parity of the port's sharding rules, meshes and elastic helpers
(``repro_torch.distributed``) with the JAX reference.

Bar: bitwise (spec tuples equal ``tuple(PartitionSpec)``) for every
arch in ``ARCHS`` on device-free meshes of the production sizes —
params, AdamW and Adafactor state, serving caches and the batch —
and for ``dp_axes`` / ``dp_size`` / ``manual_over``,
``choose_mesh_shape`` over 1-512 devices and ``make_mesh`` /
``axis_types`` errors, message for message.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs.base import ARCHS, get_config as j_get_config  # noqa
from repro.distributed import elastic as j_elastic  # noqa: E402
from repro.distributed import mesh as j_mesh  # noqa: E402
from repro.distributed.sharding import default_rules as j_rules  # noqa
from repro.distributed.sharding import opt_state_shardings as j_opt_sh  # noqa
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.train.train_step import \
    compression_state_sharding as j_comp_sh  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.distributed import AbstractMesh, default_rules  # noqa
from repro_torch.distributed import elastic, opt_state_shardings  # noqa
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.nn.params import map_specs  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.train.train_step import \
    compression_state_sharding as t_comp_sh  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

MESHES = {(1,): ("data",), (4, 1): ("data", "model"),
          (2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key(k) for k in path): tuple(sh.spec)
            for path, sh in flat}


def _port_specs(tree, prefix="") -> dict:
    """{path: spec tuple} of a tree (dicts, lists, NamedTuples) of the
    port's Shardings, with the reference's path strings."""
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return {prefix: tuple(tree.spec)}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _meshes(shape):
    axes = MESHES[shape]
    return JAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """Params (fsdp on and off), AdamW and Adafactor state, the batch and
    the serving cache, on every mesh."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jm, tm = j_build(jcfg), build_model(tcfg, "meta")
    jspecs, tspecs = jm.param_specs(), tm.param_specs()
    j_abs = jm.abstract_params()
    t_meta = map_specs(lambda s: torch.empty(s.shape, device="meta"),
                       tspecs)
    j_cache = j_build(jcfg.replace(scan_layers=False)).cache_spec(16, 8)
    t_cache = tm.init_cache(16, 8)
    for shape in MESHES:
        jmesh, tmesh = _meshes(shape)
        for fsdp in (True, False):
            jr, tr = (j_rules(jmesh, jcfg, fsdp=fsdp),
                      default_rules(tmesh, tcfg, fsdp=fsdp))
            jp, tp = jr.param_shardings(jspecs), tr.param_shardings(tspecs)
            assert _port_specs(tp) == _ref_specs(jp), (shape, fsdp)
            if not fsdp or jr.dp_size == 1:    # the residuals' layout
                assert _port_specs(t_comp_sh(tr, tp)) == _ref_specs(
                    j_comp_sh(jr, jp)), (shape, fsdp)
        assert tuple(tr.batch_sharding(2).spec) == \
            tuple(jr.batch_sharding(2).spec)
        assert tuple(tr.replicated().spec) == tuple(jr.replicated().spec)
        for opt in ("adamw", "adafactor"):
            jo = j_get_optimizer(opt)
            j_state = jax.eval_shape(jo.init, j_abs)
            t_state = get_optimizer(opt).init(t_meta)
            assert _port_specs(opt_state_shardings(
                t_state, t_meta, tp, tmesh)) == _ref_specs(
                j_opt_sh(j_state, j_abs, jp, jmesh)), (shape, opt)
        assert _port_specs(tr.cache_shardings(t_cache)) == _ref_specs(
            jr.cache_shardings(j_cache)), shape


def test_activation_and_dp_structure():
    """``activation_sharding`` on the model's hint names, ``dp_axes`` /
    ``dp_size``, ``manual_over`` and ``seq_parallel`` / overrides."""
    cfg_j, cfg_t = j_get_config("llama-1b"), get_config("llama-1b")
    hints = [(("batch", "seq", "embed"), (32, 2048, 2048)),
             (("batch", "seq", "mlp"), (32, 2048, 8192)),
             (("batch", "heads", "seq_q", None), (32, 32, 2048, 64)),
             (("batch", "seq", "kv_heads", None), (32, 2048, 8, 64)),
             (("tokens", "embed"), (65536, 2048))]
    for shape in MESHES:
        jmesh, tmesh = _meshes(shape)
        kws = [{}, {"seq_parallel": True}, {"free_head_shard": True},
               {"overrides": {"embed": None}}]
        if "model" in MESHES[shape]:
            kws.append({"act_overrides": {"seq_q": ("model",)}})
        for kw in kws:
            jr, tr = j_rules(jmesh, cfg_j, **kw), default_rules(tmesh, cfg_t,
                                                               **kw)
            assert tr.dp_axes == jr.dp_axes and tr.dp_size == jr.dp_size
            for rules_j, rules_t in ((jr, tr),
                                     (jr.manual_over(jr.dp_axes),
                                      tr.manual_over(tr.dp_axes))):
                assert rules_t.param_rules == rules_j.param_rules
                assert rules_t.act_rules == rules_j.act_rules
                for axes, dims in hints:
                    assert tuple(rules_t.activation_sharding(
                        axes, dims).spec) == tuple(
                        rules_j.activation_sharding(axes, dims).spec)
    tr = default_rules(AbstractMesh((16, 16), ("data", "model")), cfg_t)
    assert tr.dp_axes == ("data",) and tr.dp_size == 16
    assert tr.manual_over(("data",)).dp_axes == ()


def test_choose_mesh_shape():
    for n in range(1, 513):
        for prefer in (16, 8, 1):
            assert elastic.choose_mesh_shape(n, prefer_model=prefer) == \
                j_elastic.choose_mesh_shape(n, prefer_model=prefer)


def _error(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 -- the error is the result
        return type(e), str(e)
    return None


def test_make_mesh_errors_match_reference(tmp_path):
    """A mesh larger than the world and bad ``axis_types`` fail as the
    reference's, message for message; a good call gives a DeviceMesh of
    the names (a world of one gloo rank)."""
    import torch.distributed as dist
    cases = [((2,), ("data",), None), ((1,), ("data",), ("auto", "auto")),
             ((1,), ("data",), ("bogus",)), ((4, 2), ("data", "model"),
                                            ("auto", "Explicit"))]
    for shape, axes, types in cases:
        want = _error(lambda: j_mesh.make_mesh(shape, axes,
                                               axis_types=types))
        got = _error(lambda: make_mesh(shape, axes, axis_types=types))
        assert got == want, (shape, types)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh((1,), ("data",))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        m = make_mesh((1,), ("data",), axis_types=("manual",))
        assert m.mesh_dim_names == ("data",) and tuple(m.mesh.shape) == (1,)
        m2 = make_mesh((1, 1), ("data", "model"))
        rules = default_rules(m2, get_config("tiny"))
        assert rules.dp_size == 1
        # reshard: full tensors -> DTensors on the rules' placements, a
        # DTensor -> the new placements; the local block is the tensor
        specs = build_model(get_config("tiny"), "cpu").param_specs()
        sh = rules.param_shardings(specs)
        full = map_specs(lambda s: torch.randn(s.shape), specs)
        dt = elastic.reshard(full, sh)
        again = elastic.reshard(dt, sh)
        for k in ("embed",):
            assert torch.equal(dt[k].to_local(), full[k])
            assert torch.equal(again[k].full_tensor(), full[k])
            assert dt[k].placements == sh[k].placements
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("comp", ["none", "fp8"])
def test_train_step_shardings_match_reference(comp):
    """The step's in / out shardings (params, optimizer state, residuals,
    batch, scalars) on a (4, 1) mesh, fsdp off."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.train.train_step import train_step_shardings as j_tss
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.train_step import train_step_shardings
    jmesh, tmesh = _meshes((4, 1))
    jcfg, tcfg = j_get_config("tiny"), get_config("tiny")
    kw = dict(grad_compression=comp, fsdp=False)
    j_in, j_out = j_tss(j_build(jcfg), JTrainConfig(**kw),
                        j_rules(jmesh, jcfg, fsdp=False))
    t_in, t_out = train_step_shardings(build_model(tcfg, "meta"),
                                       TrainConfig(**kw),
                                       default_rules(tmesh, tcfg,
                                                     fsdp=False))
    for jt, tt in zip(j_in + j_out, t_in + t_out):
        assert _port_specs(tt) == _ref_specs(jt)
