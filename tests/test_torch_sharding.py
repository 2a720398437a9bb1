"""Parity of the port's operations layer with the JAX package's
(``repro.sharding``, ``repro.launch.{mesh,specs}``,
``repro.core.rma.topology``): parameter spec trees of all ten
architectures leaf for leaf, ``rules_for`` for every arch × shape ×
``fsdp``, partition specs per leaf on both production meshes (the JAX side
on ``jax.sharding.AbstractMesh``, which needs no devices), per-device
argument bytes against JAX's ``shard_shape``, the parameter counts of
``launch.hlo_analysis`` (the dry-run's model FLOPs), the rules' dedup, the
constraint's rank error, ``topology_from_mesh`` and ``classify_cp``."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro import sharding as jsh
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_is_runnable as j_cell_is_runnable
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.core.rma import topology as jtopo
from repro.launch import hlo_analysis as JH
from repro.launch import mesh as jmesh
from repro.launch.specs import build_cell as j_build_cell
from repro.models import build_model as j_build_model
from repro.train.optimizer import opt_state_specs as j_opt_state_specs

from repro_torch import sharding as tsh
from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.core.rma import topology as ttopo
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import build_cell, sds_leaves
from repro_torch.models import build_model
from repro_torch.train.optimizer import opt_state_specs
from repro_torch.tree import leaves_with_paths

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _spec_leaves(tree, prefix=()):
    """(path, spec) of a spec tree; tuples and None are leaves."""
    if tree is None or isinstance(tree, tuple):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k],
                                                              prefix + (k,))]
    return [x for i, v in enumerate(tree) for x in _spec_leaves(v,
                                                               prefix + (i,))]


def _jpspec_leaves(tree):
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference_and_fit_the_params(arch):
    tm, jm = build_model(get_config(arch)), j_build_model(j_get_config(arch))
    spec = tm.param_specs()
    assert spec == jm.param_specs()
    assert opt_state_specs(spec) == j_opt_state_specs(jm.param_specs())
    assert tm.cache_specs() == jm.cache_specs()
    # the spec tree has the port's parameter tree's names, nesting and ranks
    params = leaves_with_paths(tm.init(0, device="meta"))
    specs = _spec_leaves(spec)
    assert [p for p, _ in params] == [p for p, _ in specs]
    assert all(len(s) == t.dim() for (_, t), (_, s) in zip(params, specs))


def test_shapes_and_runnable_cells_equal_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_train)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind, s.is_train)
         for k, s in J_SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert cell_is_runnable(get_config(arch), SHAPES[name]) == \
                j_cell_is_runnable(j_get_config(arch), J_SHAPES[name])


@pytest.mark.parametrize("fsdp", [True, False])
def test_rules_for_equal_reference(fsdp):
    for arch in ARCHS:
        for name in SHAPES:
            assert tmesh.rules_for(get_config(arch), SHAPES[name],
                                   fsdp=fsdp) == \
                jmesh.rules_for(j_get_config(arch), J_SHAPES[name],
                                fsdp=fsdp), (arch, name)
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tmesh.MODEL_AXIS_SIZE == jmesh.MODEL_AXIS_SIZE


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_partition_specs_per_leaf_equal_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    tm_mesh = tmesh.make_production_mesh(multi_pod=len(shape) == 3)
    assert tm_mesh.axis_sizes == shape and tm_mesh.axis_names == axes
    assert tm_mesh.size == math.prod(shape)
    jm_mesh = AbstractMesh(shape, axes)
    for arch in ARCHS:
        tcfg, jcfg = get_config(arch), j_get_config(arch)
        tmod, jmod = build_model(tcfg), j_build_model(jcfg)
        for name in SHAPES:
            rules = tmesh.rules_for(tcfg, SHAPES[name])
            tr = tsh.ShardingRules(tm_mesh, rules)
            jr = jsh.ShardingRules(jm_mesh, rules)
            for tspec, jspec in (
                    (tmod.param_specs(), jmod.param_specs()),
                    (opt_state_specs(tmod.param_specs()),
                     j_opt_state_specs(jmod.param_specs())),
                    (tmod.cache_specs(), jmod.cache_specs())):
                got = [tuple(p) for _, p in _spec_leaves(
                    tsh.spec_to_pspec(tspec, tr))]
                want = _jpspec_leaves(jsh.spec_to_pspec(jspec, jr))
                assert got == want, (arch, name)


def _jax_arg_bytes(arch, name, mesh_name):
    shape, axes = MESHES[mesh_name]
    cfg, sh = j_get_config(arch), J_SHAPES[name]
    rules = jsh.ShardingRules(AbstractMesh(shape, axes),
                              jmesh.rules_for(cfg, sh))
    _, args, _ = j_build_cell(cfg, sh, rules)
    return sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(args))


@pytest.mark.parametrize("name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_argument_bytes_per_device_equal_jax_shard_shape(arch, name):
    for mesh_name, (shape, _) in MESHES.items():
        mesh = tmesh.make_production_mesh(multi_pod=len(shape) == 3)
        cfg = get_config(arch)
        with tsh.use_rules(mesh, tmesh.rules_for(cfg, SHAPES[name])) as R:
            _, args, _ = build_cell(cfg, SHAPES[name], R)
        got = sum(s.shard_bytes for s in sds_leaves(args))
        assert got == _jax_arg_bytes(arch, name, mesh_name), mesh_name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    jcfg = j_get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    tcfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    assert TH.active_params(tcfg) == JH.active_params(jcfg)
    assert TH.total_params(tcfg) == JH.total_params(jcfg)


@pytest.mark.parametrize("spec,gshape", [
    (("data", "model"), (256, 4096)),
    ((("data",), "model"), (256, 4096)),
    ((("pod", "data"), None, "model"), (64, 3, 32)),
    ((None, ("data", "model")), (7, 512)),
    (("model",), (40,)),                       # 16 does not divide 40
    ((None, "data"), (4, 8)),                  # 16 does not divide 8
])
def test_shard_shape_equals_jax(spec, gshape):
    axes = ("pod", "data", "model")
    jm = AbstractMesh((2, 16, 16), axes)
    tm = tmesh.make_mesh((2, 16, 16), axes)
    jns = JNamedSharding(jm, JP(*spec))
    tns = tsh.NamedSharding(tm, tsh.P(*spec))
    try:
        want = jns.shard_shape(gshape)
    except ValueError:
        with pytest.raises(ValueError):
            tns.shard_shape(gshape)
        return
    assert tns.shard_shape(gshape) == tuple(want)


def test_sharding_rules_dedup():
    mesh = tmesh.make_host_mesh()
    r = tsh.ShardingRules(mesh, {"batch": ("pod", "data"), "embed": ("data",),
                                 "heads": "model"})
    # "pod" doesn't exist on this mesh: dropped; duplicate axis use: dropped
    assert r.partition_spec(("batch", None, "embed")) == tsh.P("data", None,
                                                                None)
    assert r.partition_spec(("heads", "batch")) == tsh.P("model", "data")
    jr = jsh.ShardingRules(AbstractMesh((1, 1), ("data", "model")), r.rules)
    assert tuple(jr.partition_spec(("batch", None, "embed"))) == \
        ("data", None, None)
    ns = r.sharding(("batch", "heads"))
    assert ns.mesh is mesh and ns.spec == tsh.P("data", "model")


def test_logical_constraint_rank_error_and_identity():
    x = torch.zeros(2, 3, 4)
    # no active rules: a no-op whatever the names
    assert tsh.logical_constraint(x, "batch") is x
    assert tsh.current_rules() is None
    with tsh.use_rules(tmesh.make_host_mesh()) as R:
        assert tsh.current_rules() is R and R.rules["batch"] == ("data",)
        assert tsh.logical_constraint(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError, match="2 names for rank-3 array"):
            tsh.logical_constraint(x, "batch", "seq")
    assert tsh.current_rules() is None


def test_model_annotations_raise_under_rules_for_a_misnamed_rank(monkeypatch):
    """The models call the constraint where the reference does: a forward
    under active rules runs, and a wrong rank raises in both packages."""
    from repro_torch.configs import tiny_config
    from repro_torch.models import moe, transformer

    cfg = tiny_config("llama4-maverick-400b-a17b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8)),
             "labels": torch.randint(0, cfg.vocab, (2, 8))}
    want, _ = model.forward(params, batch)
    with tsh.use_rules(tmesh.make_host_mesh()):
        got, _ = model.forward(params, batch)
        assert torch.equal(got, want)
        calls = []
        real = tsh.logical_constraint

        def spy(x, *names):
            calls.append(names)
            return real(x, *names)
        for mod in (transformer, moe):
            monkeypatch.setattr(mod, "logical_constraint", spy)
        model.forward(params, batch)
        assert ("expert", None, "embed") in calls
        assert ("batch", "seq", "embed") in calls
        monkeypatch.setattr(transformer, "logical_constraint",
                            lambda x, *n: real(x, *n[:-1]))
        with pytest.raises(ValueError, match="names for rank-3 array"):
            model.forward(params, batch)


def _topo_key(t):
    return None if t is None else (t.hosts, t.local)


@pytest.mark.parametrize("env", [None, "2x4"])
@pytest.mark.parametrize("layout", ["host-major", "interleaved", "single"])
def test_topology_from_mesh_equals_reference(layout, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("RMA_TOPOLOGY", raising=False)
    else:
        monkeypatch.setenv("RMA_TOPOLOGY", env)
    if layout == "single":
        mesh = tmesh.make_mesh((8, 2), ("data", "model"))
    else:
        # two hosts: devices 0-7 and 8-15, or every other pair of rows
        owner = {"host-major": lambda i: i // 8,
                 "interleaved": lambda i: (i // 2) % 2}[layout]
        devs = np.empty(16, dtype=object)
        for i in range(16):
            devs[i] = tsh.PlaceholderDevice(i, process_index=owner(i))
        mesh = tsh.Mesh(devs.reshape(8, 2), ("data", "model"))
    got = ttopo.topology_from_mesh(mesh, "data")
    assert _topo_key(got) == _topo_key(jtopo.topology_from_mesh(mesh, "data"))
    assert _topo_key(tmesh.mesh_topology(mesh, "data")) == _topo_key(got)
    want = {"host-major": (2, 4), "interleaved": None,
            "single": None if env is None else (2, 4)}[layout]
    assert _topo_key(got) == want
    assert ttopo.topology_from_mesh(mesh, "pod") is None


def test_classify_cp_equals_reference():
    def f(a, b):
        return jax.numpy.tanh(a @ b).sum()
    z = jax.numpy.zeros((16, 16))
    lines = [
        "%a = f32[4] collective-permute(f32[4] %x), "
        "source_target_pairs={{0,1},{1,0},{2,3},{3,2}}",
        "%b = f32[4] collective-permute(f32[4] %x), "
        "source_target_pairs={{0,2},{1,3},{2,0},{3,1}}",
        "%c = f32[4] collective-permute-start(f32[4] %x), "
        "source_target_pairs={{1,0}}",
        "%d = f32[4] collective-permute(f32[4] %x)",
    ]
    texts = [jax.jit(f).lower(z, z).compile().as_text(), "\n".join(lines)]
    for text in texts:
        for hosts, local in [(None, None), (2, 2), (1, 4), (4, 1)]:
            tt = None if hosts is None else ttopo.Topology(hosts, local)
            jt = None if hosts is None else jtopo.Topology(hosts, local)
            got = ttopo.classify_cp(text, tt)
            assert got == jtopo.classify_cp(text, jt)
            assert sum(got) == text.count("collective-permute(")
    assert ttopo.classify_cp("\n".join(lines), ttopo.Topology(2, 2)) == (2, 1)
    from repro_torch.core import rma
    assert rma.classify_cp is ttopo.classify_cp
    assert rma.topology_from_mesh is ttopo.topology_from_mesh
