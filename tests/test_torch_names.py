"""The port's public surface against the JAX package's, module by module.

Every module of ``src/repro`` has its counterpart under ``src/repro_torch``
with the same dotted path.  Each name in a reference module's ``__all__``
must exist on the port's module, and each parameter name of a public
function the reference module defines must be accepted by the port's
function of that name, so a caller who passes it by keyword keeps working.
``EXCEPTED_*`` below hold exactly the gaps left by design, each with its
reason; a test fails if an exception is no longer needed.  Then the names
that were added last are held to the reference's values on the same
inputs."""
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: reference modules with no counterpart in the port
EXCEPTED_MODULES = {
    # JAX version shims; its make_mesh is repro_torch.launch.mesh.make_mesh
    # and its shard_map has none (expert parallelism runs on stacked ranks)
    "repro.compat",
}

#: (reference module, public name) with no counterpart in the port
EXCEPTED_NAMES = {
    # Pallas helpers: interpret mode and TPU remote DMA have no CUDA meaning
    ("repro.kernels.common", "interpret_mode"),
    ("repro.kernels.common", "remote_device_id"),
    ("repro.kernels.common", "sync_copy"),
    # the TPU interconnect's rate; the port's roofline has NVLINK_BW
    ("repro.launch.hlo_analysis", "ICI_BW"),
}

#: parameter names the port replaces on purpose, wherever they occur
EXCEPTED_PARAMS = {
    "key": "a JAX PRNG key; the port takes a torch.Generator or an int seed",
    "axis": "a mesh axis name; the port's ranks are stacked rows",
    "block_kv": "a Pallas tile size; the CUDA kernels pick their own tiles",
}


def _reference_modules() -> list[str]:
    names = []
    for f in sorted((SRC / "repro").rglob("*.py")):
        parts = list(f.relative_to(SRC).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


MODULES = _reference_modules()


def _pair(name: str):
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    return ref, port


def _missing_names(name: str) -> list[str]:
    ref, port = _pair(name)
    return [n for n in getattr(ref, "__all__", ()) if not hasattr(port, n)]


def _missing_params(name: str) -> list[tuple[str, str]]:
    """(function, parameter) pairs of the reference module's public
    functions that the port's function of that name does not accept."""
    ref, port = _pair(name)
    out = []
    for fname, fn in vars(ref).items():
        if (fname.startswith("_") or not inspect.isfunction(fn)
                or fn.__module__ != name):
            continue
        twin = getattr(port, fname, None)
        if twin is None or not callable(twin):
            continue
        have = set(inspect.signature(twin).parameters)
        out += [(fname, p) for p in inspect.signature(fn).parameters
                if p not in have]
    return out


@pytest.mark.parametrize("name", MODULES)
def test_module_has_counterpart(name):
    if name in EXCEPTED_MODULES:
        with pytest.raises(ModuleNotFoundError):
            _pair(name)
        return
    _pair(name)


@pytest.mark.parametrize(
    "name", [m for m in MODULES if m not in EXCEPTED_MODULES])
def test_public_names_exist_in_port(name):
    missing = set(_missing_names(name))
    excepted = {n for m, n in EXCEPTED_NAMES if m == name}
    assert missing == excepted, (
        f"{name}: missing in the port {sorted(missing - excepted)}; "
        f"excepted but present {sorted(excepted - missing)}")


@pytest.mark.parametrize(
    "name", [m for m in MODULES if m not in EXCEPTED_MODULES])
def test_public_parameters_accepted_by_port(name):
    missing = [(f, p) for f, p in _missing_params(name)
               if p not in EXCEPTED_PARAMS]
    assert not missing, f"{name}: parameters the port lacks: {missing}"


def test_exceptions_are_exactly_the_gaps():
    """Every excepted module, name and parameter is still a gap: the list
    never outlives what it excuses."""
    assert all(m in MODULES for m in EXCEPTED_MODULES)
    for module, name in EXCEPTED_NAMES:
        assert name in _missing_names(module), (module, name)
    used = {p for m in MODULES if m not in EXCEPTED_MODULES
            for _, p in _missing_params(m)}
    assert set(EXCEPTED_PARAMS) <= used, set(EXCEPTED_PARAMS) - used


# ---------------------------------------------------------------------------
# the names added last, against the reference's values
# ---------------------------------------------------------------------------


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32) * 3.0,
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((4, 3, 2)).astype(np.float32)}}


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    from repro.train.optimizer import clip_by_global_norm as j_clip
    from repro_torch.train.optimizer import clip_by_global_norm as t_clip

    tree = _grad_tree(3)
    j_tree, j_norm = j_clip({"a": jnp.asarray(tree["a"]),
                             "b": {k: jnp.asarray(v)
                                   for k, v in tree["b"].items()}}, max_norm)
    t_in = {"a": torch.from_numpy(tree["a"]),
            "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}}
    t_tree, t_norm = t_clip(t_in, max_norm)
    np.testing.assert_allclose(t_norm.numpy(), np.asarray(j_norm), rtol=1e-6)
    for got, want in ((t_tree["a"], j_tree["a"]),
                      (t_tree["b"]["c"], j_tree["b"]["c"]),
                      (t_tree["b"]["d"], j_tree["b"]["d"])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the input tree is left as it was (a new tree is returned)
    np.testing.assert_array_equal(t_in["a"].numpy(), tree["a"])


def test_tiled_ops_equal_reference():
    from repro.core.rma.accumulate import TILED_OPS as J_TILED
    from repro_torch.core.rma.accumulate import TILED_OPS as T_TILED
    from repro_torch.kernels.common import ACC_OPS

    assert isinstance(T_TILED, frozenset)
    assert T_TILED == J_TILED == frozenset(ACC_OPS)


#: the ops and dtypes of the reference's own op_identity tests
#: (tests/test_accumulate_router.py: bitwise ops on integers only, and
#: ``replace``, which has none, on float32)
IDENTITY_CASES = [(op, dt) for op in ("sum", "min", "max", "prod", "band",
                                      "bor", "bxor")
                  for dt in ("float32", "int32")
                  if not (op in ("band", "bor", "bxor") and dt == "float32")
                  ] + [("replace", "float32")]


@pytest.mark.parametrize("op,dtype", IDENTITY_CASES)
def test_ops_op_identity_equals_reference(op, dtype):
    from repro.kernels.ops import op_identity as j_ident
    from repro_torch.kernels.ops import op_identity as t_ident

    want, got = j_ident(op, jnp.dtype(dtype)), t_ident(op, dtype)
    if want is None:
        assert got is None
    else:
        assert got == np.asarray(want).item()


def test_ops_reexports_are_the_wrappers():
    """``kernels.ops`` re-exports the kernel wrappers themselves, as the
    reference's does (no second definition)."""
    import repro_torch.kernels as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk

    for name in ("flash_attention", "accumulate", "op_identity", "ring_put",
                 "ring_accumulate", "put_signal", "accumulate_signal",
                 "ring_all_reduce", "ssd_scan"):
        assert getattr(ops, name) is getattr(K, name), name
    assert ops.ssd_intra_chunk is ssd_intra_chunk


def test_hier_applies_matches_reference():
    from repro.core import rma as J
    from repro_torch.core import rma as T

    for hosts, local in ((1, 8), (2, 4), (4, 2), (8, 1)):
        for chunks in (1, 2):
            for op in (None, "sum", "max"):
                want = J.hier_applies(J.Topology(hosts, local), 8,
                                      chunks=chunks, op=op)
                got = T.hier_applies(T.Topology(hosts, local), 8,
                                     chunks=chunks, op=op)
                assert got == want, (hosts, local, chunks, op)
    assert T.hier_applies(None, 8) == J.hier_applies(None, 8) is False


def test_embed_and_ring_lowering_take_reference_keywords():
    from repro_torch.core.rma import RmaPlan
    from repro_torch.core.rma.collectives import lower_ring_all_reduce
    from repro_torch.models.layers import embed

    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = embed(x_tokens=torch.tensor([[2, 0]]), params={"table": table},
                dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), table.numpy()[[[2, 0]]])
    plan = RmaPlan("label")
    plan.window("w", scope="thread", order=True, same_op="sum",
                accumulate_ops=("sum",), dtype=torch.float32)
    plan.bind("x", (8,), torch.float32)
    out, hier = lower_ring_all_reduce(plan, "w", "x", "x", 4, shape=(8,),
                                      dtype=torch.float32, label="ignored")
    assert hier is False and out is not None
