"""Production meshes and per-(arch × shape) sharding rules.

The meshes are shape-only (``repro_torch.sharding.Mesh``): the dry-run reads
per-device shards from them; nothing is placed.  ``make_mesh`` is the
counterpart of the JAX package's ``compat.make_mesh``; its other shim,
``compat.shard_map``, has none: the port's expert parallelism runs on
stacked ranks (``Model.ep_ranks``), not inside a partitioned program.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding import DEFAULT_RULES, Mesh, PlaceholderDevice


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``shape`` placeholder devices of one process, numbered
    row-major."""
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = PlaceholderDevice(id=i)
    return Mesh(devs.reshape(tuple(shape)), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips per pod; 2×16×16 = 512 chips for the two-pod mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``data × model`` mesh for tests and examples."""
    return make_mesh((data, model), ("data", "model"))


def mesh_topology(mesh: Mesh, axis: str):
    """The ``g hosts × l local`` factorization of one mesh axis, or ``None``
    for the flat treatment: multi-host meshes are grouped by
    ``process_index``; single-process meshes honor ``RMA_TOPOLOGY=GxL``.
    Feed the result to ``make_train_step(topology=…)``,
    ``plan_all_reduce`` / ``plan_all_to_all`` or ``RmaPlan(topology=…)``."""
    from repro_torch.core.rma.topology import topology_from_mesh

    return topology_from_mesh(mesh, axis)


MODEL_AXIS_SIZE = 16  # both production meshes have model=16


def rules_for(cfg: ModelConfig, shape: ShapeConfig, *, fsdp: bool = True
              ) -> dict:
    """Logical→mesh mapping for one dry-run cell, the JAX package's rules.

    * batch → ("pod", "data");
    * heads/kv_heads/mlp/expert → "model" only when every dimension that
      carries the name divides the model-axis size (else replicated over
      "model", FSDP carries them); vocab → "model" (padded to 256);
    * params' "embed" → ("pod", "data") under ``fsdp``;
    * decode shapes: the KV cache's seq dim over "model";
    * long_500k (batch 1): batch unsharded, cache seq over ("data",
      "model"), params TP-only.
    """
    m = MODEL_AXIS_SIZE
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data")
    rules["heads"] = "model" if cfg.n_heads % m == 0 else None
    rules["kv_heads"] = "model" if cfg.n_kv_heads % m == 0 else None
    rules["vocab"] = "model"  # vocab_padded is a multiple of 256
    rules["expert"] = ("model" if (cfg.moe and cfg.moe.num_experts % m == 0)
                       else None)
    # the fused mlp dim must divide for every projection that carries it
    mlp_dims = {2 * cfg.d_ff, cfg.d_ff} if cfg.d_ff else set()
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        nheads = d_inner // cfg.ssm.headdim
        mlp_dims |= {2 * d_inner + 2 * cfg.ssm.d_state + nheads,
                     d_inner + 2 * cfg.ssm.d_state, d_inner}
    if cfg.moe is not None:
        mlp_dims |= {2 * cfg.moe.d_ff_shared, cfg.moe.d_ff_shared} - {0}
    rules["mlp"] = "model" if all(d % m == 0 for d in mlp_dims) else None
    if fsdp:
        rules["embed"] = ("pod", "data")
    if shape.kind == "decode":
        rules["kv_seq"] = "model"
    if shape.name == "long_500k":
        rules["batch"] = None
        rules["kv_seq"] = ("data", "model")
        rules["embed"] = None  # batch=1: params TP-only, data carries the cache
    return rules


__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "mesh_topology", "MODEL_AXIS_SIZE", "rules_for"]
