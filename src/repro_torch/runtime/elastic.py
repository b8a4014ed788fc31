"""Elastic scaling: re-mesh a checkpoint onto another topology (as
``repro.runtime.elastic``).

Checkpoints store full logical arrays (``checkpoint/manager.py``; a
mesh's ranks write them through ``parallel.collectives.gather_tree``),
so an elastic restore is a re-assignment of slices: each rank of the
target mesh keeps its slice of every leaf under the same path-pattern
rules. This covers scale-up (16x16 -> 2x16x16), scale-down (a failed
slice dropped, narrower data parallelism) and data <-> model reshapes,
as long as divisibility holds.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import filter_spec_for_mesh, shard_put
from repro_torch.tree import tree_map


def reshard_tree(tree, specs, mesh):
    """This rank's slice of every full leaf under its spec (axes absent
    from ``mesh`` dropped)."""
    return shard_put(tree, tree_map(lambda s: filter_spec_for_mesh(s, mesh),
                                    specs), mesh)


def elastic_restore_plan(old_mesh_shape, new_mesh_shape, global_batch: int):
    """Validate an elastic transition and return the new data-parallel
    layout (per-shard batch, #shards). Raises if the transition is
    impossible without changing global batch semantics."""
    old_dp = 1
    for n in old_mesh_shape.get("data", (1,)) if isinstance(
            old_mesh_shape.get("data"), tuple) else (
                old_mesh_shape.get("data", 1),):
        old_dp *= n
    new_dp = new_mesh_shape.get("data", 1) * new_mesh_shape.get("pod", 1)
    if global_batch % new_dp:
        raise ValueError(
            f"global batch {global_batch} not divisible by new DP degree "
            f"{new_dp}; adjust batch or use grad accumulation")
    return {"dp_degree": new_dp, "per_shard_batch": global_batch // new_dp,
            "grad_accum": 1}
