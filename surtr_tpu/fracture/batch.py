"""Batched multi-mesh fracture — BASELINE config 2: '1k Voronoi seeds per
event across 64 meshes in parallel'.

The mesh-batch axis is the framework's scaling axis (SURVEY §2.3): on one
device it is a memory-bounded ``lax.map`` over meshes (each element is
already wide through the inner cells×faces×slots vectorization); across
chips it shards with ``shard_map`` (see ``sharded_batch_decompose``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surtr_tpu.config import FractureConfig
from surtr_tpu.fracture.pipeline import prepare_fracture


@functools.partial(jax.jit, static_argnames=("cfg",))
def batch_decompose(
    verts: jax.Array,
    vmask: jax.Array,
    tri_corners: jax.Array,
    tmask: jax.Array,
    sphere_cloud: jax.Array,
    keys: jax.Array,
    cfg: FractureConfig,
):
    """Decompose M meshes, each with its own seed key.

    verts: (M, V, 3); vmask: (M, V); tri_corners: (M, T, 3, 3);
    tmask: (M, T); keys: (M, 2) PRNG keys.

    Returns (PieceSet with leading (M,) axis, metrics dict of (M,) arrays).
    """

    def one(args):
        v, vm, tc, tm, key = args
        pieces, ctx, met = prepare_fracture(v, vm, tc, tm, sphere_cloud, key, cfg)
        return pieces, met

    return jax.lax.map(one, (verts, vmask, tri_corners, tmask, keys))


def sharded_batch_decompose(
    mesh_axis: str,
    mesh,
    verts,
    vmask,
    tri_corners,
    tmask,
    sphere_cloud,
    keys,
    cfg: FractureConfig,
):
    """Multi-chip variant: the mesh batch is sharded over ``mesh_axis`` of
    ``mesh`` (jax.sharding.Mesh); each device decomposes its shard and the
    per-mesh piece counts are psum'd into a global tally."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def per_shard(v, vm, tc, tm, k):
        pieces, met = batch_decompose(v, vm, tc, tm, sphere_cloud, k, cfg)
        total = jax.lax.psum(jnp.sum(met["piece_cnt"]), mesh_axis)
        return pieces, total

    spec = P(mesh_axis)
    fn = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=(_piece_specs(spec), P()),
        # The pipeline mixes invariant constants (unit cube, cloud) into scan
        # carries; skip vma tracking rather than thread pcast through every
        # kernel (classic shard_map semantics).
        check_vma=False,
    )
    return fn(verts, vmask, tri_corners, tmask, keys)


def _piece_specs(spec):
    from surtr_tpu.fracture.types import PieceSet
    from surtr_tpu.types import ConvexPoly

    return PieceSet(
        convex=ConvexPoly(spec, spec, spec),
        mesh=spec,
        mesh_valid=spec,
        valid=spec,
        group=spec,
        tag=spec,
    )
