"""Batched bounded 3-D Voronoi cell construction.

Replacement for the external **voro++** library (reference usage:
/root/reference/Src/Surtr.cpp:2004-2067 — unit-cube container, per-cell
face-vertex polytope extraction). Design (SURVEY.md §2.2 T1): the
Voronoi cell of seed i inside a convex domain is the domain clipped by the
bisector half-spaces toward every other seed. We clip against the k-nearest
seeds only (nearest first, so the cell shrinks early); with k >= the true
neighbor count this is exact — validated against the all-pairs f64 oracle.

Everything is one `vmap` of the shared plane-fold clip kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surtr_tpu.ops.clip import clip_poly_planes
from surtr_tpu.types import ConvexPoly, unit_cube


def bisector_planes(seed: jax.Array, others: jax.Array, other_mask: jax.Array):
    """Half-space planes keeping points closer to ``seed`` than each other.

    plane n = (o - s)/|o - s|, d = -n·midpoint; kept side n·x + d < 0.
    Returns (K, 4) planes and (K,) mask.
    """
    diff = others - seed
    dist = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    ok = other_mask & (dist[:, 0] > 1e-12)
    n = diff / jnp.maximum(dist, 1e-30)
    mid = (others + seed) * 0.5
    d = -jnp.sum(n * mid, axis=-1, keepdims=True)
    return jnp.concatenate([n, d], axis=-1), ok


@functools.partial(jax.jit, static_argnames=("k", "F", "S"))
def voronoi_cells(
    seeds: jax.Array,
    seed_mask: jax.Array | None = None,
    k: int = 48,
    F: int = 32,
    S: int = 16,
    domain: ConvexPoly | None = None,
) -> ConvexPoly:
    """Voronoi cells of ``seeds`` bounded by ``domain`` (default: unit cube).

    Args:
      seeds: (N, 3); seed_mask: (N,) bool; k: bisectors per cell (k-nearest).

    Returns a ConvexPoly with batch shape (N,); cells of invalid seeds are
    empty.
    """
    N = seeds.shape[0]
    if seed_mask is None:
        seed_mask = jnp.ones((N,), bool)
    if domain is None:
        domain = unit_cube(F=F, S=S, dtype=seeds.dtype)
    k = min(k, max(N - 1, 1))

    d2 = jnp.sum((seeds[:, None] - seeds[None, :]) ** 2, axis=-1)
    big = jnp.asarray(3.4e38, seeds.dtype)
    d2 = jnp.where(seed_mask[None, :], d2, big)
    d2 = jnp.fill_diagonal(d2, big, inplace=False)
    neg, idx = jax.lax.top_k(-d2, k)                          # nearest first
    nb_ok = (-neg) < big / 2                                  # (N, k)

    from surtr_tpu.ops.clip_pallas import clip_planes_batch

    planes, pm = jax.vmap(bisector_planes)(seeds, seeds[idx], nb_ok)
    dom = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), domain
    )
    cells = clip_planes_batch(dom, planes, pm)
    nv = jnp.where(seed_mask[:, None], cells.n_verts, 0)
    return ConvexPoly(cells.face_verts, nv, cells.planes)
