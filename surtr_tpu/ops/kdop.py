"""k-DOP (discrete-orientation polytope) fitting.

Replacement for ``Kdop::KdopContainer`` (/root/reference/Src/Kdop.cpp:10-179):
per direction, track the min/max support over the vertex set and emit a pair of
outward slab planes pushed out by ``gap`` (reference: Calc with
``maxAxisScale / planeGapInv``, Kdop.cpp:38-50). The support pass is a single
masked product of the vertex set with the direction table.

``ClipWithPolyhedron`` (Kdop.cpp:166-179) becomes: feed the slab planes to
``clip.clip_poly_planes``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def kdop_planes(
    verts: jax.Array,
    vert_mask: jax.Array,
    dirs: jax.Array,
    dir_mask: jax.Array | None = None,
    gap: jax.Array | float = 0.0,
):
    """Fit slab planes along ``dirs``.

    Args:
      verts: (..., N, 3); vert_mask: (..., N) bool; dirs: (K, 3) unit or
        (..., K, 3); dir_mask: (K,) bool; gap: outward offset.

    Returns:
      planes: (..., 2K, 4) — [max-side planes; min-side planes], and
      plane_mask: (..., 2K) bool.
    """
    from surtr_tpu.ops.linalg import supports

    K = dirs.shape[-2]
    # Broadcast contraction: full f32 at any matmul precision and no
    # batched tiny matmul (see ops/linalg.py).
    t = supports(verts, jnp.broadcast_to(dirs, verts.shape[:-2] + dirs.shape[-2:]))
    big = jnp.asarray(3.4e38, t.dtype)
    m = vert_mask[..., :, None]
    tmax = jnp.max(jnp.where(m, t, -big), axis=-2)          # (..., K)
    tmin = jnp.min(jnp.where(m, t, big), axis=-2)
    gap = jnp.asarray(gap, t.dtype)
    # Max plane: (n=dir, d=-(tmax+gap));  min plane: (n=-dir, d=tmin-gap).
    pmax = jnp.concatenate([dirs, -(tmax + gap)[..., None]], axis=-1)
    pmin = jnp.concatenate([-dirs, (tmin - gap)[..., None]], axis=-1)
    planes = jnp.concatenate([pmax, pmin], axis=-2)          # (..., 2K, 4)
    if dir_mask is None:
        pm = jnp.ones(planes.shape[:-1], bool)
    else:
        pm = jnp.concatenate([dir_mask, dir_mask], axis=-1)
        pm = jnp.broadcast_to(pm, planes.shape[:-1])
    any_vert = jnp.any(vert_mask, axis=-1)[..., None]
    return planes, pm & any_vert


def dop26_directions(dtype=jnp.float32) -> jax.Array:
    """The 13 canonical axes of a 26-DOP (axes + face diagonals + corner
    diagonals), unit length — the direction set named by BASELINE.json
    config[1] and used by the physics SAT narrowphase."""
    axes = [
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1), (0, 1, 1), (0, 1, -1),
        (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
    ]
    d = np.asarray(axes, np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(d, dtype)
