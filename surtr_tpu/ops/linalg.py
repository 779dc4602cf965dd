"""Small-contraction helpers.

Every geometry/physics contraction over a length-3 axis is written as
broadcast-multiply + sum: XLA fuses it with its neighbours, and it stays in
full f32 whatever the matmul precision (a *batched* tiny matmul — 3×3
matrices batched over thousands of elements — gets neither).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dotn(a: jax.Array, b: jax.Array) -> jax.Array:
    """sum(a * b, -1) — explicit elementwise contraction."""
    return jnp.sum(a * b, axis=-1)


def supports(verts: jax.Array, dirs: jax.Array) -> jax.Array:
    """(..., N, 3) · (..., K, 3) → (..., N, K) via broadcast.

    Replaces einsum "...nd,...kd->...nk" (batched tiny matmul)."""
    return jnp.sum(verts[..., :, None, :] * dirs[..., None, :, :], axis=-1)


def matvec3(m: jax.Array, v: jax.Array) -> jax.Array:
    """(..., 3, 3) @ (..., 3) → (..., 3) elementwise."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def rot_points(R: jax.Array, pts: jax.Array) -> jax.Array:
    """Rotate point sets: R (..., 3, 3), pts (..., N, 3) → (..., N, 3)."""
    return jnp.sum(R[..., None, :, :] * pts[..., :, None, :], axis=-1)


def compact(vals: jax.Array, flags: jax.Array, S_out: int):
    """Scatter-free stream compaction along axis -2.

    vals: (..., E, D); flags: (..., E) bool. Returns ((..., S_out, D) packed
    front-aligned, (...,) counts). One-hot contraction — fused broadcast
    mul+reduce instead of a batched scatter."""
    pos = jnp.cumsum(flags.astype(jnp.int32), axis=-1)        # 1-based
    j = jnp.arange(1, S_out + 1, dtype=jnp.int32)
    sel = flags[..., None, :] & (pos[..., None, :] == j[:, None])
    out = jnp.sum(
        sel[..., None].astype(vals.dtype) * vals[..., None, :, :], axis=-2
    )
    n = jnp.minimum(pos[..., -1], S_out)
    return out, n


def pack_rows(vals: jax.Array, counts: jax.Array, S_out: int):
    """Pack the first ``counts[r]`` entries of each row, front-aligned.

    vals: (T, S, D); counts: (T,) with counts[r] <= S. Returns
    ((S_out, D), total). O(S_out · log T): a searchsorted per output slot +
    one flat gather — the memory-safe compaction for row-structured pools
    (the one-hot ``compact`` materializes O(S_out · T · S) and OOMs at
    fracture-candidate scale)."""
    T, S, D = vals.shape
    counts = jnp.minimum(counts, S)
    cumc = jnp.cumsum(counts)
    total = cumc[-1]
    j = jnp.arange(S_out, dtype=counts.dtype)
    # method="sort": one batched sort-based lookup for every output slot.
    row = jnp.searchsorted(
        cumc, j, side="right", method="sort"
    ).astype(jnp.int32)
    rowc = jnp.minimum(row, T - 1)
    base = cumc[rowc] - counts[rowc]
    intra = jnp.clip(j - base, 0, S - 1)
    flat = rowc * S + intra
    out = vals.reshape(T * S, D)[flat]
    valid = j < total
    zero = jnp.zeros((), vals.dtype)
    return jnp.where(valid[:, None], out, zero), jnp.minimum(total, S_out)


def compact_big(vals: jax.Array, flags: jax.Array, S_out: int, chunk: int = 128):
    """Compaction for LARGE candidate pools (unbatched trailing layout).

    vals: (E, D); flags: (E,). The one-hot form is O(E·S_out); this is
    O(E·chunk): scan over chunks, pack each chunk with a small one-hot, and
    append at the running count via dynamic_update_slice.
    Returns ((S_out, D), count).

    WARNING: do not vmap this — a vmapped dynamic_update_slice lowers to a
    batched scatter. At E ≲ 10⁴ the plain
    ``compact`` above is GFLOP-scale and vmap-safe; this variant only pays
    off for very large unbatched pools.
    """
    E, D = vals.shape
    pad = (-E) % chunk
    if pad:
        vals = jnp.pad(vals, ((0, pad), (0, 0)))
        flags = jnp.pad(flags, (0, pad))
    nchunk = (E + pad) // chunk
    vals_c = vals.reshape(nchunk, chunk, D)
    flags_c = flags.reshape(nchunk, chunk)

    def body(carry, xs):
        out, cnt = carry
        v, f = xs
        packed, n = compact(v, f, chunk)
        out = jax.lax.dynamic_update_slice(out, packed, (cnt, jnp.int32(0)))
        return (out, jnp.minimum(cnt + n, S_out + chunk)), None

    buf = jnp.zeros((S_out + 2 * chunk, D), vals.dtype)
    (buf, cnt), _ = jax.lax.scan(
        body, (buf, jnp.int32(0)), (vals_c, flags_c)
    )
    return buf[:S_out], jnp.minimum(cnt, S_out)
