"""Tile rasterizer for NVIDIA GPUs: a Pallas kernel on the Triton route.

The jnp rasterizer (render/raster.py) sweeps every row tile against every
triangle block and streams each (pixels × block) edge-function buffer
through device memory. This kernel gives each 16×16 screen tile its own
program: the tile's z-buffer stays in registers while the program loops
over the triangle chunks binned to it.

Binning: triangles are sorted by the tile of their bbox center (outside the
kernel, one argsort) so each CHUNK of sorted triangles is spatially
coherent. Each tile loops only over its range [lo, hi) of chunks whose
bboxes overlap it, and skips a chunk inside that range when the chunk's
bbox misses the tile (four scalar compares). On fragment scenes most tiles
touch a handful of chunks, which turns the all-pairs sweep into near
output-proportional work.

Outputs agree with the jnp path: the same edge functions, the same (0, 1)
depth range, and on equal depth the lowest caller triangle index wins (the
jnp sweep's order), so adjacent fragments' coincident cut faces resolve the
same way. The winner's attributes are fetched by index after the kernel (a
native gather), not inside it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

BIG = 3.4e38
IMAX = 2**31 - 1
TILE = 16        # tile edge in pixels: one program per TILE × TILE tile
CHUNK = 16       # triangles per chunk: one (CHUNK, TILE²) slab per step


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _raster_tile_kernel(
    lo_ref, hi_ref,                        # (tiles_p,) i32 chunk range
    attrs_ref,                             # (10, T_pad) ax ay bx by cx cy
                                           #   za zb zc ok
    ids_ref,                               # (T_pad,) i32 caller tri index
    bx0_ref, bx1_ref, by0_ref, by1_ref,    # (nblk_p,) chunk bboxes
    depth_ref, tid_ref,                    # (TILE²,) this tile's outputs
    *, ntx: int,
):
    t = pl.program_id(0)
    ti = t // ntx
    tj = t % ntx
    PX = TILE * TILE
    k = jax.lax.broadcasted_iota(jnp.int32, (1, PX), 1)
    py = (k // TILE + ti * TILE).astype(jnp.float32) + 0.5     # (1, PX)
    px = (k % TILE + tj * TILE).astype(jnp.float32) + 0.5
    tile_x0 = (tj * TILE).astype(jnp.float32)
    tile_x1 = tile_x0 + TILE
    tile_y0 = (ti * TILE).astype(jnp.float32)
    tile_y1 = tile_y0 + TILE

    def body(b, carry):
        overlap = (
            (bx0_ref[b] <= tile_x1) & (bx1_ref[b] >= tile_x0)
            & (by0_ref[b] <= tile_y1) & (by1_ref[b] >= tile_y0)
        )

        def compute(carry):
            depth, tid = carry
            rows = pl.ds(b * CHUNK, CHUNK)
            col = lambda j: attrs_ref[j, rows][:, None]          # (CHUNK, 1)
            ax, ay, bx, by, cx, cy = (col(j) for j in range(6))
            za, zb, zc = col(6), col(7), col(8)
            okb = col(9) > 0.5
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            inv_area = jnp.where(jnp.abs(area) > 1e-12, 1.0 / area, 0.0)
            e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)    # (CHUNK, PX)
            e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
            e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
            w0 = e0 * inv_area
            w1 = e1 * inv_area
            w2 = e2 * inv_area
            cov = (
                (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                & okb & (jnp.abs(area) > 1e-12)
            )
            z = w0 * za + w1 * zb + w2 * zc
            z = jnp.where(cov & (z > 0) & (z < 1), z, BIG)
            zbest = jnp.min(z, axis=0)                          # (PX,)
            ids = jnp.where(z == zbest[None, :], ids_ref[rows][:, None], IMAX)
            best = jnp.min(ids, axis=0)                         # lowest id
            better = (zbest < depth) | ((zbest == depth) & (best < tid))
            return (
                jnp.where(better, zbest, depth),
                jnp.where(better, best, tid),
            )

        return jax.lax.cond(overlap, compute, lambda c: c, carry)

    depth0 = jnp.full((PX,), BIG, jnp.float32)
    tid0 = jnp.full((PX,), -1, jnp.int32)
    depth, tid = jax.lax.fori_loop(
        lo_ref[t], hi_ref[t], body, (depth0, tid0)
    )
    depth_ref[...] = depth
    tid_ref[...] = tid


@functools.partial(jax.jit, static_argnames=("W", "H", "interpret"))
def rasterize_ids_pallas(
    sx: jax.Array,
    sy: jax.Array,
    sz: jax.Array,
    ok: jax.Array,
    W: int,
    H: int,
    interpret: bool = False,
):
    """Z-buffer rasterization from screen-space triangles.

    sx/sy/sz: (T, 3) screen coords + ndc depth; ok: (T,) bool.
    Returns (depth (H, W), tid (H, W) i32, -1 = background). tid refers to
    the caller's triangle order.
    """
    T = sx.shape[0]
    PX = TILE * TILE
    nty = -(-H // TILE)
    ntx = -(-W // TILE)
    ntiles = nty * ntx

    # Tile-sort triangles by bbox-center tile id (invalid last) so chunks
    # are spatially coherent and the per-tile chunk ranges stay short.
    tx = jnp.clip((jnp.mean(sx, axis=1) // TILE).astype(jnp.int32), 0, ntx - 1)
    ty = jnp.clip((jnp.mean(sy, axis=1) // TILE).astype(jnp.int32), 0, nty - 1)
    key = jnp.where(ok, ty * ntx + tx, jnp.int32(1 << 30))
    order = jnp.argsort(key).astype(jnp.int32)
    sx, sy, sz, ok = sx[order], sy[order], sz[order], ok[order]

    T_pad = _pow2(max(T, CHUNK))
    nblk = T_pad // CHUNK
    padT = lambda a, fill: jnp.pad(
        a, [(0, T_pad - T)] + [(0, 0)] * (a.ndim - 1), constant_values=fill
    )
    okp = padT(ok, False)

    # Per-chunk screen bboxes over valid triangles (an empty chunk gets an
    # inverted bbox that never overlaps).
    def chunk_ext(v, lo):
        fill = BIG if lo else -BIG
        vp = jnp.where(okp[:, None], padT(v, fill), fill).reshape(nblk, -1)
        return jnp.min(vp, axis=1) if lo else jnp.max(vp, axis=1)

    bx0, bx1 = chunk_ext(sx, True), chunk_ext(sx, False)
    by0, by1 = chunk_ext(sy, True), chunk_ext(sy, False)

    # Per-tile chunk range [lo, hi): the first and last chunk whose bbox
    # overlaps the tile (the in-loop bbox test skips misses in between).
    t_iota = jnp.arange(ntiles, dtype=jnp.int32)
    tx0 = ((t_iota % ntx) * TILE).astype(jnp.float32)[:, None]
    ty0 = ((t_iota // ntx) * TILE).astype(jnp.float32)[:, None]
    ov = (
        (bx0[None] <= tx0 + TILE) & (bx1[None] >= tx0)
        & (by0[None] <= ty0 + TILE) & (by1[None] >= ty0)
    )                                                         # (tiles, nblk)
    b_iota = jnp.arange(nblk, dtype=jnp.int32)[None]
    lo_t = jnp.min(jnp.where(ov, b_iota, nblk), axis=1)
    hi_t = jnp.maximum(jnp.max(jnp.where(ov, b_iota + 1, 0), axis=1), lo_t)
    tiles_p = _pow2(ntiles)
    lo_t = jnp.pad(lo_t, (0, tiles_p - ntiles))
    hi_t = jnp.pad(hi_t, (0, tiles_p - ntiles))

    attrs = jnp.stack(
        [sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2],
         sz[:, 0], sz[:, 1], sz[:, 2], ok.astype(sx.dtype)],
        axis=0,
    )
    attrs = jnp.pad(attrs, ((0, 0), (0, T_pad - T)))          # (10, T_pad)
    ids = jnp.pad(order, (0, T_pad - T), constant_values=IMAX)

    depth, tid = pl.pallas_call(
        functools.partial(_raster_tile_kernel, ntx=ntx),
        grid=(ntiles,),
        in_specs=[pl.no_block_spec] * 8,
        out_specs=(
            pl.BlockSpec((None, PX), lambda t: (t, 0)),
            pl.BlockSpec((None, PX), lambda t: (t, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((ntiles, PX), jnp.float32),
            jax.ShapeDtypeStruct((ntiles, PX), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raster_tiles",
    )(lo_t, hi_t, attrs, ids, bx0, bx1, by0, by1)
    # (tiles, PX) rows → (H, W) image.
    img = lambda a: a.reshape(nty, ntx, TILE, TILE).transpose(
        0, 2, 1, 3
    ).reshape(nty * TILE, ntx * TILE)[:H, :W]
    return img(depth), img(tid)
