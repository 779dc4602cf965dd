#!/usr/bin/env python
"""Smoke test of the fracture → physics → render path on NVIDIA GPUs.

    python chip_smoke.py             # phases 0-5 on one card
    python chip_smoke.py --cards 4   # phase 6 only: the sharded batch
                                     # decomposition across four cards

Phases (each raises on failure):
  0. device: the first JAX device must be a GPU; prints the card's name and
     power limit as nvidia-smi reports them.
  1. scene: Scene("cube") at the reference's default fracture settings
     (64 initial cells, a 128-cell partial radial pattern per click), three
     fire_impact calls, 120 steps, one 512² render with a 512 shadow map.
  2. decomposition: the 1024-cell decomposition of the cube.
  3. physics: the 10k-fragment pile for 60 steps; the broadphase pairs must
     match a NumPy brute-force K-nearest reference.
  4. fused frame: 16 chained interactive_frame calls.
  5. kernels: each hand-written GPU kernel against its plain XLA version
     (largest difference beside its tolerance, median times of both), then
     the runs that use them end to end with the kernels and without.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = "unknown"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, *args, warmup=2, iters=7):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_scene():
    from bench import interactive_frame_config
    from surtr_tpu.scene import Scene

    cfg = interactive_frame_config()
    sc = Scene("cube", cfg)
    v0, n0 = sc.total_volume(), sc.num_pieces()
    rays = [((0.0, 10.0, 0.0), (0.0, -1.0, 0.0)),
            ((0.6, 10.0, 0.3), (0.0, -1.0, 0.0)),
            ((-0.5, 10.0, -0.4), (0.0, -1.0, 0.0))]
    counts = [n0]
    for origin, direction in rays:
        out = sc.fire_impact(origin, direction)
        check(out, f"ray {origin} missed the scene")
        v = sc.total_volume()
        check(abs(v - v0) <= 1e-3 * v0, f"volume {v} vs {v0} after impact")
        counts.append(sc.num_pieces())
    check(counts[-1] > n0, f"piece count did not grow: {counts}")
    sc.step(120)
    img = np.asarray(sc.render())
    shape = (cfg.render.height, cfg.render.width, 3)
    check(img.shape == shape, f"image shape {img.shape}")
    check(np.isfinite(img).all(), "image has non-finite pixels")
    check(float(img.std()) > 1e-3, "image is constant")
    return f"pieces {counts}, volume {sc.total_volume():.5f} (start {v0:.5f})"


def phase_decomposition():
    import jax

    met = _decomposition_runner()(jax.random.PRNGKey(46354))
    vol = float(met["total_volume"])
    check(abs(vol - 27.005) <= 0.05, f"decomposition volume {vol}")
    return f"{int(met['piece_cnt'])} pieces, volume {vol:.4f} (27.005 ± 0.05)"


def _pair_check(scene, pcfg, pidx, pok):
    """The step's mutual K-nearest pairs against a NumPy brute force.

    Returns (found, required, illegal): every pair that is strictly inside
    both sides' K nearest must be found; no pair outside either side's K
    nearest (ties at the K-th distance included) may appear. Distance ties
    at the K-th place may resolve either way."""
    import jax

    from surtr_tpu.physics.step import _world_aabbs

    _, _, lo, hi, c = jax.device_get(
        _world_aabbs(scene, pcfg.contact_slop * 4.0)
    )
    owner = np.asarray(scene.piece_owner)
    valid = np.asarray(scene.piece_valid) & (owner >= 0)
    pidx, pok = np.asarray(pidx), np.asarray(pok)
    K, n = pidx.shape[1], len(c)

    def dist_rows(r0, r1):
        d2 = ((c[r0:r1, None] - c[None]) ** 2).sum(-1)
        ok = (
            np.all((lo[r0:r1, None] <= hi[None])
                   & (lo[None] <= hi[r0:r1, None]), -1)
            & (owner[r0:r1, None] != owner[None])
            & valid[r0:r1, None] & valid[None]
        )
        ok[np.arange(r1 - r0), np.arange(r0, r1)] = False
        return np.where(ok, d2, np.inf)

    chunks = [(r0, min(n, r0 + 500)) for r0 in range(0, n, 500)]
    kth = np.concatenate(
        [np.partition(dist_rows(*ch), K - 1, axis=1)[:, K - 1] for ch in chunks]
    )
    found = required = illegal = 0
    for r0, r1 in chunks:
        d2 = dist_rows(r0, r1)
        fin = np.isfinite(d2)
        lo_t, hi_t = 1.0 - 1e-6, 1.0 + 1e-6
        strict = fin & (d2 < kth[r0:r1, None] * lo_t) & (d2 < kth[None] * lo_t)
        allowed = fin & (d2 <= kth[r0:r1, None] * hi_t) & (d2 <= kth[None] * hi_t)
        got = np.zeros_like(fin)
        rows = np.repeat(np.arange(r1 - r0), K)
        live = pok[r0:r1].ravel()
        got[rows[live], pidx[r0:r1].ravel()[live]] = True
        required += int(strict.sum())
        found += int((strict & got).sum())
        illegal += int((got & ~allowed).sum())
    return found, required, illegal


def phase_physics():
    import jax

    from bench import physics_10k_scene
    from surtr_tpu.physics.step import broadphase_pairs, physics_step

    pcfg, scene = physics_10k_scene()
    steps = jax.jit(
        lambda s: jax.lax.scan(
            lambda c, _: (physics_step(c, pcfg), None), s, None, length=59
        )[0]
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pairs0 = broadphase_pairs(scene, pcfg)
        s1 = jax.jit(lambda s: physics_step(s, pcfg))(scene)
        s60 = steps(s1)
        pairs60 = broadphase_pairs(s60, pcfg)
    ours = [w for w in caught if "surtr_tpu" in str(w.filename)]
    check(not ours, f"warnings from the step: {[str(w.message) for w in ours]}")
    x = np.asarray(s60.bodies.x)
    check(np.isfinite(x).all() and np.isfinite(np.asarray(s60.bodies.v)).all(),
          "NaN in the 10k pile")
    out = []
    for name, sc, (pidx, pok) in (("step 1", scene, pairs0),
                                  ("step 60", s60, pairs60)):
        found, required, illegal = _pair_check(sc, pcfg, pidx, pok)
        check(found == required and not illegal,
              f"{name}: broadphase found {found}/{required} required pairs, "
              f"{illegal} outside the K nearest")
        out.append(f"{name} recall {found}/{required} (1.0), "
                   f"{int(np.asarray(pok).sum())} live slots")
    return ", ".join(out) + f", {len(x)} bodies finite"


def _frame_runner(sc, n):
    import jax
    import jax.numpy as jnp

    from surtr_tpu.scene import interactive_frame

    origin = jnp.asarray([0.0, 10.0, 0.0])
    direction = jnp.asarray([0.0, -1.0, 0.0])
    eye = jnp.asarray([8.0, 6.0, 8.0], jnp.float32)
    target = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)

    @jax.jit
    def frames(pieces, phys, x0):
        def body(carry, _):
            pieces, phys, x0 = carry
            pieces, phys, x0, img, met = interactive_frame(
                pieces, phys, x0, sc.ctx, origin, direction, eye, target,
                cfg=sc.cfg,
            )
            bad = jnp.sum(~jnp.isfinite(img)) + jnp.sum(
                ~jnp.isfinite(phys.bodies.x)
            )
            return (pieces, phys, x0), (met["active_pieces"], bad)

        return jax.lax.scan(body, (pieces, phys, x0), None, length=n)[1]

    return frames


def phase_fused_frame():
    from bench import interactive_frame_config
    from surtr_tpu.scene import Scene

    sc = Scene("cube", interactive_frame_config())
    active, bad = _frame_runner(sc, 16)(sc.pieces, sc.phys, sc._x0)
    active, bad = np.asarray(active), np.asarray(bad)
    check((active > 0).all(), f"frames without refracture: {active}")
    check((bad == 0).all(), f"non-finite values per frame: {bad}")
    return f"16 frames, fractured pieces per frame {active.tolist()}"


def _frame_screen_tris(cfg):
    """Screen-space triangles of the interactive-frame scene after three
    impacts and 60 steps: the camera pass and the shadow pass."""
    import jax.numpy as jnp

    from surtr_tpu.render.camera import light_view_proj, look_at, perspective
    from surtr_tpu.render.raster import _near_clip_pooled, _project, _screen
    from surtr_tpu.scene import Scene

    sc = Scene("cube", cfg)
    W, S = cfg.render.width, cfg.render.shadow_size
    for x in (0.0, 0.6, -0.5):
        sc.fire_impact((x, 10.0, 0.2), (0.0, -1.0, 0.0))
    sc.step(60)
    world = sc.world_pieces()
    P, T = world.P, world.T
    tris = world.mesh.reshape(P * T, 3, 3)
    valid = world.mesh_valid.reshape(P * T)
    cam = jnp.matmul(
        perspective(45.0, 1.0, 0.01, 500.0),
        look_at((8.0, 6.0, 8.0), (0.0, 1.0, 0.0)),
        precision="highest",
    )
    lvp = light_view_proj(jnp.asarray([-0.4, -1.0, -0.3]), (0.0, 1.0, 0.0), 14.0)
    clip_p, ok_p, _ = _near_clip_pooled(_project(tris, cam), valid)
    camera = _screen(clip_p, W, W)[:3] + (ok_p,)
    shadow = _screen(_project(tris, lvp), S, S)[:3] + (valid,)
    return {f"camera {W}²": (camera, W), f"shadow {S}²": (shadow, S)}


def _decomposition_runner():
    import jax
    import jax.numpy as jnp

    from bench import decomposition_1k_config
    from surtr_tpu.fracture.pipeline import prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    cfg = decomposition_1k_config()
    v, f = get_model("cube")
    return jax.jit(
        lambda key: prepare_fracture(
            jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]),
            jnp.ones(len(f), bool), jnp.asarray(sphere_point_cloud()), key,
            cfg,
        )[2]
    )


def _fold_cases(cfg):
    """Plane folds at the shapes the main path runs: the 1k decomposition's
    cell fold (1024 cells × 54 planes, F=26) and an impact's job fold (the
    16 pieces nearest a click × 128 pattern cells = 2048 jobs, 32 planes)."""
    import jax
    import jax.numpy as jnp

    from bench import decomposition_1k_config
    from surtr_tpu.fracture.pattern import uniform_seeds
    from surtr_tpu.fracture.pipeline import _cell_plane_sets
    from surtr_tpu.ops.moments import moments
    from surtr_tpu.scene import Scene
    from surtr_tpu.types import scale_poly, translate_poly, unit_cube

    dcfg = decomposition_1k_config()
    C = dcfg.initial_decompose_cell_cnt
    extent = jnp.full((3,), 3.0)
    seeds = uniform_seeds(jax.random.PRNGKey(3), C)
    planes, pmask = _cell_plane_sets(
        seeds, dcfg.voronoi_neighbors, extent, jnp.zeros(3)
    )
    box = scale_poly(unit_cube(F=dcfg.max_faces, S=dcfg.max_face_verts), extent)
    cells = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (C,) + a.shape), box
    )
    sc = Scene("cube", cfg)
    ctx = sc.ctx
    # A click on the top face: the pattern centred there, and the 16 pieces
    # nearest to it each folded by every pattern cell.
    impact = ctx.bb_center + jnp.asarray([0.0, 1.5, 0.0])
    pat = translate_poly(
        scale_poly(ctx.partial_pattern, 2.0 * ctx.max_axis_scale), impact
    )
    vol, cen = moments(sc.pieces.convex)
    dist = jnp.where(sc.pieces.valid, jnp.sum((cen - impact) ** 2, -1), 1e30)
    near = jnp.argsort(dist)[:16]
    NC = pat.n_verts.shape[0]
    J = 16 * NC
    idx = jnp.arange(J)
    pieces = jax.tree_util.tree_map(lambda a: a[near[idx // NC]],
                                    sc.pieces.convex)
    cell = idx % NC
    return {
        f"decomposition {C}x{planes.shape[1]}": (cells, planes, pmask, 3.0),
        f"impact jobs {J}x{pat.planes.shape[1]}": (
            pieces, pat.planes[cell], pat.face_mask()[cell], 1.0,
        ),
    }


def _raster_lines(cfg):
    """The tile rasterizer against the jnp sweep on the frame's own
    triangles: largest depth difference, id agreement, median times."""
    import jax

    from surtr_tpu.render.raster import _raster_screen_jnp
    from surtr_tpu.render.raster_pallas import rasterize_ids_pallas

    lines = []
    with jax.default_matmul_precision("highest"):
        for name, ((sx, sy, sz, ok), W) in _frame_screen_tris(cfg).items():
            kern = jax.jit(lambda *a, W=W: rasterize_ids_pallas(*a, W, W))
            ref = jax.jit(
                lambda *a, W=W: _raster_screen_jnp(*a, W, W, 32, 512)
            )
            dk, tk = jax.device_get(kern(sx, sy, sz, ok))
            dr, tr = jax.device_get(ref(sx, sy, sz, ok))
            hit = dr < 1e30
            check(np.array_equal(hit, dk < 1e30), f"{name}: coverage differs")
            ddiff = float(np.abs(dk - dr)[hit].max()) if hit.any() else 0.0
            same = float((tk == tr).mean())
            check(ddiff <= 1e-6, f"{name}: depth diff {ddiff} > 1e-6")
            check(same >= 0.999, f"{name}: id agreement {same} < 0.999")
            ms_k = median_ms(kern, sx, sy, sz, ok)
            ms_r = median_ms(ref, sx, sy, sz, ok)
            lines.append(
                f"raster {name} ({int(np.asarray(ok).sum())} tris): depth diff "
                f"{ddiff:.3g} (tol 1e-6), id agreement {same:.6f} (tol 0.999); "
                f"kernel {ms_k:.3f} ms, XLA {ms_r:.3f} ms [{CARD}]"
            )
    return lines


def _oracle_volume(poly, planes, pmask, j):
    """Float64 volume of polytope j folded by its planes (surtr_tpu.oracle):
    a large cube clipped by the polytope's own face planes, then the rest."""
    from surtr_tpu.oracle.poly import clip_polyhedron, cube_polyhedron, moments

    own = np.asarray(poly.planes[j], np.float64)[np.asarray(poly.n_verts[j]) > 0]
    cut = np.asarray(planes[j], np.float64)[np.asarray(pmask[j])]
    out = clip_polyhedron(cube_polyhedron(1e3), np.concatenate([own, cut]))
    return float(moments(out)[0])


def _fold_lines(cfg):
    """The plane-fold kernel against the XLA scan fold at the main path's
    shapes: largest per-polytope volume difference, median times."""
    import jax

    from surtr_tpu.ops.clip import clip_poly_planes
    from surtr_tpu.ops.clip_pallas import clip_planes_batch_pallas
    from surtr_tpu.ops.moments import moments

    lines = []
    with jax.default_matmul_precision("highest"):
        for name, (poly, planes, pmask, scale) in _fold_cases(cfg).items():
            kern = jax.jit(clip_planes_batch_pallas)
            ref = jax.jit(jax.vmap(clip_poly_planes))
            vk = np.asarray(jax.vmap(moments)(kern(poly, planes, pmask))[0])
            vr = np.asarray(jax.vmap(moments)(ref(poly, planes, pmask))[0])
            tol = 2e-6 * scale**3      # tests/test_clip_pallas.py, rescaled
            vdiff = float(np.abs(vk - vr).max())
            # Where the two folds disagree beyond tol, the float64 oracle
            # decides: the kernel must match it.
            off = np.nonzero(np.abs(vk - vr) > tol)[0]
            check(len(off) <= 64, f"fold {name}: {len(off)} polytopes differ")
            odiff = xdiff = 0.0
            for j in off:
                vo = _oracle_volume(poly, planes, pmask, j)
                odiff = max(odiff, abs(float(vk[j]) - vo))
                xdiff = max(xdiff, abs(float(vr[j]) - vo))
            check(odiff <= tol, f"fold {name}: oracle diff {odiff} > {tol}")
            ms_k = median_ms(kern, poly, planes, pmask)
            ms_r = median_ms(ref, poly, planes, pmask)
            lines.append(
                f"fold {name}: volume diff vs XLA {vdiff:.3g} (tol {tol:.3g}); "
                f"{len(off)} polytopes beyond tol, where the f64 oracle is "
                f"off by {odiff:.3g} from the kernel and {xdiff:.3g} from XLA; "
                f"total {vk.sum():.5f} vs {vr.sum():.5f}; kernel {ms_k:.3f} "
                f"ms, XLA {ms_r:.3f} ms [{CARD}]"
            )
    return lines


def _end_to_end_line(cfg):
    """Kernels vs plain XLA end to end: the decomposition (fold only),
    Scene.render (raster only) and 16 fused frames (both)."""
    import jax

    from surtr_tpu.device import plain_xla
    from surtr_tpu.scene import Scene

    def e2e_ms():
        decomp = median_ms(_decomposition_runner(), jax.random.PRNGKey(1),
                           warmup=1, iters=5)
        sc = Scene("cube", cfg)
        run = _frame_runner(sc, 16)
        frames = median_ms(run, sc.pieces, sc.phys, sc._x0, warmup=1, iters=5)
        render = median_ms(sc.render, warmup=1, iters=5)
        return decomp, render, frames / 16

    d_k, r_k, f_k = e2e_ms()
    with plain_xla():
        d_x, r_x, f_x = e2e_ms()
    return (
        f"end to end (kernels vs plain XLA): decomposition 1k {d_k:.3f} vs "
        f"{d_x:.3f} ms; Scene.render {r_k:.3f} vs {r_x:.3f} ms; fused frame "
        f"{f_k:.3f} vs {f_x:.3f} ms/frame [{CARD}]"
    )


def phase_kernels():
    from bench import interactive_frame_config

    cfg = interactive_frame_config()
    lines = _raster_lines(cfg) + _fold_lines(cfg) + [_end_to_end_line(cfg)]
    return "\n  ".join(lines)


def phase_sharded_batch(cards: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bench import decomposition_1k_config
    from surtr_tpu.fracture.batch import batch_decompose, sharded_batch_decompose
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    devices = jax.devices()
    check(len(devices) >= cards, f"{len(devices)} devices < {cards}")
    cfg = decomposition_1k_config()
    M = 64
    v, f = get_model("cube")
    args = (
        jnp.broadcast_to(jnp.asarray(v)[None], (M,) + v.shape),
        jnp.ones((M, len(v)), bool),
        jnp.broadcast_to(jnp.asarray(v[f])[None], (M,) + v[f].shape),
        jnp.ones((M, len(f)), bool),
        jnp.asarray(sphere_point_cloud()),
        jax.random.split(jax.random.PRNGKey(7), M),
    )
    mesh = Mesh(np.asarray(devices[:cards]), ("data",))
    sharded = jax.jit(
        lambda *a: sharded_batch_decompose("data", mesh, *a, cfg)
    )
    pieces, total = sharded(*args)
    local = jax.jit(lambda *a: batch_decompose(*a, cfg))
    with jax.default_device(devices[0]):
        ref_pieces, ref_met = local(*args)
    from surtr_tpu.ops.moments import moments

    def per_mesh(p):
        vol, _ = jax.vmap(moments)(p.convex)
        return (
            np.asarray(p.valid).sum(1),
            np.where(np.asarray(p.valid), np.asarray(vol), 0.0).sum(1),
        )

    cnt, vol = per_mesh(pieces)
    rcnt, rvol = per_mesh(ref_pieces)
    check(np.array_equal(cnt, rcnt), "per-mesh piece counts differ")
    check(int(total) == int(rcnt.sum()), f"psum total {int(total)}")
    rel = float(np.max(np.abs(vol - rvol) / np.abs(rvol)))
    check(rel <= 1e-4, f"per-mesh volume rel diff {rel} > 1e-4")
    ms_s = median_ms(sharded, *args, warmup=1, iters=3)
    with jax.default_device(devices[0]):
        ms_l = median_ms(local, *args, warmup=1, iters=3)
    return (
        f"{M} meshes on {cards} cards: counts equal ({int(total)} pieces), "
        f"volume rel diff {rel:.3g} (tol 1e-4); sharded {ms_s:.2f} ms, "
        f"one card {ms_l:.2f} ms [{CARD}]"
    )


def main() -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4 = run only the four-card sharded batch phase")
    args = p.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    CARD = card_name_and_limit()
    log(f"card: {CARD}")
    sys.path.insert(0, ROOT)
    from surtr_tpu.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")

    if args.cards == 4:
        phases = [("6 sharded batch", lambda: phase_sharded_batch(4))]
    else:
        phases = [
            ("1 scene", phase_scene),
            ("2 decomposition", phase_decomposition),
            ("3 physics", phase_physics),
            ("4 fused frame", phase_fused_frame),
            ("5 kernels", phase_kernels),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        detail = fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s — {detail}")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
