#!/usr/bin/env python
"""Benchmark harness — BASELINE.json configs on the current JAX backend.

Prints ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <value/10ms>, ...}

The headline metric is the north star from BASELINE.json: one 1k-seed
fracture decomposition plus one 10k-fragment physics step, in ms. Extra keys
carry the per-config numbers. A phase that fails ends the run with a
non-zero exit code.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from surtr_tpu.compile_cache import enable_compile_cache


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def timeit(fn, *args, warmup=2, iters=5):
    """Median wall-clock ms of a call, up to block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def decomposition_1k_config():
    """The 1024-cell decomposition of the procedural cube."""
    from surtr_tpu.config import FractureConfig

    return FractureConfig(
        initial_decompose_cell_cnt=1024,
        max_pieces=1024,
        # Capacity fit to the workload: the cube ACH has ~10 live faces and
        # its cells ≤ ~15+caps; F=26 reproduces the F=32 total volume bit-for-band (27.0049 vs
        # 27.0044) while shrinking the fold state — F=24 starts dropping
        # caps (vol 26.992). Tiling invariant: tests/test_tiling.py.
        max_faces=26,
        max_face_verts=16,
        max_piece_tris=64,
        voronoi_neighbors=48,
        voronoi_prefix=24,            # exact at any prefix (two-pass
                                      # filter)
        partial_pattern_cell_cnt=8,   # pattern caching excluded from timing
        general_pattern_cell_cnt=8,
        exact_caps=False,             # cube is CONVEX: legacy refit-face
                                      # caps are exact for convex solids
                                      # (oracle-tested) — same dispatch the
                                      # Scene API applies automatically by
                                      # measured hull/mesh volume ratio
    )


def bench_decomposition_1k():
    """Config 2 core: 1k-seed Voronoi fracture decomposition of a mesh."""
    from surtr_tpu.fracture.pipeline import prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    cfg = decomposition_1k_config()
    v, f = get_model("cube")
    verts = jnp.asarray(v)
    corners = jnp.asarray(v[f])
    vm = jnp.ones(len(v), bool)
    tm = jnp.ones(len(f), bool)
    cloud = jnp.asarray(sphere_point_cloud())
    key = jax.random.PRNGKey(46354)

    def run(key):
        pieces, ctx, met = prepare_fracture(verts, vm, corners, tm, cloud, key, cfg)
        return pieces.valid, met["total_volume"]

    # REP independent events per dispatch: the steady-state per-event cost.
    REP = 64
    keys = jax.random.split(key, REP)

    @jax.jit
    def run_many(keys):
        def body(c, k):
            valid, vol = run(k)
            return c + jnp.sum(valid), vol

        return jax.lax.scan(body, jnp.int32(0), keys)

    ms = timeit(run_many, keys) / REP
    valid, vol = run(key)
    vol = float(vol)
    # This config's cells must tile the F=26 capacity-clipped ACH exactly
    # (27.0049, pinned in tests/test_tiling.py); a missed near bisector
    # duplicates volume. Checked on the backend that runs it.
    if abs(vol - 27.005) > 0.05:
        raise AssertionError(
            f"decomp_1k cell volumes do not tile the ACH: {vol:.4f} vs "
            "27.005 — bisector miss or capacity regression"
        )
    return ms, int(jax.device_get(valid).sum()), vol


def physics_10k_scene(n=10_000):
    """The 10k-fragment single-piece pile: (PhysicsConfig, PhysicsScene)."""
    from surtr_tpu.config import PhysicsConfig
    from surtr_tpu.fracture.types import PieceSet
    from surtr_tpu.physics.scene import build_scene
    from surtr_tpu.types import translate_poly, unit_cube

    # Fully shattered pile: every fragment is its own body, so the solver's
    # gather-free single-piece path applies (identical results; the segment
    # sums are the identity there). Hull-vert capacity fit to the workload
    # (same policy as the decomposition benches' F=26/F=96): the pile's
    # cube hulls have EXACTLY 8 vertices, so Vh=8 holds them with zero
    # capacity loss and bit-identical contacts — Vh=32 quadrupled every
    # hull-vert tensor for padding alone. Capacity invariant pinned in
    # tests/test_tiling.py.
    pcfg = PhysicsConfig(single_piece_bodies=True, max_hull_verts=8)
    # A settled-pile-like lattice of unit-cube fragments (dense contacts).
    side = int(round(n ** (1 / 3)))
    while side * side * side < n:
        side += 1
    idx = np.arange(side**3)[:n]
    xs = np.stack(
        [idx % side, (idx // side) % side, idx // (side * side)], axis=1
    ).astype(np.float32)
    offsets = xs * 1.02 + np.array([-side / 2, -1.45 + 0.0, -side / 2])

    cube = unit_cube(F=8, S=8)
    conv = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), cube
    )
    conv = translate_poly(conv, jnp.zeros(3))
    fv = conv.face_verts + jnp.asarray(offsets)[:, None, None, :]
    d = conv.planes[..., 3:4] - jnp.sum(
        conv.planes[..., :3] * jnp.asarray(offsets)[:, None, :], -1, keepdims=True
    )
    from surtr_tpu.types import ConvexPoly

    conv = ConvexPoly(fv, conv.n_verts, jnp.concatenate([conv.planes[..., :3], d], -1))
    pieces = PieceSet(
        convex=conv,
        mesh=jnp.zeros((n, 1, 3, 3)),
        mesh_valid=jnp.zeros((n, 1), bool),
        valid=jnp.ones((n,), bool),
        group=jnp.arange(n, dtype=jnp.int32),
        tag=jnp.full((n,), -1, jnp.int32),
    )
    return pcfg, build_scene(pieces, pcfg, max_bodies=n)


def bench_physics_10k(n=10_000):
    """Config 3: 10k-fragment physics step with contacts + impulses."""
    from surtr_tpu.physics.step import physics_step

    pcfg, scene = physics_10k_scene(n)
    # Steady-state step cost: scan REP steps per dispatch.
    REP = 64

    @jax.jit
    def run_steps(s):
        out = jax.lax.scan(
            lambda c, _: (physics_step(c, pcfg), None), s, None, length=REP
        )[0]
        return out.bodies.x

    ms = timeit(run_steps, scene, warmup=3, iters=8) / REP
    return ms


def bench_batch64_1k(M=64):
    """Config 2 proper: 1k-seed decomposition across 64 meshes in parallel
    (single chip, lax.map over the mesh batch; the dispatch amortizes over
    the batch, so one timed call is the steady-state number)."""
    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.batch import batch_decompose
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    cfg = FractureConfig(
        initial_decompose_cell_cnt=1024,
        max_pieces=1024,
        max_faces=26,   # workload-fit capacity (see bench_decomposition_1k)
        max_face_verts=16,
        max_piece_tris=64,
        voronoi_neighbors=48,
        voronoi_prefix=24,
        partial_pattern_cell_cnt=8,
        general_pattern_cell_cnt=8,
        exact_caps=False,   # convex model (see bench_decomposition_1k)
    )
    v, f = get_model("cube")
    verts = jnp.broadcast_to(jnp.asarray(v)[None], (M,) + v.shape)
    vmask = jnp.ones((M, len(v)), bool)
    corners = jnp.broadcast_to(jnp.asarray(v[f])[None], (M,) + v[f].shape)
    tmask = jnp.ones((M, len(f)), bool)
    cloud = jnp.asarray(sphere_point_cloud())
    keys = jax.random.split(jax.random.PRNGKey(7), M)

    @jax.jit
    def run(keys):
        pieces, met = batch_decompose(
            verts, vmask, corners, tmask, cloud, keys, cfg
        )
        return jnp.sum(pieces.valid)

    ms = timeit(run, keys, warmup=1, iters=3)
    return ms, ms / M


def bench_cube32():
    """Config 0: cube, 32 seeds, single impact event (end-to-end)."""
    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.pipeline import do_fracture, prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    cfg = FractureConfig(
        initial_decompose_cell_cnt=32,
        max_pieces=256,
        max_active_pieces=16,
        max_piece_tris=128,
        partial_pattern_cell_cnt=128,
        voronoi_neighbors=48,
        general_pattern_cell_cnt=8,
        exact_caps=False,   # convex model (see bench_decomposition_1k)
    )
    v, f = get_model("cube")
    cloud = jnp.asarray(sphere_point_cloud())
    pieces, ctx, _ = prepare_fracture(
        jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]),
        jnp.ones(len(f), bool), cloud, jax.random.PRNGKey(46354), cfg,
    )
    impact = jnp.array([1.5, 1.5, 1.5])

    # Steady-state per-event cost (same amortization as the other configs).
    REP = 16

    @jax.jit
    def run_many(p):
        def body(c, i):
            out, met = do_fracture(
                p, ctx, impact + c * 0, 0, cfg, partial=True
            )
            return c + jnp.sum(out.valid), None

        return jax.lax.scan(body, jnp.float32(0), jnp.arange(REP))[0]

    ms = timeit(run_many, pieces) / REP
    return ms


def bench_render(size=512, shadow=512):
    """Config 4 tail: one shadow-mapped frame of a fractured scene."""
    import numpy as np

    from surtr_tpu.render.camera import light_view_proj, look_at, perspective
    from surtr_tpu.render.raster import render_scene

    rng = np.random.default_rng(0)
    T = 4096  # fragment-scene scale triangle load
    centers = rng.uniform(-4, 4, (T, 1, 3)).astype(np.float32)
    tris = jnp.asarray(centers + rng.normal(0, 0.3, (T, 3, 3)).astype(np.float32))
    valid = jnp.ones((T,), bool)
    colors = jnp.full((T, 3), 0.5)
    cam = perspective(45, 1.0, 0.1, 100) @ look_at((8, 6, 8), (0, 0, 0))
    ldir = jnp.asarray([-0.4, -1.0, -0.3])
    lvp = light_view_proj(ldir, (0, 0, 0), 8.0)

    # REP frames per dispatch (the frame is stateless, so the scan is pure
    # repetition).
    REP = 64

    @jax.jit
    def run(t):
        def body(c, _):
            img, _ = render_scene(
                t + c * 0, valid, colors, cam, lvp, ldir,
                W=size, H=size, shadow_size=shadow,
            )
            return c + jnp.sum(img[::64, ::64]), None

        return jax.lax.scan(body, jnp.float32(0), None, length=REP)[0]

    return timeit(run, tris, warmup=2, iters=5) / REP


def interactive_frame_config():
    """The reference's default fracture settings (64 initial cells, a
    128-cell partial radial pattern per click) at a 512² frame with a 512
    shadow map."""
    from surtr_tpu.config import (
        FractureConfig, PhysicsConfig, RenderConfig, SceneConfig,
    )

    return SceneConfig(
        fracture=FractureConfig(
            initial_decompose_cell_cnt=64,
            max_pieces=256,
            max_active_pieces=32,
            max_piece_tris=64,
            max_mesh_tris=512,
            partial_pattern_cell_cnt=128,
            general_pattern_cell_cnt=64,
            voronoi_neighbors=48,
        ),
        physics=PhysicsConfig(),
        render=RenderConfig(width=512, height=512, shadow_size=512),
    )


def bench_interactive_frame():
    """Config 4 head: the WHOLE interactive loop — raycast impact, radial
    refracture, rigid rebuild + velocity transfer, physics step, shadow-
    mapped render — as ONE fused dispatch (scene.interactive_frame; the
    reference's Tick is one loop, Surtr.cpp:123-131)."""
    from surtr_tpu.scene import Scene, interactive_frame

    sc = Scene("cube", interactive_frame_config())
    # Scene's convex-model dispatch rewrites the fracture config (cube is
    # convex → legacy caps are exact and exact_caps turns OFF); the frames
    # must run THAT config — passing the pre-dispatch cfg silently re-ran
    # the concave-model caps machinery every frame.
    cfg = sc.cfg
    origin = jnp.asarray([0.0, 10.0, 0.0])
    direction = jnp.asarray([0.0, -1.0, 0.0])
    eye = jnp.asarray([8.0, 6.0, 8.0], jnp.float32)
    target = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)

    # 16 chained frames per dispatch (frames carry real state — each one
    # raycasts, refractures whatever the ray hits, steps and renders).
    REP = 16

    @jax.jit
    def frames(pieces, phys, x0):
        def body(carry, _):
            pieces, phys, x0, acc = carry
            pieces, phys, x0, img, _ = interactive_frame(
                pieces, phys, x0, sc.ctx, origin, direction, eye, target,
                cfg=cfg,
            )
            return (pieces, phys, x0, acc + jnp.sum(img[::64, ::64])), None

        (p2, ph2, x2, acc), _ = jax.lax.scan(
            body, (pieces, phys, x0, jnp.float32(0)), None, length=REP
        )
        return acc

    ms = timeit(
        frames, sc.pieces, sc.phys, sc._x0, warmup=2, iters=5
    ) / REP
    return ms


# ---------------------------------------------------------------------------
# Self-budgeting driver (round-4 fix for the rc=124 / parsed:null record of
# round 3: the driver's window must ALWAYS receive one complete JSON line).
#
#  * The headline (decomp_1k + physics_10k) runs first; a complete JSON line
#    is printed to stdout the moment it lands.
#  * Extended metrics run only while wall-clock remains under
#    SURTR_BENCH_BUDGET_S (default 1200 s); each one that completes replaces
#    the stdout JSON line with a fuller one (the LAST stdout line is always
#    the most complete snapshot, and every line is valid JSON on its own).
#  * SIGTERM/SIGALRM (what `timeout` sends) flush the current snapshot and
#    exit cleanly, so even a hard external cutoff leaves a parseable record.
# ---------------------------------------------------------------------------

_BUDGET_S = float(os.environ.get("SURTR_BENCH_BUDGET_S", "1200"))
_T0 = time.time()
_RESULTS: dict = {}
_FINALIZED = False


def _emit(final=False):
    """Emit the current snapshot as one JSON line. Intermediate snapshots go
    to stderr (progress record); only the headline and the final/cutoff
    snapshot go to stdout, so stdout carries at most two JSON lines and the
    LAST one is always the most complete."""
    _RESULTS["bench_wall_s"] = round(time.time() - _T0, 1)
    line = json.dumps(_RESULTS)
    if final:
        print(line, flush=True)
    else:
        log(line)


def _finalize_and_exit(signum=None, frame=None):
    global _FINALIZED
    if not _FINALIZED:
        _FINALIZED = True
        log(f"[bench] cut off (signal {signum}) — flushing snapshot")
        _emit(final=True)
    os._exit(1)


def _remaining():
    return _BUDGET_S - (time.time() - _T0)


def main():
    import signal

    enable_compile_cache()
    signal.signal(signal.SIGTERM, _finalize_and_exit)
    signal.signal(signal.SIGALRM, _finalize_and_exit)
    # Hard backstop 30 s past the soft budget: if a single compile wedges us,
    # the alarm still flushes whatever completed.
    signal.alarm(int(_BUDGET_S) + 30)

    backend = jax.default_backend()
    log(f"[bench] backend={backend} budget={_BUDGET_S:.0f}s")
    _RESULTS.update(
        {
            "metric": "1k-seed fracture decomposition + 10k-fragment physics step",
            "value": -1.0,
            "unit": "ms",
            "vs_baseline": -1.0,
            "backend": backend,
        }
    )

    # --- headline, highest priority ---
    decomp_ms, n_pieces, vol = bench_decomposition_1k()
    log(f"[bench] decomp_1k={decomp_ms:.2f} ms ({time.time()-_T0:.0f}s elapsed)")
    phys_ms = bench_physics_10k()
    log(f"[bench] physics_10k={phys_ms:.2f} ms ({time.time()-_T0:.0f}s elapsed)")
    total = decomp_ms + phys_ms
    _RESULTS.update(
        {
            "value": round(total, 3),
            "vs_baseline": round(total / 10.0, 4),
            "decomposition_1k_ms": round(decomp_ms, 3),
            "physics_10k_ms": round(phys_ms, 3),
            "decomp_pieces": n_pieces,
        }
    )
    _emit(final=True)  # the headline is on stdout no matter what happens below

    # --- extended metrics, cheapest-compile first, budget-gated ---
    def run_gated(key_fields, fn, min_budget_s=90):
        """Run one extended metric if budget remains; fold results in."""
        names = key_fields if isinstance(key_fields, tuple) else (key_fields,)
        if _remaining() < min_budget_s:
            log(f"[bench] SKIP {names[0]} (only {_remaining():.0f}s left)")
            for n in names:
                _RESULTS.setdefault(n, -1.0)
            _RESULTS.setdefault("skipped", []).append(names[0])
            return
        vals = fn()
        vals = vals if isinstance(vals, tuple) else (vals,)
        for n, v in zip(names, vals):
            _RESULTS[n] = round(v, 3) if isinstance(v, float) else v
        log(
            f"[bench] {names[0]}={vals[0]:.2f} "
            f"({time.time()-_T0:.0f}s elapsed)"
        )
        _emit()

    run_gated("cube32_impact_ms", bench_cube32)
    run_gated(
        ("batch64_1k_total_ms", "batch64_1k_per_mesh_ms"), bench_batch64_1k
    )
    run_gated("render_512_ms", bench_render)
    run_gated("render_shadow1024_ms", lambda: bench_render(shadow=1024))
    run_gated("interactive_frame_ms", bench_interactive_frame, min_budget_s=150)

    global _FINALIZED
    _FINALIZED = True
    _emit(final=True)


if __name__ == "__main__":
    main()
