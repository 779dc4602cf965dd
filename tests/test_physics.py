"""Physics tests (SURVEY §4: free fall vs closed form, rest stability,
energy behavior, determinism, queries)."""

import jax
import jax.numpy as jnp
import numpy as np

from surtr_tpu.config import PhysicsConfig
from surtr_tpu.fracture.types import PieceSet
from surtr_tpu.physics.queries import raycast, sphere_overlap
from surtr_tpu.physics.scene import build_scene, piece_world_verts
from surtr_tpu.physics.step import physics_step
from surtr_tpu.types import translate_poly, unit_cube

# max_hull_verts=16: every hull in this file is a unit cube (8 verts) —
# the default 64 pads the narrowphase tensors 8x for nothing on CPU.
PCFG = PhysicsConfig(broadphase_block=64, max_hull_verts=16)


def make_pieces(offsets, groups):
    polys = [
        translate_poly(unit_cube(), jnp.asarray(o, jnp.float32)) for o in offsets
    ]
    conv = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *polys)
    P = len(offsets)
    return PieceSet(
        conv,
        jnp.zeros((P, 4, 3, 3)),
        jnp.zeros((P, 4), bool),
        jnp.ones((P,), bool),
        jnp.asarray(groups, jnp.int32),
        jnp.full((P,), -1, jnp.int32),
    )


def run(s, n):
    step = jax.jit(lambda s: physics_step(s, PCFG))
    for _ in range(n):
        s = step(s)
    return s


def test_mass_and_inertia_density_10():
    s = build_scene(make_pieces([[0, 5, 0]], [0]), PCFG)
    assert np.isclose(1.0 / float(s.bodies.inv_mass[0]), 10.0, rtol=1e-4)
    # unit cube inertia m/6 on the diagonal
    inv_I = np.asarray(s.bodies.inv_inertia_body[0])
    assert np.allclose(np.diag(inv_I), 6.0 / 10.0, rtol=1e-3)


def test_free_fall_matches_symplectic_closed_form():
    s = build_scene(make_pieces([[0, 5, 0]], [0]), PCFG)
    n = 60
    s = run(s, n)
    dt = PCFG.dt
    y = 5 + PCFG.gravity * dt * dt * n * (n + 1) / 2
    assert np.isclose(float(s.bodies.x[0, 1]), y, atol=1e-3)
    assert np.isclose(float(s.bodies.v[0, 1]), PCFG.gravity * dt * n, atol=1e-3)


def test_rest_on_ground():
    s = build_scene(make_pieces([[0, -1.49, 0]], [0]), PCFG)
    s = run(s, 240)
    assert abs(float(s.bodies.x[0, 1]) + 1.5) < 0.02
    assert abs(float(s.bodies.v[0, 1])) < 0.01


def test_two_body_stack_remains_stacked():
    s = build_scene(make_pieces([[0, -1.45, 0], [0, -0.4, 0]], [0, 1]), PCFG)
    s = run(s, 360)
    ys = np.asarray(s.bodies.x[:2, 1])
    assert abs(ys[0] + 1.5) < 0.05
    assert abs(ys[1] + 0.5) < 0.1


def test_compound_of_two_pieces_moves_rigidly():
    s = build_scene(
        make_pieces([[0, 5, 0], [1, 5, 0]], [0, 0]), PCFG
    )  # one body, two pieces
    assert int(s.bodies.active.sum()) == 1
    assert np.isclose(1.0 / float(s.bodies.inv_mass[0]), 20.0, rtol=1e-4)
    s = run(s, 30)
    wv, wm = piece_world_verts(s)
    # pieces keep their relative offset
    c0 = np.asarray(wv[0][np.asarray(wm[0])]).mean(0)
    c1 = np.asarray(wv[1][np.asarray(wm[1])]).mean(0)
    assert np.allclose(c1 - c0, [1, 0, 0], atol=1e-4)


def test_five_cube_stack_stays_stacked():
    """VERDICT r1 item 4: a 5-high stack must not wobble apart — the
    containment manifold gives 4 contact points per face pair."""
    offsets = [[0, -1.45 + 1.02 * i, 0] for i in range(5)]
    s = build_scene(make_pieces(offsets, list(range(5))), PCFG)
    s = run(s, 600)  # 5 seconds
    ys = np.asarray(s.bodies.x[:5, 1])
    xs = np.asarray(s.bodies.x[:5, 0])
    zs = np.asarray(s.bodies.x[:5, 2])
    for i in range(5):
        assert abs(ys[i] - (-1.5 + 1.0 * i)) < 0.12, ys
    # lateral drift under 1 cm (the round-1 tightening target)
    assert np.all(np.abs(xs) < 0.01), xs
    assert np.all(np.abs(zs) < 0.01), zs


def test_edge_contact_normal():
    """A cube rotated 45° about z resting on a flat cube below: the minimal
    SAT axis is an edge/face interaction; without edge-cross axes the normal
    came out wrong. The contact normal must be ±y."""
    import dataclasses

    from surtr_tpu.physics.rigid import quat_normalize

    # bottom cube at y=-1.5 (resting on ground), diamond above touching its
    # top face with an edge.
    s = build_scene(
        make_pieces([[0, -1.49, 0], [0, 0.2, 0]], [0, 1]), PCFG
    )
    ang = np.pi / 4
    q = jnp.asarray([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)], jnp.float32)
    bodies = s.bodies
    new_q = bodies.q.at[1].set(quat_normalize(q))
    s = dataclasses.replace(s, bodies=dataclasses.replace(bodies, q=new_q))
    s = run(s, 120)
    # The diamond's lowest point must come to rest ON the bottom cube's top
    # face (y=-1): center at y ≈ -1 + sqrt(2)/2.
    y1 = float(s.bodies.x[1, 1])
    assert abs(y1 - (-1.0 + np.sqrt(2) / 2)) < 0.12, y1
    # and it must not have been kicked sideways
    assert abs(float(s.bodies.x[1, 0])) < 0.05
    assert abs(float(s.bodies.x[1, 2])) < 0.05


def test_determinism():
    s1 = run(build_scene(make_pieces([[0, 0, 0], [0.2, 1.2, 0]], [0, 1]), PCFG), 120)
    s2 = run(build_scene(make_pieces([[0, 0, 0], [0.2, 1.2, 0]], [0, 1]), PCFG), 120)
    assert np.array_equal(np.asarray(s1.bodies.x), np.asarray(s2.bodies.x))


def test_energy_non_increasing_after_settle():
    s = build_scene(make_pieces([[0, 0, 0]], [0]), PCFG)
    step = jax.jit(lambda s: physics_step(s, PCFG))
    energies = []
    for _ in range(300):
        s = step(s)
        v = float(jnp.sum(s.bodies.v[0] ** 2))
        y = float(s.bodies.x[0, 1])
        energies.append(0.5 * v + 9.81 * (y + 2.0))
    # After settling, total energy stays below the initial drop energy.
    assert energies[-1] < energies[0] * 0.5


def test_raycast_and_sphere_overlap():
    s = build_scene(make_pieces([[0, 0, 0], [3, 0, 0]], [0, 1]), PCFG)
    idx, t = raycast(
        s, jnp.array([-5.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0])
    )
    assert int(idx) == 0
    assert np.isclose(float(t), 4.5, atol=1e-4)
    idx2, t2 = raycast(
        s, jnp.array([5.0, 0.0, 0.0]), jnp.array([-1.0, 0.0, 0.0])
    )
    assert int(idx2) == 1
    assert np.isclose(float(t2), 1.5, atol=1e-4)
    miss, _ = raycast(s, jnp.array([0.0, 5.0, 0.0]), jnp.array([1.0, 0.0, 0.0]))
    assert int(miss) == -1
    ov = sphere_overlap(s, jnp.array([0.0, 0.0, 0.0]), 1.0)
    assert ov.tolist() == [True, False]
    # (1.5,0,0) r=1.2 reaches cube 0's +x face (1.0 away) AND cube 1's -x
    # face at x=2.5 (also 1.0 away).
    ov2 = sphere_overlap(s, jnp.array([1.5, 0.0, 0.0]), 1.2)
    assert ov2.tolist() == [True, True]
    ov3 = sphere_overlap(s, jnp.array([1.5, 0.0, 0.0]), 0.9)
    assert ov3.tolist() == [False, False]


import pytest


def _single_vs_general(offsets, n, **over):
    """Trajectories of the gather-free single-piece solver path and the
    general segment-sum path on the same scene."""
    import dataclasses

    out = []
    for single in (True, False):
        cfg = dataclasses.replace(PCFG, single_piece_bodies=single, **over)
        s = build_scene(make_pieces(offsets, list(range(len(offsets)))), cfg)
        step = jax.jit(lambda s, c=cfg: physics_step(s, c))
        for _ in range(n):
            s = step(s)
        out.append(s.bodies)
    return out


def test_single_piece_solver_matches_general_solver():
    """With one piece per body the per-body segment sums are the identity,
    so the gather-free solver path must give the general path's result."""
    a, b = _single_vs_general(
        [[0, -1.45, 0], [0, -0.4, 0], [0.3, 0.65, 0], [5, -1.4, 0]], 30,
        broadphase="auto",
    )
    for f in ("x", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), atol=1e-5
        )


def test_body_sleeping_and_wake():
    """PhysX putToSleep analogue: a settled body sleeps (frozen, zero
    velocity); an incoming fast body wakes it."""
    import dataclasses

    s = build_scene(make_pieces([[0, -1.49, 0]], [0]), PCFG)
    s = run(s, 120)  # settle + sleep (30 slow frames needed)
    assert int(s.sleep_frames[0]) >= PCFG.sleep_frames
    assert float(jnp.abs(s.bodies.v).max()) == 0.0
    y_sleep = float(s.bodies.x[0, 1])
    s = run(s, 60)
    # frozen: no drift at all while asleep
    assert float(s.bodies.x[0, 1]) == y_sleep

    # Drop a second body onto it → wake.
    s2 = build_scene(
        make_pieces([[0, -1.49, 0], [0, 1.5, 0]], [0, 1]), PCFG
    )
    s2 = run(s2, 90)  # bottom sleeps, top falls and lands (~0.4 s fall)
    # after impact the bottom body must be awake (counter reset at impact)
    # and both eventually settle again
    s2 = run(s2, 300)
    ys = np.asarray(s2.bodies.x[:, 1])
    assert abs(ys[0] + 1.5) < 0.06, ys
    assert abs(ys[1] + 0.5) < 0.12, ys


def test_sustained_push_wakes_sleeper():
    """The creeping-pile anchor fix (VERDICT r2 weak 8, PhysX island-wake
    case): a body creeping into a sleeper at a speed BELOW wake_speed (so
    the instantaneous approach-speed rule never fires) but above
    sleep_velocity must wake it after wake_push_frames of sustained
    contact approach — otherwise the sleeper anchors the pile forever.
    Friction is zeroed so the creep is sustained rather than braking out
    within a couple of frames."""
    import dataclasses

    cfg = dataclasses.replace(
        PCFG, dynamic_friction=0.0, static_friction=0.0
    )
    s = build_scene(
        make_pieces([[0, -1.49, 0], [1.02, -1.49, 0]], [0, 1]), cfg
    )
    step = jax.jit(lambda s: physics_step(s, cfg))
    for _ in range(120):  # both settle and sleep, resting side by side
        s = step(s)
    assert int(s.sleep_frames[0]) >= cfg.sleep_frames
    x0_sleep = float(s.bodies.x[0, 0])
    # Push body 1 toward body 0 at creep speed every frame (modelling the
    # sustained pressure of a pile behind it): above sleep_velocity
    # (0.05), below wake_speed (0.2). A one-shot shove is absorbed by the
    # static sleeper in ~2 frames and proves nothing.
    for _ in range(90):
        v = s.bodies.v.at[1, 0].set(-0.12)
        s = dataclasses.replace(
            s,
            bodies=dataclasses.replace(s.bodies, v=v),
            sleep_frames=s.sleep_frames.at[1].set(0),
        )
        s = step(s)
    # The sleeper woke and yielded (any finite displacement proves the
    # sleep state broke).
    assert abs(float(s.bodies.x[0, 0]) - x0_sleep) > 1e-3, (
        "sleeping body anchored against a creeping neighbor"
    )


def test_narrowphase_step_matches_f64():
    """The SAT + manifold narrowphase in float32 against the same step in
    float64. Compared as SINGLE steps from independent random states with
    strong rotations: a settling trajectory aligns boxes face-to-face where
    several SAT axes tie at the same penetration, and the first-of-ties
    pick then depends on rounding. Strongly rotated overlapping boxes have
    unique SAT minima, so agreement there is a real correctness check."""
    import dataclasses as dc

    from surtr_tpu.physics.rigid import quat_normalize

    def one_step(seed, dtype):
        with jax.enable_x64(dtype == jnp.float64):
            k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
            f32 = jnp.float32
            # Overlapping cluster + one grounded + one far-away box.
            offs = jnp.concatenate(
                [
                    jax.random.uniform(k1, (3, 3), f32, -0.6, 0.6)
                    + jnp.asarray([0.0, -0.8, 0.0]),
                    jnp.asarray([[5.0, -1.45, 0.0]]),
                ]
            )
            s = build_scene(make_pieces(offs.tolist(), list(range(4))), PCFG)
            q = quat_normalize(
                s.bodies.q + 0.35 * jax.random.normal(k2, (4, 4), f32)
            )
            v = 0.5 * jax.random.normal(k3, (4, 3), f32)
            s = dc.replace(s, bodies=dc.replace(s.bodies, q=q, v=v))
            s = jax.tree_util.tree_map(
                lambda a: a.astype(dtype) if a.dtype == f32 else a, s
            )
            s1 = jax.jit(lambda s: physics_step(s, PCFG))(s)
            return (np.asarray(s1.bodies.v, np.float64),
                    np.asarray(s1.bodies.w, np.float64))

    for seed in range(8):
        v32, w32 = one_step(seed, jnp.float32)
        v64, w64 = one_step(seed, jnp.float64)
        np.testing.assert_allclose(v32, v64, atol=2e-5, err_msg=f"seed {seed}")
        np.testing.assert_allclose(w32, w64, atol=2e-5, err_msg=f"seed {seed}")


@pytest.mark.slow
def test_broadphase_sorted_vs_exact_on_dense_pile():
    """VERDICT r2 item 5: quantify the Morton-window approximation on a
    dense pile. The sorted sweep misses a measured ~20-30% of the exact
    top-K pairs at window=32 (documented in ROADMAP; uniform-scale
    quantization keeps it in that band on anisotropic scenes too) — this
    test BOUNDS the miss rate and checks the behavioral consequence:
    both piles must settle to the same height profile."""
    import dataclasses

    from surtr_tpu.physics.step import _broadphase, _broadphase_sorted

    rng = np.random.RandomState(7)
    side = 6
    n = side**3  # 216
    idx = np.arange(n)
    xs = np.stack(
        [idx % side, (idx // side) % side, idx // side**2], 1
    ).astype(np.float32)
    offs = xs * 1.05 + rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    offs[:, 1] -= 1.45

    centers = jnp.asarray(offs)
    lo = centers - 0.55
    hi = centers + 0.55
    owner = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), bool)
    K = 8
    pe, oke = _broadphase(centers, lo, hi, owner, valid, K, 512)
    ps, oks = _broadphase_sorted(centers, lo, hi, owner, valid, K, 32)

    def pairs(pi, ok):
        pi, ok = np.asarray(pi), np.asarray(ok)
        i, k = np.nonzero(ok)
        j = pi[i, k]
        return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))

    se, ss = pairs(pe, oke), pairs(ps, oks)
    miss = len(se - ss) / max(len(se), 1)
    assert miss <= 0.35, f"Morton-window miss rate {miss:.2%} exceeds bound"

    # Behavioral equivalence: both broadphases settle the pile to the same
    # height profile (missed candidates redistribute contacts, they must
    # not let the pile sink or interpenetrate).
    cfg_e = dataclasses.replace(
        PCFG, broadphase="auto", single_piece_bodies=True
    )
    cfg_s = dataclasses.replace(
        PCFG, broadphase="sorted", single_piece_bodies=True
    )
    s0 = build_scene(make_pieces(offs.tolist(), list(range(n))), cfg_e)
    # ~1.25 s — the 1.45-unit drop settles by ~0.9 s. One scanned dispatch
    # per config (300 per-step dispatches dominated this test's runtime).
    run_e = jax.jit(
        lambda s: jax.lax.scan(
            lambda c, _: (physics_step(c, cfg_e), None), s, None, length=150
        )[0]
    )
    run_s = jax.jit(
        lambda s: jax.lax.scan(
            lambda c, _: (physics_step(c, cfg_s), None), s, None, length=150
        )[0]
    )
    s_e, s_s = run_e(s0), run_s(s0)
    ye = np.sort(np.asarray(s_e.bodies.x[:, 1]))
    ys = np.sort(np.asarray(s_s.bodies.x[:, 1]))
    # Bulk structure stays comparable. The measured gap (sorted settles
    # ~0.14 higher on this pile) IS the behavioral cost of the window
    # approximation — the bound here is a regression tripwire, not a
    # claim of equivalence (ROADMAP documents the honest fix options).
    # (Per-layer profiles diverge chaotically — topple patterns differ —
    # so only bulk statistics are asserted.)
    assert abs(ye.mean() - ys.mean()) < 0.2, (ye.mean(), ys.mean())
    # nothing sank through the ground
    assert ys.min() > -1.7 and ye.min() > -1.7


def test_broadphase_grid_full_recall_on_dense_pile():
    """The grid-bucket broadphase (default above one sweep block) must
    reproduce the exact sweep's pair set on a dense jittered pile — its
    only approximation is the per-bucket cap, which this pile (≈1 piece
    per cell, cap 8) never hits. Tie-breaking between equidistant K-th
    candidates is the only tolerated difference."""
    from surtr_tpu.physics.step import _broadphase, _broadphase_grid

    rng = np.random.RandomState(11)
    side = 6
    n = side**3
    idx = np.arange(n)
    xs = np.stack(
        [idx % side, (idx // side) % side, idx // side**2], 1
    ).astype(np.float32)
    offs = xs * 1.05 + rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)

    centers = jnp.asarray(offs)
    lo = centers - 0.55
    hi = centers + 0.55
    owner = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones((n,), bool)
    K = 8
    pe, oke = _broadphase(centers, lo, hi, owner, valid, K, 512)
    pg, okg = _broadphase_grid(centers, lo, hi, owner, valid, K, 8)

    def pairs(pi, ok):
        pi, ok = np.asarray(pi), np.asarray(ok)
        i, k = np.nonzero(ok)
        j = pi[i, k]
        return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))

    se, sg = pairs(pe, oke), pairs(pg, okg)
    miss = len(se - sg) / max(len(se), 1)
    assert miss <= 0.02, f"grid broadphase missed {miss:.2%} of exact pairs"


def test_settling_pile_single_piece_matches_general():
    """The production single-piece configuration (the physics bench's) vs
    the general path, 30 steps on a small settling pile."""
    offsets = [[0, -1.45 + 1.02 * i, 0] for i in range(4)] + [
        [1.2, -1.45, 0.0], [1.2, -0.4, 0.0]
    ]
    a, b = _single_vs_general(offsets, 30)
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x), atol=2e-4)
    np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=2e-3)


def test_island_wake_propagates_up_a_stack():
    """Island wake (VERDICT r3 item 8, PhysX wakes whole contact islands):
    a fast body striking the BOTTOM of a sleeping 3-stack must wake the
    whole stack within a few steps (wake_hops per step over the contact
    graph), not only the struck body. A LATERAL strike has ~zero normal
    approach toward the bodies above — only island propagation reaches
    them. sleep_velocity is raised above the 3-stack's Jacobi resting
    jitter (~0.09) so the stack actually sleeps first."""
    import dataclasses

    cfg = dataclasses.replace(PCFG, sleep_velocity=0.12)
    s = build_scene(
        make_pieces(
            [[0, -1.49, 0], [0, -0.47, 0], [0, 0.55, 0]], [0, 1, 2]
        ),
        cfg,
    )
    step = jax.jit(lambda s: physics_step(s, cfg))
    for _ in range(240):
        s = step(s)
    assert bool(jnp.all(s.sleep_frames >= cfg.sleep_frames)), np.asarray(
        s.sleep_frames
    )
    # Strike the bottom body laterally, fast (above wake_speed).
    s = type(s)(
        **{
            **{f: getattr(s, f) for f in s.__dataclass_fields__},
            "bodies": type(s.bodies)(
                **{
                    **{
                        f: getattr(s.bodies, f)
                        for f in s.bodies.__dataclass_fields__
                    },
                    "v": s.bodies.v.at[0, 0].set(1.5),
                },
            ),
            "sleep_frames": s.sleep_frames.at[0].set(0),
        }
    )
    for _ in range(8):
        s = step(s)
    # Bodies 1 and 2 never see a fast approach directly at first — the
    # island propagation must reset their counters.
    frames = np.asarray(s.sleep_frames)
    assert frames[1] < cfg.sleep_frames, frames
    assert frames[2] < cfg.sleep_frames, frames


def test_all_asleep_step_is_identity():
    """skip_all_asleep: stepping a fully sleeping scene leaves every body
    field bitwise unchanged (the lax.cond identity branch)."""
    s = build_scene(make_pieces([[0, -1.49, 0], [3, -1.49, 0]], [0, 1]), PCFG)
    s = run(s, 200)
    assert bool(jnp.all(s.sleep_frames >= PCFG.sleep_frames))
    s2 = run(s, 5)
    for f in ("x", "q", "v", "w"):
        assert np.array_equal(
            np.asarray(getattr(s.bodies, f)), np.asarray(getattr(s2.bodies, f))
        ), f


def test_five_stack_single_piece_matches_general():
    """A 5-high stack, 120 steps: the single-piece and general solver paths
    give the same trajectory, and the stack holds."""
    a, b = _single_vs_general(
        [[0, -1.45 + 1.02 * i, 0] for i in range(5)], 120
    )
    for f in ("x", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), atol=1e-4
        )
    ys = np.asarray(a.x[:5, 1])
    for i in range(5):
        assert abs(ys[i] - (-1.5 + 1.0 * i)) < 0.1, ys
