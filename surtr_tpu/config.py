"""Configuration dataclasses.

``FractureConfig`` mirrors the reference's runtime ``FractureArgs``
(/root/reference/Inc/Surtr.h:89-110) with the same parameter names/defaults so
parity runs are config-compatible. Static shape maxima (the padded-shape
analogue of the reference's compile-time caps, Surtr.h:261-268) live here too,
since they are part of the jit cache key.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FractureConfig:
    """Runtime fracture parameters (reference: FractureArgs, Surtr.h:89-110)."""

    # Hull / fitting limits.
    ich_include_point_limit: int = 20      # ICHIncludePointLimit
    ach_plane_gap_inverse: float = 2000.0  # ACHPlaneGapInverse
    refitting_point_limit: int = 4         # RefittingPointLimit

    seed: int = 46354                      # Seed (std::mt19937 in the reference;
                                           # we mirror *seeded determinism*, not
                                           # the exact bit-stream: SURVEY.md §3)

    impact_radius: float = 1.0             # ImpactRadius
    radial_mode: bool = True               # RadialMode
    partial_fracture: bool = True          # PartialFracture
    partial_pattern_dist: float = 0.01     # PartialFracturePatternDist
    general_pattern_dist: float = 1.0      # GeneralFracturePatternDist

    initial_decompose_cell_cnt: int = 64   # InitialDecomposeCellCnt
    partial_pattern_cell_cnt: int = 128    # PartialFracturePatternCellCnt
    general_pattern_cell_cnt: int = 1024   # GeneralFracturePatternCellCnt

    target_adder: float = 0.01             # TargetAdder (impact point push-in)

    # --- static shape maxima (padded shapes; not in the reference) ---
    max_faces: int = 32          # F: faces per convex polytope
    max_face_verts: int = 16     # S: vertex slots per face loop
    max_pieces: int = 256        # piece capacity after compaction
    max_active_pieces: int = 32  # pieces clipped per fracture event (partial mode)
    voronoi_neighbors: int = 48  # k-nearest seeds whose bisectors clip a cell
    max_mesh_tris: int = 2048    # visual-mesh triangle capacity per compound
    max_piece_tris: int = 512    # visual-mesh triangle capacity per piece
    max_islands: int = 2         # distinct mesh islands DETECTED per fragment
                                 # (CheckMeshIsland, Surtr.cpp:2157-2201;
                                 # 1 disables splitting). On by default: the
                                 # solid-midpoint merge test re-joins surface
                                 # patches connected through material, so the
                                 # round-1 volume-duplication failure mode
                                 # (PARITY.md divergence 3) no longer applies.
    island_pool: int = 64        # GLOBAL capacity for secondary islands per
                                 # fracture event (islands are rare —
                                 # per-candidate slot doubling wasted 2× the
                                 # whole pipeline; 0 disables splitting)
    island_voxel_res: int = 6    # per-axis resolution of the island-merge
                                 # voxel connectivity grid (material paths
                                 # around bends — PARITY.md divergence 3);
                                 # 0 falls back to segment probes only
    island_grid_res: int = 64    # prepare-time inside-solid parity grid
                                 # resolution (per axis) replacing per-query
                                 # winding numbers against the SOURCE model
                                 # (every candidate shares one closed solid;
                                 # winding is P·T·atan2 per query batch at
                                 # model scale). 0 = exact winding.
                                 # do_fracture always uses winding (its
                                 # per-piece solids are small and only
                                 # approximately watertight).

    exact_face_overlap: bool = True
                                 # HandleConvexIsland contact test: True =
                                 # exact 2-D SAT overlap of the coplanar
                                 # face polygons (the reference's
                                 # point-in-polygon scan,
                                 # Surtr.cpp:2240-2325) — ON by default for
                                 # parity (VERDICT r2 item 7: the sphere
                                 # proxy over-glued laterally offset
                                 # fragments); False = coplanar-opposite
                                 # faces + bounding-sphere overlap
                                 # (conservative toward keeping contact,
                                 # saves a top-k + scatter per event)

    voronoi_prefix: int = 16     # two-pass Voronoi clip: fold the walls +
                                 # this many NEAREST bisectors first, then
                                 # fold the remaining bisectors masked by
                                 # the provable no-cut bound
                                 # n·s + d + R ≤ tol (R = pass-1 cell
                                 # vertex radius about its seed) — with
                                 # nearest-first sorting nearly every tail
                                 # plane is provably non-cutting, so the
                                 # fold reduces those steps to a distance
                                 # test. Exact: a masked plane cannot cut
                                 # its cell.
                                 # 0 = single-pass fold of all planes
    mesh_pair_pool: bool = True
                                 # prepare_fracture's model-scale mesh clip:
                                 # compact the live (cell, tri) pairs into
                                 # one flat pool and fold each pooled
                                 # polygon by its own cell's planes
                                 # (ops/mesh_clip.py clip_polys_by_rows)
                                 # instead of clipping per-cell uniform
                                 # pools (~90% padding at pumpkin scale).
                                 # False = the per-cell vmapped clip
                                 # (equivalence-tested). do_fracture always
                                 # runs the vmapped clip_trisoup per job.
    exact_caps: bool = True
                                 # True = exact cut-surface caps (the
                                 # reference's closed-polyhedron clip
                                 # semantics, Poly.cpp:265-554 /
                                 # VMACH.cpp:699-813): cap = convex cut
                                 # face ∩ solid cross-section, signed-fan
                                 # triangulated from the clipped surface's
                                 # on-plane edges + probed convex-edge
                                 # intervals (ops/caps.py). Fixes concave-
                                 # model overshoot (bunny convex total was
                                 # 1.705× mesh volume with the old refit-
                                 # face caps). False = caps from the refit
                                 # convex's cut faces (exact for convex
                                 # models only).
    cap_faces: int = 16          # cut faces processed per candidate (cube32
                                 # cells carry up to ~14 live cut faces;
                                 # CF=12 dropped faces and leaked volume)
    cap_edges: int = 48          # on-plane surface edges kept per cut face
    cap_crossings: int = 6       # splits per convex-face edge at crossings
                                 # with the surface cross-section
    cap_tris: int = 128          # compacted cap fan triangles per candidate
    cap_edge_pool: int = 256     # flat candidate-edge records compacted
                                 # per candidate BEFORE the inside-solid
                                 # probes (pre-probe count: real boundary
                                 # edges + tangent-plane false edges that
                                 # the probes then reject; overflow is
                                 # counted into the drop metric)
    cap_pool: int = 128          # cap boundary vertices added to the refit
                                 # vertex pool per candidate
    cap_probe_nudge: float = 1e-4
                                 # inward probe offset (× max axis scale)
                                 # for the inside-solid interval tests

    # f32 tolerance at unit scale (reference: 1e-10 in f64, Poly.cpp:718).
    plane_tol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Rigid-body parameters (reference: PhysX init, Surtr.cpp:1135-1164)."""

    dt: float = 1.0 / 120.0        # fixed step (Surtr.cpp:118-119, :330)
    gravity: float = -9.81         # (Surtr.cpp:1147)
    density: float = 10.0          # updateMassAndInertia(10) (Surtr.cpp:2520)
    static_friction: float = 0.5   # PxMaterial (Surtr.cpp:1160)
    dynamic_friction: float = 0.5
    restitution: float = 0.1
    ground_y: float = -2.0         # PxPlane(0,1,0,2) (Surtr.cpp:1527-1528)

    solver_iters: int = 8          # projected-impulse iterations (stacking
                                   # verified stable at 8; PhysX defaults to
                                   # 4+1 — Jacobi needs a few more)
    solver_substeps: int = 2       # impulse updates per partner-velocity
                                   # refresh (chaotic-relaxation Jacobi:
                                   # own-body state updates every substep,
                                   # partner velocities every refresh).
                                   # 4 was tried and REJECTED: the
                                   # 5-stack's lateral drift
                                   # is numerics-marginal there (passes in
                                   # one float environment, 0.16 m in
                                   # another); 2 is robust.
    baumgarte: float = 0.2         # positional-bias factor
    contact_slop: float = 1e-3
    bounce_threshold: float = 0.25 # approach speed below which restitution
                                   # is suppressed (PhysX
                                   # bounceThresholdVelocity semantics;
                                   # PhysX defaults to 2.0 m/s — ours keeps
                                   # resting stacks quiet at dt=1/120)
    max_neighbors: int = 8         # candidate contact pairs per body (broadphase)
    max_ground_contacts: int = 4   # deepest vertices used for ground manifold
    max_hull_verts: int = 64       # padded collision-hull vertex count
    manifold_points: int = 4       # contact points per pair (face-face
                                   # manifolds; 1 = single support point)
    max_edge_dirs: int = 3         # distinct edge directions per hull used
                                   # for SAT edge-cross axes (0 disables;
                                   # 3 covers boxes exactly, Ne² cross axes
                                   # scale the narrowphase quadratically)
    single_piece_bodies: bool = False
                                   # static promise that every body owns
                                   # exactly one piece (fully shattered
                                   # scenes): enables the gather-free solver
                                   # fast path (segment sums are identity)
    sleep_velocity: float = 0.05   # bodies slower than this (|v| and |ω|)
                                   # for sleep_frames consecutive steps go
                                   # to sleep: frozen pose, static for
                                   # partners (PhysX putToSleep semantics;
                                   # 0 disables). Stability feature — the
                                   # batched step computes masked work for
                                   # sleeping bodies either way
    sleep_frames: int = 30         # consecutive slow steps before sleeping
    wake_speed: float = 0.2        # contact approach speed that wakes a
                                   # sleeping body immediately
    wake_push_frames: int = 8      # consecutive steps of sustained contact
                                   # approach ≥ sleep_velocity that wake a
                                   # sleeping body — a creeping pile pushes
                                   # steadily (the PhysX island-wake case),
                                   # while a settling neighbor's Baumgarte
                                   # bounce cycle separates or reverses
                                   # every few frames and resets the count
    wake_hops: int = 2             # island wake: spread a wake disturbance
                                   # this many contact-graph hops per step
                                   # (PhysX wakes whole contact islands; a
                                   # support knocked out under a sleeping
                                   # stack wakes the bodies above at
                                   # hops/step). Sleep ONSET stays per-body
                                   # — atomic island sleep thrashes under
                                   # the Jacobi solver (see step.py note).
                                   # 0 = wake on direct approach only
    skip_all_asleep: bool = True   # lax.cond the whole contact/solve stage
                                   # out when EVERY active body is asleep —
                                   # a fully settled scene costs one
                                   # predicate instead of a full step

    broadphase_block: int = 512    # row-block size for the k-nearest sweep
    broadphase: str = "auto"       # "auto" = blocked all-pairs
                                   #   sweep: FULL RECALL at every size
                                   #   (the PhysX no-missed-pairs
                                   #   contract);
                                   # "sorted" = Morton-window sweep
                                   #   (O(N·W); misses spatial neighbors
                                   #   > window apart in Morton order — a
                                   #   measured 20-30% of exact top-K
                                   #   pairs on dense piles);
                                   # "grid" = uniform-grid buckets: full
                                   #   recall up to broadphase_bucket_cap
                                   #   pieces per probed cell.
    broadphase_window: int = 32    # sorted-order neighbors tested per side
    broadphase_bucket_cap: int = 8 # grid: members tested per probed cell
                                   # (27 cells ⇒ ≤ 216 exact AABB tests
                                   # per piece)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Software-rasterizer parameters (reference: Surtr.cpp:370-664, shaders)."""

    width: int = 512
    height: int = 512
    shadow_size: int = 512         # reference clamps 4096-8192 on a GPU with
                                   # hardware raster (SurtrArgument.h:36);
                                   # here the shadow pass is a full software
                                   # raster, so the default matches the
                                   # image resolution (512² ≈ no visible
                                   # quality delta at these scene scales).
                                   # Configurable.
    ambient: float = 0.08          # Shader.hlsli ambient term
    pcf_taps: int = 3              # 3x3 = 9-tap PCF (Shader.hlsli:97-126)
    fov_deg: float = 45.0
    z_near: float = 0.01
    z_far: float = 500.0
    tile: int = 16                 # raster tile edge (pixels)
    tris_per_tile: int = 256       # binning capacity per tile
    depth_bias: float = 4e-3       # shadow-depth bias (reference PSO bias 100000)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    fracture: FractureConfig = dataclasses.field(default_factory=FractureConfig)
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
