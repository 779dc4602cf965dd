"""Global z-ray parity grid vs exact winding-number solid tests.

The grid replaces per-query winding numbers in prepare-time island
connectivity (same closed source solid for every candidate); these tests pin
its agreement with the exact oracle away from the surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surtr_tpu.io.models import get_model
from surtr_tpu.ops.mesh_clip import (
    build_parity_grid,
    parity_grid_inside,
    winding_inside,
)


@pytest.mark.parametrize("model", ["cube", "sphere"])
def test_parity_grid_matches_winding(model):
    v, f = get_model(model)
    corners = jnp.asarray(v[f])
    tmask = jnp.ones(len(f), bool)
    grid = jax.jit(lambda c, m: build_parity_grid(c, m, res=48))(
        corners, tmask
    )

    lo = np.asarray(v).min(0)
    hi = np.asarray(v).max(0)
    ext = hi - lo
    rng = np.random.RandomState(0)
    pts = jnp.asarray(
        (lo - 0.2 * ext) + rng.rand(512, 3) * (1.4 * ext), jnp.float32
    )
    got = np.asarray(parity_grid_inside(grid, pts))
    want = np.asarray(winding_inside(pts, corners, tmask))

    # Disagreement is allowed only within a cell of the surface (the grid
    # snaps queries to cell centers). "Far from the surface" = the exact
    # classification is constant over a one-cell ball around the point
    # (checked at the 6 axis offsets).
    cell = float(np.max(ext) / 48)
    offs = cell * np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    nb = np.stack(
        [
            np.asarray(winding_inside(pts + o[None], corners, tmask))
            for o in offs
        ],
        axis=1,
    )
    far = (nb == want[:, None]).all(axis=1)
    assert far.sum() > 100  # the probe cloud actually exercises the test
    np.testing.assert_array_equal(got[far], want[far])


def test_parity_grid_outside_bbox_is_outside():
    v, f = get_model("cube")
    corners = jnp.asarray(v[f])
    grid = build_parity_grid(corners, jnp.ones(len(f), bool), res=16)
    far = jnp.asarray([[50.0, 0.0, 0.0], [0.0, -50.0, 0.0]], jnp.float32)
    assert not bool(parity_grid_inside(grid, far).any())


def _union_find_labels(corners, valid, tol=1e-5):
    """Min-index component labels of triangles sharing a quantized corner."""
    T = len(corners)
    parent = list(range(T))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    owner = {}
    q = np.round(corners / tol).astype(np.int64)
    for t in range(T):
        if not valid[t]:
            continue
        for c in range(3):
            key = tuple(q[t, c])
            if key in owner:
                a, b = find(t), find(owner[key])
                parent[max(a, b)] = min(a, b)
            else:
                owner[key] = t
    return np.array([find(t) if valid[t] else T for t in range(T)])


@pytest.mark.parametrize("method", ["jump", "matmul", None])
def test_labels_match_union_find(method):
    """Both soup-labeling closures == a NumPy union-find on a batch of
    candidate-like soups (strip, two strips, empty, half-valid)."""
    from surtr_tpu.ops.labels import tri_soup_components

    rng = np.random.RandomState(3)
    N, T = 6, 16
    corners = rng.rand(N, T, 3, 3).astype(np.float32)
    # Candidate 0: a strip (every tri shares a corner with the next).
    for t in range(T - 1):
        corners[0, t + 1, 0] = corners[0, t, 1]
    # Candidate 1: two strips (break in the middle).
    for t in range(T - 1):
        if t != T // 2 - 1:
            corners[1, t + 1, 0] = corners[1, t, 1]
    valid = np.ones((N, T), bool)
    valid[2, :] = False                 # empty candidate
    valid[3, T // 2 :] = False          # half-valid
    got = jax.vmap(
        lambda c, v: tri_soup_components(c, v, method=method)
    )(jnp.asarray(corners), jnp.asarray(valid))
    want = np.stack(
        [_union_find_labels(corners[i], valid[i]) for i in range(N)]
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_refit_planes_are_supporting_slabs():
    """Batched refit (tetra hull + k-DOP at gap 0): every live slab plane
    has a unit normal, supports its point pool (no point outside, some
    point on it), and comes paired with its opposite; pools with fewer
    than 4 points get no planes."""
    from surtr_tpu.fracture.pipeline import refit_planes

    rng = np.random.RandomState(5)
    N, Pv = 5, 40
    pool = rng.randn(N, Pv, 3).astype(np.float32)
    mask = rng.rand(N, Pv) > 0.3
    mask[3, 4:] = False             # degenerate: too few points
    mask[3, :3] = True
    mask[4, :] = False              # all masked
    planes, pm = jax.vmap(lambda v, m: refit_planes(v, m, 4))(
        jnp.asarray(pool), jnp.asarray(mask)
    )
    planes, pm = np.asarray(planes, np.float64), np.asarray(pm)
    assert not pm[3].any() and not pm[4].any()
    for i in range(3):
        pts = pool[i][mask[i]].astype(np.float64)
        live = planes[i][pm[i]]
        assert len(live) >= 8
        np.testing.assert_allclose(
            np.linalg.norm(live[:, :3], axis=1), 1.0, atol=1e-5
        )
        s = pts @ live[:, :3].T + live[:, 3]
        assert s.max() < 1e-4
        np.testing.assert_allclose(s.max(axis=0), 0.0, atol=1e-4)
        for n in live[:, :3]:
            assert (np.abs(live[:, :3] + n).sum(1) < 1e-5).any()


def test_ich_matches_scipy_hull():
    """The greedy ICH is the convex hull of the points it inserted: faces
    are outward, every inserted point is inside every face, and its volume
    equals scipy's hull of those points (the full hull for the cube)."""
    from scipy.spatial import ConvexHull

    from surtr_tpu.io.models import get_model
    from surtr_tpu.ops.hull import ich

    rng = np.random.RandomState(7)
    clouds = [
        np.asarray(get_model("cube")[0], np.float32),
        rng.randn(40, 3).astype(np.float32),
        (rng.rand(100, 3) * np.array([2.0, 1.0, 0.5])).astype(np.float32),
    ]
    for pts in clouds:
        h = ich(jnp.asarray(pts), jnp.ones(len(pts), bool), limit=20)
        fv = np.asarray(h["face_valid"])
        faces = np.asarray(h["faces"])[fv]
        nrm = np.asarray(h["normals"], np.float64)[fv]
        inner = np.asarray(h["inner"], np.float64)
        P = pts.astype(np.float64)
        used = np.unique(faces)
        tri = P[faces]                                   # (F, 3, 3)
        assert ((inner - tri[:, 0]) * nrm).sum(1).max() < 0
        s = (P[used][None] - tri[:, None, 0]) * nrm[:, None]
        assert s.sum(-1).max() < 1e-4
        vol = np.abs(
            np.einsum("fi,fi->f", tri[:, 0] - inner,
                      np.cross(tri[:, 1] - inner, tri[:, 2] - inner))
        ).sum() / 6.0
        np.testing.assert_allclose(vol, ConvexHull(P[used]).volume, rtol=1e-4)
        if len(pts) <= 20:
            np.testing.assert_allclose(vol, ConvexHull(P).volume, rtol=1e-4)


@pytest.mark.parametrize(
    "N,T,grid,method",
    [
        (512, 64, 4, None),
        (512, 64, 4, "jump"),
        (512, 64, 4, "matmul"),
        (64, 512, 12, None),
        (64, 512, 12, "jump"),
    ],
)
def test_default_labels_converge_on_dense_soups(N, T, grid, method):
    """Labels equal a NumPy union-find on dense random soups, at the
    interactive config's T=64 and the default config's T=512. Rows 0 and 1
    are one and two strips in shuffled triangle order (long paths). At
    T=512 relax+jump cut off at a dozen rounds left 34 of these 64 rows
    split; run to its fixed point it is exact."""
    from surtr_tpu.ops.labels import tri_soup_components

    rng = np.random.default_rng(0)
    corners = (np.round(rng.uniform(0, grid, (N, T, 3, 3))) * 0.25).astype(
        np.float32
    )
    for row, breaks in ((0, ()), (1, (T // 2 - 1,))):
        perm = rng.permutation(T)
        for t in range(T - 1):
            if t not in breaks:
                corners[row, perm[t + 1], 0] = corners[row, perm[t], 1]
    valid = rng.uniform(size=(N, T)) > 0.2
    valid[:2] = True
    want = np.stack(
        [_union_find_labels(corners[i], valid[i]) for i in range(N)]
    )
    got = jax.vmap(lambda c, v: tri_soup_components(c, v, method=method))(
        jnp.asarray(corners), jnp.asarray(valid)
    )
    np.testing.assert_array_equal(np.asarray(got), want)
