"""The pooled soup clip (``clip_polys_by_rows``) against a float64 NumPy
Sutherland–Hodgman reference, in-plane drop rule included."""

import jax.numpy as jnp
import numpy as np

from surtr_tpu.ops.mesh_clip import clip_polys_by_rows, fan_triangles

TOL = 1e-6


def _random_case(seed, P=300, C=16, K=12, coplanar=False):
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1, 1, (P, 3, 3)).astype(np.float32)
    valid = rng.uniform(size=P) > 0.1
    # Grouped-by-cell ids (the pool invariant).
    cell = np.sort(rng.integers(0, C, P)).astype(np.int32)
    n = rng.normal(size=(C, K, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (C, K, 1)).astype(np.float32)
    planes = np.concatenate([n, d], axis=-1)
    pmask = rng.uniform(size=(C, K)) > 0.15
    if coplanar:
        # Triangle 0 lies exactly in its cell's plane 0 → the in-plane drop
        # rule fires when that plane removes material elsewhere in the cell.
        c0 = int(cell[0])
        planes[c0, 0] = [0, 0, 1, 0]
        pmask[c0, 0] = True
        tris[0] = [[0.2, 0.0, 0.0], [0.0, 0.3, 0.0], [-0.2, -0.1, 0.0]]
        valid[0] = True
    return tris, valid, cell, planes, pmask


def _oracle(tris, valid, cell, planes, pmask):
    """Per-polygon f64 SH clip; returns polygon areas (0 = clipped away)."""
    P, K = len(tris), planes.shape[1]
    polys = [t.astype(np.float64) if v else None for t, v in zip(tris, valid)]
    for k in range(K):
        dists = []
        for i, p in enumerate(polys):
            pl = planes[cell[i], k].astype(np.float64)
            dists.append(None if p is None else p @ pl[:3] + pl[3])
        # In-plane rule context: does plane k remove material in the cell?
        removes = np.zeros(planes.shape[0], bool)
        for i, dd in enumerate(dists):
            if dd is not None and pmask[cell[i], k] and (dd > TOL).any():
                removes[cell[i]] = True
        for i, p in enumerate(polys):
            if p is None or not pmask[cell[i], k]:
                continue
            dd = dists[i]
            if (np.abs(dd) <= TOL).all() and removes[cell[i]]:
                polys[i] = None
                continue
            out = []
            for j in range(len(p)):
                a, b, da, db = p[j], p[(j + 1) % len(p)], dd[j], dd[(j + 1) % len(p)]
                if da <= TOL:
                    out.append(a)
                if (da < -TOL and db > TOL) or (da > TOL and db < -TOL):
                    out.append((a * db - b * da) / (db - da))
            polys[i] = np.array(out) if len(out) >= 3 else None
    area = np.zeros(P)
    for i, p in enumerate(polys):
        if p is not None:
            area[i] = 0.5 * np.linalg.norm(
                np.cross(p[1:-1] - p[0], p[2:] - p[0]).sum(0)
            )
    return area


def _compare(seed, **kw):
    tris, valid, cell, planes, pmask = _random_case(seed, **kw)
    C = planes.shape[0]
    pstart = jnp.asarray(
        np.searchsorted(cell, np.arange(C + 1)).astype(np.int32)
    )
    poly, nv, drops = clip_polys_by_rows(
        jnp.asarray(tris), jnp.asarray(valid),
        jnp.asarray(planes[cell]), jnp.asarray(pmask[cell]),
        seg_starts=pstart, seg_id=jnp.asarray(cell),
    )
    assert int(drops) == 0
    fans, fcnt = fan_triangles(poly, nv)
    fans, fcnt = np.asarray(fans, np.float64), np.asarray(fcnt)
    live = np.arange(fans.shape[1])[None] < fcnt[:, None]
    tri_area = 0.5 * np.linalg.norm(
        np.cross(fans[..., 1, :] - fans[..., 0, :],
                 fans[..., 2, :] - fans[..., 0, :]), axis=-1,
    )
    got = np.where(live, tri_area, 0.0).sum(1)
    want = _oracle(tris, valid, cell, planes, pmask)
    np.testing.assert_allclose(got, want, atol=2e-5)
    return got, want


def test_soup_clip_matches_oracle_random():
    _compare(0)
    _compare(7)


def test_soup_clip_inplane_rule():
    got, want = _compare(3, coplanar=True)
    assert got[0] == 0.0 and want[0] == 0.0
