"""GPU plane-fold kernel parity vs the XLA scan fold (interpret mode on CPU).

The kernel may rotate cap-face loops differently (pseudo-angle start point),
so parity is asserted on geometry invariants: volume, centroid, emptiness,
and face-plane containment — not raw slot layout. Cases cover the kernel's
padding: F not a power of two, K not a power of two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surtr_tpu.ops.clip import clip_poly_planes
from surtr_tpu.ops.clip_pallas import clip_planes_batch_pallas
from surtr_tpu.ops.moments import moments
from surtr_tpu.types import unit_cube


def _random_case(key, N=10, K=16, F=32, S=16):
    base = unit_cube(F=F, S=S)
    polys = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), base
    )
    k1, k2, k3 = jax.random.split(key, 3)
    pn = jax.random.normal(k1, (N, K, 3))
    pn = pn / jnp.linalg.norm(pn, axis=-1, keepdims=True)
    pd = jax.random.uniform(k2, (N, K), minval=-0.45, maxval=0.1)
    planes = jnp.concatenate([pn, pd[..., None]], -1)
    mask = jax.random.uniform(k3, (N, K)) > 0.3
    return polys, planes, mask


@pytest.mark.parametrize("F,K", [(32, 16), (26, 13)])
def test_pallas_matches_scan_fold(F, K):
    polys, planes, mask = _random_case(jax.random.PRNGKey(7), K=K, F=F)
    ref = jax.vmap(lambda p, pls, pm: clip_poly_planes(p, pls, pm))(
        polys, planes, mask
    )
    out = clip_planes_batch_pallas(polys, planes, mask, interpret=True)
    vr, cr = moments(ref)
    vo, co = moments(out)
    np.testing.assert_allclose(np.asarray(vr), np.asarray(vo), atol=2e-6)
    live = np.asarray(vr) > 1e-7
    np.testing.assert_allclose(
        np.asarray(cr)[live], np.asarray(co)[live], atol=2e-5
    )
    assert np.array_equal(
        np.asarray(ref.is_empty()), np.asarray(out.is_empty())
    )


@pytest.mark.parametrize("F", [32, 20])
def test_pallas_vertices_inside_all_planes(F):
    polys, planes, mask = _random_case(jax.random.PRNGKey(3), N=6, K=12, F=F)
    out = clip_planes_batch_pallas(polys, planes, mask, interpret=True)
    s = (
        jnp.einsum("nkd,nfsd->nfsk", planes[..., :3], out.face_verts)
        + planes[:, None, None, :, 3]
    )
    sm = out.slot_mask()[..., None] & mask[:, None, None, :]
    assert float(jnp.max(jnp.where(sm, s, -1.0))) < 1e-4


def test_pallas_empty_input_stays_empty():
    from surtr_tpu.types import empty_poly

    N, K = 4, 6
    polys = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), empty_poly(16, 8)
    )
    pn = jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0.1]), (N, K, 4))
    out = clip_planes_batch_pallas(
        polys, pn, jnp.ones((N, K), bool), interpret=True
    )
    assert bool(jnp.all(out.is_empty()))


def test_pallas_masked_planes_are_noops():
    polys, planes, _ = _random_case(jax.random.PRNGKey(9), N=4, K=8)
    out = clip_planes_batch_pallas(
        polys, planes, jnp.zeros((4, 8), bool), interpret=True
    )
    v, _ = moments(out)
    np.testing.assert_allclose(np.asarray(v), 1.0, atol=1e-5)


def test_pallas_degenerate_inplane_cuts():
    """Adversarial cases for the cyclic-run kernel: planes passing exactly
    through cube vertices/edges (in-plane candidates), tangent planes, and
    face-coplanar planes must match the XLA fold's volumes."""
    F, S = 32, 16
    base = unit_cube(F=F, S=S)
    cases = [
        # diagonal plane through two full edges (4 in-plane verts)
        [[1.0, 1.0, 0.0, 0.0]],
        # plane exactly through one vertex
        [[1.0, 1.0, 1.0, -1.5 * 0.5]],
        # face-coplanar plane (no-op, all kept, face in-plane)
        [[1.0, 0.0, 0.0, -0.5]],
        # tangent from outside (kills nothing)
        [[1.0, 0.0, 0.0, -0.7]],
        # successive diagonal cuts hitting earlier cap faces through verts
        [[1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 0.0]],
        # thin sliver: two nearly-parallel cuts
        [[1.0, 0.0, 0.0, -0.01], [-1.0, 0.0, 0.0, -0.01]],
        # cut that empties the polytope
        [[1.0, 0.0, 0.0, 0.6]],
    ]
    K = max(len(c) for c in cases)
    N = len(cases)
    planes = np.zeros((N, K, 4), np.float32)
    mask = np.zeros((N, K), bool)
    for i, c in enumerate(cases):
        for j, p in enumerate(c):
            n = np.asarray(p[:3], np.float32)
            ln = np.linalg.norm(n)
            planes[i, j, :3] = n / ln
            planes[i, j, 3] = p[3] / ln
            mask[i, j] = True
    polys = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), base
    )
    planes = jnp.asarray(planes)
    mask = jnp.asarray(mask)
    ref = jax.vmap(lambda p, pls, pm: clip_poly_planes(p, pls, pm))(
        polys, planes, mask
    )
    out = clip_planes_batch_pallas(polys, planes, mask, interpret=True)
    vr, _ = moments(ref)
    vo, _ = moments(out)
    np.testing.assert_allclose(np.asarray(vr), np.asarray(vo), atol=3e-6)
    assert np.array_equal(
        np.asarray(ref.is_empty()), np.asarray(out.is_empty())
    )
