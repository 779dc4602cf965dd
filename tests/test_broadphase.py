"""The exact broadphase against a NumPy brute-force K-nearest reference.

``"auto"`` runs the blocked all-pairs sweep (``step._broadphase``) at every
pool size: each piece's K nearest AABB-overlapping partners (other owner,
both valid), nearest first. The reference enumerates every pair in NumPy.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surtr_tpu.config import PhysicsConfig
from surtr_tpu.physics.step import _broadphase, _broadphase_select


def _brute_force(centers, lo, hi, owner, valid, K):
    """Per row: the K smallest squared center distances over candidates."""
    c = np.asarray(centers, np.float32)
    lo, hi = np.asarray(lo), np.asarray(hi)
    owner, valid = np.asarray(owner), np.asarray(valid)
    n = len(c)
    d2 = ((c[:, None] - c[None]) ** 2).sum(-1)
    ok = (
        np.all((lo[:, None] <= hi[None]) & (lo[None] <= hi[:, None]), -1)
        & (owner[:, None] != owner[None])
        & valid[:, None] & valid[None]
        & ~np.eye(n, dtype=bool)
    )
    d2 = np.where(ok, d2, np.inf)
    return np.sort(d2, axis=1)[:, :K], ok


def _check(centers, owner, valid, K=4, half=0.6, block=64):
    centers = jnp.asarray(centers, jnp.float32)
    half = jnp.broadcast_to(jnp.asarray(half, jnp.float32), centers.shape)
    lo, hi = centers - half, centers + half
    owner = jnp.asarray(owner, jnp.int32)
    valid = jnp.asarray(valid)
    pidx, pok = jax.jit(_broadphase, static_argnums=(5, 6))(
        centers, lo, hi, owner, valid, K, block
    )
    pidx, pok = np.asarray(pidx), np.asarray(pok)
    want, ok = _brute_force(centers, lo, hi, owner, valid, K)
    c = np.asarray(centers)
    got = np.where(pok, ((c[:, None] - c[pidx]) ** 2).sum(-1), np.inf)
    # Recall 1.0: the selected distances ARE the K smallest (ties may pick
    # either tied partner, which leaves the distance multiset unchanged).
    np.testing.assert_allclose(np.sort(got, axis=1), want, rtol=1e-6)
    rows = np.arange(len(c))[:, None]
    assert ok[rows, pidx][pok].all()          # every live slot is legal
    return pidx, pok


def test_broadphase_exact_matches_bruteforce_random():
    rng = np.random.default_rng(3)
    n = 257
    centers = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    _check(centers, np.arange(n), np.ones(n, bool))


def test_broadphase_exact_matches_bruteforce_lattice_ties():
    # A regular lattice has many distance ties.
    side = 6
    g = np.arange(side, dtype=np.float32) * 1.02
    centers = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    n = len(centers)
    _check(centers, np.arange(n), np.ones(n, bool))


def test_broadphase_exact_invalid_and_shared_owner():
    rng = np.random.default_rng(11)
    n = 140
    centers = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    owner = np.arange(n) // 2            # pairs share owners: no self-contact
    valid = rng.uniform(size=n) > 0.2
    pidx, pok = _check(centers, owner, valid)
    assert not pok[~valid].any()
    assert not (pok & (owner[pidx] == owner[:, None])).any()


@pytest.mark.parametrize("n", [700, 512 + 1])
def test_broadphase_exact_padded_blocks(n):
    """Pools that are not a multiple of the sweep block (padding rows must
    never pair), with random half-extents."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    half = rng.uniform(0.2, 0.6, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    _check(centers, np.arange(n), valid, K=8, half=half, block=256)


def test_broadphase_exact_dense_pile():
    """Dense lattice pile (the Morton window's worst case): every
    face-neighbor pair (strictly nearer than any tie group) is mutual-kept,
    and everything kept is symmetric."""
    side = 9
    g = np.arange(side, dtype=np.float32) * 1.02
    centers = np.stack(
        np.meshgrid(g, g, g, indexing="ij"), -1
    ).reshape(-1, 3)
    n = len(centers)
    c = jnp.asarray(centers)
    half = jnp.full((n, 3), 0.52)
    pidx, pok = _broadphase_select(
        c, c - half, c + half, jnp.arange(n, dtype=jnp.int32),
        jnp.ones((n,), bool), PhysicsConfig(broadphase_block=128),
    )
    pi, po = np.asarray(pidx), np.asarray(pok)
    kept = {(i, int(pi[i, k])) for i in range(n) for k in range(8) if po[i, k]}
    idx = np.arange(n).reshape(side, side, side)
    missing = []
    for ax in range(3):
        a = np.moveaxis(idx, ax, 0)
        for i, j in zip(a[:-1].ravel(), a[1:].ravel()):
            if (int(i), int(j)) not in kept or (int(j), int(i)) not in kept:
                missing.append((int(i), int(j)))
    assert not missing, (len(missing), missing[:5])
    assert all((j, i) in kept for (i, j) in kept)


def test_auto_broadphase_full_recall_above_block():
    """broadphase="auto" beyond one sweep block (Np > 512) keeps full recall
    and warns about nothing: the mutual pair set equals the brute-force
    mutual K-nearest set."""
    rng = np.random.default_rng(2)
    n, K = 600, 8
    centers = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    half = rng.uniform(0.3, 0.9, (n, 3)).astype(np.float32)
    c = jnp.asarray(centers)
    lo, hi = c - half, c + half
    cfg = PhysicsConfig(max_neighbors=K)
    assert n > cfg.broadphase_block
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pidx, pok = jax.jit(_broadphase_select, static_argnums=(5,))(
            c, lo, hi, jnp.arange(n, dtype=jnp.int32),
            jnp.ones((n,), bool), cfg,
        )
    want, ok = _brute_force(c, lo, hi, np.arange(n), np.ones(n, bool), K)
    d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    d2 = np.where(ok, d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :K]
    live = np.take_along_axis(d2, order, 1) < np.inf
    ref = {(i, int(j)) for i in range(n) for j, l in zip(order[i], live[i]) if l}
    ref = {(i, j) for (i, j) in ref if (j, i) in ref}
    pi, po = np.asarray(pidx), np.asarray(pok)
    got = {(i, int(pi[i, k])) for i in range(n) for k in range(K) if po[i, k]}
    assert got == ref
