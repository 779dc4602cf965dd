"""Unit tests for the scatter-free linalg primitives (compaction, packing,
small contractions) — these carry the scatter-free kernel designs."""

import jax
import jax.numpy as jnp
import numpy as np

from surtr_tpu.ops.linalg import compact, matvec3, pack_rows, rot_points, supports


def test_compact_matches_numpy():
    rng = np.random.default_rng(0)
    for _ in range(5):
        E = 40
        vals = rng.normal(size=(E, 3)).astype(np.float32)
        flags = rng.random(E) < 0.4
        out, n = compact(jnp.asarray(vals), jnp.asarray(flags), 16)
        want = vals[flags][:16]
        assert int(n) == min(flags.sum(), 16)
        assert np.allclose(np.asarray(out)[: len(want)], want)
        assert np.all(np.asarray(out)[len(want):] == 0)


def test_compact_batched():
    vals = jnp.arange(24, dtype=jnp.float32).reshape(2, 4, 3)
    flags = jnp.asarray([[True, False, True, False], [False, False, False, True]])
    out, n = compact(vals, flags, 3)
    assert n.tolist() == [2, 1]
    assert np.allclose(np.asarray(out[0, 0]), [0, 1, 2])
    assert np.allclose(np.asarray(out[0, 1]), [6, 7, 8])
    assert np.allclose(np.asarray(out[1, 0]), [21, 22, 23])


def test_pack_rows_matches_concatenation():
    rng = np.random.default_rng(1)
    T, S, D = 7, 5, 3
    vals = rng.normal(size=(T, S, D)).astype(np.float32)
    counts = rng.integers(0, S + 1, size=T)
    out, total = pack_rows(
        jnp.asarray(vals), jnp.asarray(counts.astype(np.int32)), 32
    )
    want = np.concatenate([vals[r, : counts[r]] for r in range(T)])
    assert int(total) == min(counts.sum(), 32)
    assert np.allclose(np.asarray(out)[: len(want)], want)
    assert np.all(np.asarray(out)[len(want):] == 0)


def test_pack_rows_truncates():
    vals = jnp.ones((4, 4, 2))
    counts = jnp.asarray([4, 4, 4, 4], jnp.int32)
    out, total = pack_rows(vals, counts, 10)
    assert int(total) == 10
    assert np.asarray(out).shape == (10, 2)


def test_supports_and_matvec_match_einsum():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    s = supports(jnp.asarray(v), jnp.asarray(d))
    assert np.allclose(np.asarray(s), v @ d.T, atol=1e-6)
    m = rng.normal(size=(5, 3, 3)).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    assert np.allclose(
        np.asarray(matvec3(jnp.asarray(m), jnp.asarray(x))),
        np.einsum("bij,bj->bi", m, x),
        atol=1e-6,
    )
    p = rng.normal(size=(5, 7, 3)).astype(np.float32)
    assert np.allclose(
        np.asarray(rot_points(jnp.asarray(m), jnp.asarray(p))),
        np.einsum("bij,bnj->bni", m, p),
        atol=1e-6,
    )
