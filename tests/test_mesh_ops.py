"""Tests: OBJ/model IO, triangle-soup clipping, solid queries, labeling."""

import jax.numpy as jnp
import numpy as np

from surtr_tpu.io.models import box, get_model, icosphere
from surtr_tpu.io.obj import parse_obj, weld
from surtr_tpu.ops.labels import adjacency_components, tri_soup_components
from surtr_tpu.ops.mesh_clip import clip_trisoup, point_in_mesh


def _area(c, m):
    ab = c[:, 1] - c[:, 0]
    ac = c[:, 2] - c[:, 0]
    return float(
        jnp.sum(jnp.where(m, 0.5 * jnp.linalg.norm(jnp.cross(ab, ac), axis=-1), 0))
    )


def _signed_volume(v, f):
    return float(
        np.einsum("ij,ij->i", v[f[:, 0]], np.cross(v[f[:, 1]], v[f[:, 2]])).sum()
        / 6.0
    )


def test_parse_obj_and_weld():
    txt = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
"""
    v, f = parse_obj(txt, mirror_x=False)
    assert v.shape == (4, 3)
    assert f.shape == (2, 3)  # quad fan-triangulated


def test_weld_merges_duplicates():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1.0000001, 0, 0]], np.float64)
    f = np.array([[0, 1, 2], [0, 3, 2]])
    wv, wf = weld(v, f)
    assert len(wv) == 3
    assert (wf < 3).all()


def test_models_closed_and_outward():
    for name in ("cube", "sphere", "torus", "blob"):
        v, f = get_model(name)
        assert _signed_volume(v, f) > 0, name
        # closed: every directed edge has its twin
        edges = set()
        for t in f:
            for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                assert (a, b) not in edges, name
                edges.add((a, b))
        for a, b in edges:
            assert (b, a) in edges, name


def test_clip_trisoup_half_box_area():
    v, f = box((2, 2, 2))
    corners = jnp.asarray(v[f])
    out, ov, dropped = clip_trisoup(
        corners, jnp.ones(12, bool), jnp.array([[1.0, 0, 0, 0]]),
        jnp.ones(1, bool), max_out=64,
    )
    assert np.isclose(_area(out, ov), 12.0, atol=1e-4)
    assert int(dropped) == 0


def test_clip_trisoup_by_box_planes():
    """Sphere surface clipped to a quadrant keeps ~1/8 of its area."""
    v, f = icosphere(3, 1.0)
    corners = jnp.asarray(v[f])
    planes = jnp.array(
        [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]
    )  # keep x,y,z < 0
    out, ov, dropped = clip_trisoup(
        corners, jnp.ones(len(f), bool), planes, jnp.ones(3, bool), max_out=2048
    )
    full = _area(corners, jnp.ones(len(f), bool))
    assert np.isclose(_area(out, ov), full / 8.0, rtol=0.02)
    assert int(dropped) == 0


def test_point_in_mesh_box_and_torus():
    v, f = box((2, 2, 2))
    pts = jnp.asarray(
        np.array(
            [[0, 0, 0], [0.9, 0, 0], [1.1, 0, 0], [-3, 0, 0], [0.99, 0.99, 0.99]],
            np.float32,
        )
    )
    got = point_in_mesh(pts, jnp.asarray(v[f]), jnp.ones(12, bool))
    assert got.tolist() == [True, True, False, False, True]
    v, f = get_model("torus")
    pts = jnp.asarray(np.array([[1.2, 0, 0], [0, 0, 0]], np.float32))
    got = point_in_mesh(pts, jnp.asarray(v[f]), jnp.ones(len(f), bool))
    assert got.tolist() == [True, False]


def test_tri_soup_components_two_islands():
    v1, f1 = box((1, 1, 1))
    v2, f2 = box((1, 1, 1), center=(5, 0, 0))
    corners = jnp.concatenate([jnp.asarray(v1[f1]), jnp.asarray(v2[f2])])
    lab = tri_soup_components(corners, jnp.ones(24, bool))
    assert set(np.unique(np.asarray(lab))) == {0, 12}


def test_tri_soup_components_methods_agree():
    """The matmul-closure path and the relax+jump path must label
    identically, including with a masked tail and
    a long chain (diameter stress for the jump doubling)."""
    rng = np.random.RandomState(3)
    strips = []
    # a 40-triangle strip: consecutive triangles share an edge.
    base = rng.rand(42, 3).astype(np.float32)
    for i in range(40):
        strips.append(base[[i, i + 1, i + 2]])
    # an isolated far triangle + masked-off junk
    strips.append(base[[0, 1, 2]] + 100.0)
    strips.append(rng.rand(3, 3).astype(np.float32))
    corners = jnp.asarray(np.stack(strips))
    valid = jnp.asarray([True] * 41 + [False])
    la = tri_soup_components(corners, valid, method="matmul")
    lb = tri_soup_components(corners, valid, method="jump")
    assert np.asarray(la).tolist() == np.asarray(lb).tolist()
    assert np.asarray(la)[:40].tolist() == [0] * 40


def test_adjacency_components_chain_and_isolated():
    adj = (
        jnp.zeros((6, 6), bool)
        .at[0, 1].set(True)
        .at[1, 2].set(True)
        .at[4, 5].set(True)
    )
    lab = adjacency_components(adj, jnp.ones(6, bool))
    assert np.asarray(lab).tolist() == [0, 0, 0, 3, 4, 4]
