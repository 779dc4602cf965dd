"""Connected-component labeling over triangle soups and adjacency matrices.

Replaces the reference's recursive DFS flood fills:
  * mesh islands — recursion over vertex-adjacency rings
    (_MeshIslandLoop / CheckMeshIsland, /root/reference/Src/Surtr.cpp:2157-2201)
  * convex-island flood fill over the piece contact graph
    (HandleConvexIsland queue fill, Surtr.cpp:2325-2352)

Design: iterative min-label propagation with pointer jumping (log-depth),
and boolean reachability powering (matrix products) for the piece graph.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


MATMUL_MAX_T = 64


@functools.partial(jax.jit, static_argnames=("method",))
def tri_soup_components(
    corners: jax.Array,
    tri_valid: jax.Array,
    tol: float = 1e-5,
    method: str | None = None,
):
    """Component label per triangle; triangles sharing a (near-)identical
    corner position are connected.

    corners: (T, 3, 3); returns (T,) i32 labels (min triangle index of the
    component; invalid triangles get T).

    Design: one corner-coincidence pass (exact equality of tol-quantized
    coordinate triples — a multiply-XOR spatial hash collides
    systematically on symmetric meshes and sorted-run unioning costs a
    batched sort at fracture scale) reduces to a (T, T) triangle
    adjacency, closed by one of two schemes (``method``):

    * ``"matmul"``: ceil(log2 T) boolean matrix squarings in bf16 (0/1
      exact in bf16; counts accumulate in f32). O(T³) per squaring.
    * ``"jump"``: min-label relaxation over adjacency rows plus pointer
      jumping (``lab ← lab[lab]``), repeated to a fixed point. O(T²) per
      round; the round count depends on the soup.

    Both are exact. The default picks by size: ``"matmul"`` up to
    MATMUL_MAX_T triangles, ``"jump"`` above.
    """
    if method is None:
        method = "matmul" if corners.shape[0] <= MATMUL_MAX_T else "jump"
    T = corners.shape[0]
    q = jnp.round(corners / tol).astype(jnp.int32)       # (T, 3, 3)
    # Triangle adjacency via 9 fused corner-pair equality tests — an
    # explicit (3T, 3T) coincidence matrix materializes ~40 MB per fracture
    # event and dominated the labeling cost.
    adj = jnp.zeros((T, T), bool)
    for a in range(3):
        for b in range(3):
            adj = adj | jnp.all(
                q[:, None, a, :] == q[None, :, b, :], axis=-1
            )
    adj = adj & tri_valid[:, None] & tri_valid[None]
    idx = jnp.arange(T, dtype=jnp.int32)
    if method == "matmul":
        rb = (adj | jnp.eye(T, dtype=bool)).astype(jnp.bfloat16)
        for _ in range(max(1, (T - 1).bit_length())):
            acc = jnp.dot(rb, rb, preferred_element_type=jnp.float32)
            rb = (acc > 0.5).astype(jnp.bfloat16)
        reach = rb > 0.5
        label = jnp.min(jnp.where(reach, idx[None, :], T), axis=1)
        return jnp.where(tri_valid, label, T)

    def relax_jump(lab):
        nb = jnp.min(jnp.where(adj, lab[None, :], T), axis=1)
        lab = jnp.minimum(lab, nb)
        return jnp.minimum(lab, lab[jnp.clip(lab, 0, T - 1)])

    def body(carry):
        lab, _ = carry
        nxt = relax_jump(lab)
        return nxt, jnp.any(nxt != lab)

    # Labels only decrease, so the loop ends; at its fixed point every edge
    # joins equal labels and each label is its component's least index.
    lab, _ = jax.lax.while_loop(
        lambda c: c[1], body, (jnp.where(tri_valid, idx, T), jnp.bool_(True))
    )
    return jnp.where(tri_valid, lab, T)


@functools.partial(jax.jit, static_argnames=())
def adjacency_components(adj: jax.Array, valid: jax.Array):
    """Component label per node from a boolean adjacency matrix.

    Uses log-step boolean "matrix powering" (reachability closure) — each step
    squares the reachability relation with one matrix product — then labels
    each node by
    the smallest reachable node index.

    adj: (N, N) bool (need not be reflexive/symmetric-clean);
    valid: (N,) bool. Returns (N,) i32 labels (min reachable index; invalid
    nodes get N).
    """
    N = adj.shape[0]
    a = (adj | adj.T) & valid[:, None] & valid[None, :]
    r = a | jnp.eye(N, dtype=bool)
    # ceil(log2(N)) squarings: r ← r ∘ r.
    steps = max(1, (N - 1).bit_length())
    # 0/1 entries are exact in bf16 and the counts accumulate in f32, so
    # the product is exact at any matmul precision.
    rb = r.astype(jnp.bfloat16)
    for _ in range(steps):
        acc = jnp.dot(rb, rb, preferred_element_type=jnp.float32)
        rb = (acc > 0.5).astype(jnp.bfloat16)
    reach = rb > 0.5
    idx = jnp.arange(N, dtype=jnp.int32)
    label = jnp.min(jnp.where(reach, idx[None, :], N), axis=1)
    return jnp.where(valid, label, N)
