"""Batched GJK distance between convex vertex clouds.

The reference uses GJK for generic convex pairs (src/GJK.cpp, via support
points) and V-Clip for polyhedron pairs. This is the fixed-shape form: fixed
iteration count, fixed-size simplex, and the closest-point-on-simplex
subproblem solved by enumerating all 15 vertex subsets with masked
barycentric least squares (branch-free, vmappable) instead of Johnson's
recursive subalgorithm.

Support functions are vertex-cloud argmax dots; witness points on both
shapes come from the same barycentrics, giving the closest-point pair used
for contact generation and conservative advancement.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

MAX_ITERS = 32

# all nonempty subsets of {0,1,2,3}
_SUBSETS = np.array(
    [[int(bool(m & (1 << i))) for i in range(4)] for m in range(1, 16)],
    dtype=bool,
)  # (15, 4)


def _closest_on_simplex(W, active):
    """Closest point to the origin on the convex hull of active rows of W.

    W: (4, 3) simplex points; active: (4,) bool.
    Returns (point (3,), barycentrics (4,), support mask (4,)).
    """
    dtype = W.dtype
    subsets = jnp.asarray(_SUBSETS) & active[None, :]
    # drop subsets that are not exactly their pattern (i.e. inactive members)
    sub_valid = jnp.all(
        (jnp.asarray(_SUBSETS) & ~active[None, :]) == False, axis=1  # noqa: E712
    )

    def solve_subset(mask):
        m = mask.astype(dtype)
        k = jnp.sum(m)
        # minimize |sum_i b_i w_i|^2 s.t. sum b = 1, b_i = 0 off-mask
        # normal equations with a Lagrange multiplier:
        # [G 1; 1' 0][b; λ] = [0; 1],  G_ij = w_i·w_j  (masked)
        G = W @ W.T
        A = jnp.zeros((5, 5), dtype)
        A = A.at[:4, :4].set(
            jnp.where(mask[:, None] & mask[None, :], G, 0.0)
            + jnp.diag(jnp.where(mask, 0.0, 1.0).astype(dtype))
        )
        A = A.at[:4, 4].set(m)
        A = A.at[4, :4].set(m)
        rhs = jnp.zeros(5, dtype).at[4].set(1.0)
        sol = jnp.linalg.solve(A, rhs)
        b = jnp.where(mask, sol[:4], 0.0)
        feasible = jnp.all(b >= -1e-9) & jnp.all(jnp.isfinite(b))
        p = b @ W
        d2 = jnp.dot(p, p)
        return p, b, feasible, d2

    ps, bs, feas, d2s = jax.vmap(solve_subset)(subsets)
    ok = feas & sub_valid
    d2m = jnp.where(ok, d2s, jnp.inf)
    best = jnp.argmin(d2m)
    return ps[best], bs[best], jnp.asarray(_SUBSETS)[best] & active


def support(verts, nv, d):
    """argmax_{v in verts[:nv]} v·d (vertex-cloud support point)."""
    dots = verts @ d
    valid = jnp.arange(verts.shape[0]) < nv
    i = jnp.argmax(jnp.where(valid, dots, -jnp.inf))
    return verts[i]


class GJKResult(NamedTuple):
    dist: jnp.ndarray   # () separation distance (0 when intersecting)
    pa: jnp.ndarray     # (3,) witness on A
    pb: jnp.ndarray     # (3,) witness on B
    intersecting: jnp.ndarray


def gjk(verts_a, nva, verts_b, nvb, max_iters: int = MAX_ITERS) -> GJKResult:
    """Distance between conv(verts_a[:nva]) and conv(verts_b[:nvb]),
    both in the same (world) frame."""

    def sup_mink(d):
        sa = support(verts_a, nva, d)
        sb = support(verts_b, nvb, -d)
        return sa - sb, sa, sb

    return gjk_support(sup_mink, verts_a.dtype, max_iters)


def gjk_support(sup_mink, dtype, max_iters: int = MAX_ITERS) -> GJKResult:
    """GJK over an arbitrary Minkowski-difference support closure
    `sup_mink(d) -> (w, sa, sb)` (world frame). This is the generic form the
    reference reaches through `Primitive::get_supporting_point` virtuals
    (src/GJK.cpp, include/Moby/CCD.inl:649-738); curved primitives supply
    closed-form support points instead of vertex clouds."""

    w0, a0, b0 = sup_mink(jnp.array([1.0, 0.0, 0.0], dtype))
    W = jnp.zeros((4, 3), dtype).at[0].set(w0)
    WA = jnp.zeros((4, 3), dtype).at[0].set(a0)
    WB = jnp.zeros((4, 3), dtype).at[0].set(b0)
    active = jnp.array([True, False, False, False])

    def body(carry):
        W, WA, WB, active, v, it, done = carry
        wnew, anew, bnew = sup_mink(-v)
        # termination: no significant progress toward the origin
        progress = jnp.dot(v, v) - jnp.dot(v, wnew)
        v2 = jnp.dot(v, v)
        close_enough = progress <= 1e-10 * jnp.maximum(v2, 1.0)

        # insert the new point into a free slot
        free = jnp.argmin(active)  # first False
        ins = jnp.arange(4) == free
        W2 = jnp.where(ins[:, None], wnew[None, :], W)
        WA2 = jnp.where(ins[:, None], anew[None, :], WA)
        WB2 = jnp.where(ins[:, None], bnew[None, :], WB)
        act2 = active | ins

        p, bary, keep = _closest_on_simplex(W2, act2)
        contains_origin = jnp.dot(p, p) < 1e-18

        # close_enough -> the OLD v/simplex is the converged answer;
        # otherwise (including origin containment) adopt the new state
        upd = ~close_enough
        new_done = done | close_enough | contains_origin
        return (
            jnp.where(upd, W2, W),
            jnp.where(upd, WA2, WA),
            jnp.where(upd, WB2, WB),
            jnp.where(upd, keep, active),
            jnp.where(upd, p, v),
            it + 1,
            new_done,
        )

    def cond(carry):
        *_, it, done = carry
        return ~done & (it < max_iters)

    v0 = w0
    out = jax.lax.while_loop(
        cond, body, (W, WA, WB, active, v0, jnp.int32(0), jnp.array(False))
    )
    W, WA, WB, active, v, _, done = out

    p, bary, _ = _closest_on_simplex(W, active)
    pa = bary @ WA
    pb = bary @ WB
    dist = jnp.linalg.norm(p)
    intersecting = dist < 1e-9
    return GJKResult(dist=dist, pa=pa, pb=pb, intersecting=intersecting)


def _icosphere_dirs():
    """42 unit directions: icosahedron vertices + edge midpoints."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            v += [(0, s1, s2 * phi), (s1, s2 * phi, 0), (s2 * phi, 0, s1)]
    v = np.array(v, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # edge midpoints: pairs closer than the icosahedral edge length
    mids = []
    for i in range(12):
        for j in range(i + 1, 12):
            if np.linalg.norm(v[i] - v[j]) < 1.2:
                m = v[i] + v[j]
                mids.append(m / np.linalg.norm(m))
    return np.concatenate([v, np.array(mids)], axis=0)


_MTV_DIRS = _icosphere_dirs()  # (42, 3)


def mtv(verts_a, nva, verts_b, nvb, refine_iters: int = 8):
    """Approximate minimum-translation vector for two overlapping convex
    vertex clouds: the fixed-shape stand-in for EPA (the reference's
    penetration path runs polyhedral V-Clip / Polyhedron::calc_signed_dist,
    src/Polyhedron.cpp).

    Minimizes t(d) = h_A(d) + h_B(-d) (the translation of B along +d that
    separates the bodies) over 42 fixed icosphere directions, then refines
    with a fixed-iteration compass search on the sphere (t is piecewise
    linear; derivative-free descent avoids subgradient corner cases).

    Returns (depth, n) with n the B->A contact normal (= -argmin d) and
    depth >= 0 the overlap along n. Valid only when the hulls overlap
    (otherwise the result is a positive separation bound, not a distance).
    """
    va_ok = jnp.arange(verts_a.shape[0]) < nva
    vb_ok = jnp.arange(verts_b.shape[0]) < nvb

    def t_of(d):
        # h_A(d) + h_B(-d); d may be a batch (..., 3)
        da = jnp.einsum("...k,vk->...v", d, verts_a)
        db = jnp.einsum("...k,vk->...v", d, verts_b)
        hA = jnp.max(jnp.where(va_ok, da, -jnp.inf), axis=-1)
        hBm = jnp.max(jnp.where(vb_ok, -db, -jnp.inf), axis=-1)
        return hA + hBm

    dirs = jnp.asarray(_MTV_DIRS, verts_a.dtype)
    t0 = t_of(dirs)
    i0 = jnp.argmin(t0)
    d = dirs[i0]

    def body(k, carry):
        d, delta = carry
        # tangent basis at d
        ref = jnp.where(jnp.abs(d[0]) < 0.9,
                        jnp.array([1.0, 0.0, 0.0], d.dtype),
                        jnp.array([0.0, 1.0, 0.0], d.dtype))
        t1 = jnp.cross(d, ref)
        t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-30)
        t2 = jnp.cross(d, t1)
        cands = jnp.stack([
            d,
            d + delta * t1, d - delta * t1,
            d + delta * t2, d - delta * t2,
        ])
        cands = cands / jnp.linalg.norm(cands, axis=-1, keepdims=True)
        vals = t_of(cands)
        j = jnp.argmin(vals)
        return cands[j], delta * 0.6

    d, _ = jax.lax.fori_loop(0, refine_iters, body, (d, jnp.asarray(0.35, d.dtype)))
    depth = t_of(d)
    return depth, -d


def mtv_support(t_of, dtype, refine_iters: int = 10, extra_dirs=None,
                extra_ok=None):
    """Sampled-MTV over an arbitrary support-sum `t_of(d)` (batched over the
    leading axis of d): the generic-pair analog of :func:`mtv` for primitives
    with closed-form support functions (cylinder, cone, torus, sphere).

    `extra_dirs` (E, 3) optionally seeds the search with problem-specific
    candidates (e.g. the polytope side's world-frame face normals — exact
    minimizer directions for face contacts); rows are tried with both signs,
    masked by `extra_ok`. Returns (depth, n) with n the B->A contact normal,
    same convention as :func:`mtv`."""
    dirs = jnp.asarray(_MTV_DIRS, dtype)
    ok = jnp.ones(dirs.shape[0], bool)
    if extra_dirs is not None:
        dirs = jnp.concatenate([dirs, extra_dirs, -extra_dirs], axis=0)
        ok = jnp.concatenate([ok, extra_ok, extra_ok], axis=0)
    t0 = jnp.where(ok, t_of(dirs), jnp.inf)
    i0 = jnp.argmin(t0)
    d = dirs[i0]

    def body(k, carry):
        d, delta = carry
        ref = jnp.where(jnp.abs(d[0]) < 0.9,
                        jnp.array([1.0, 0.0, 0.0], d.dtype),
                        jnp.array([0.0, 1.0, 0.0], d.dtype))
        t1 = jnp.cross(d, ref)
        t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-30)
        t2 = jnp.cross(d, t1)
        cands = jnp.stack([
            d,
            d + delta * t1, d - delta * t1,
            d + delta * t2, d - delta * t2,
        ])
        cands = cands / jnp.linalg.norm(cands, axis=-1, keepdims=True)
        vals = t_of(cands)
        j = jnp.argmin(vals)
        return cands[j], delta * 0.6

    d, _ = jax.lax.fori_loop(
        0, refine_iters, body, (d, jnp.asarray(0.35, dtype))
    )
    depth = t_of(d[None])[0]
    return depth, -d


def mtv_exact(verts_a, nva, verts_b, nvb, cands, cand_ok):
    """Exact convex-polytope penetration depth/normal.

    Minimizes the Minkowski-difference support t(d) = h_A(d) + h_B(-d) over
    the complete optimum candidate set `cands` (hull face normals of both
    bodies + pairwise edge-direction cross products, evaluated both signs).
    For polytopes the minimizing direction is always a face normal of the
    Minkowski difference, i.e. a member of this set — so this equals EPA's
    exact answer (the reference's polyhedral V-Clip / signed-distance path,
    src/Polyhedron.cpp:252-340) with one batched reduction instead of a
    sequential polytope expansion.

    Returns (depth, n) with n the B->A contact normal, same convention as
    :func:`mtv`. Only meaningful when the hulls overlap.
    """
    va_ok = jnp.arange(verts_a.shape[0]) < nva
    vb_ok = jnp.arange(verts_b.shape[0]) < nvb

    def t_of(d):
        da = jnp.einsum("...k,vk->...v", d, verts_a)
        db = jnp.einsum("...k,vk->...v", d, verts_b)
        hA = jnp.max(jnp.where(va_ok, da, -jnp.inf), axis=-1)
        hBm = jnp.max(jnp.where(vb_ok, -db, -jnp.inf), axis=-1)
        return hA + hBm

    D = jnp.concatenate([cands, -cands], axis=0)
    ok2 = jnp.concatenate([cand_ok, cand_ok], axis=0)
    vals = jnp.where(ok2, t_of(D), jnp.inf)
    i = jnp.argmin(vals)
    return vals[i], -D[i]
