"""Generic convex-pair narrow phase via closed-form support functions.

The reference collides *any* primitive pair: combinations without a
specialized kernel fall through to GJK over `Primitive::get_supporting_point`
plus `calc_signed_dist` witnesses (generic dispatch
include/Moby/CCD.inl:3-81, generic contact generation CCD.inl:649-738;
support-point virtuals e.g. src/CylinderPrimitive.cpp, src/ConePrimitive.cpp).

Fixed-shape form: every primitive type gets a branch-free local-frame support
function (sphere/box/cylinder/cone/torus closed-form, polyhedra as masked
vertex-cloud argmax); a pair of *static* types compiles to one vectorized
kernel (GJK distance + witnesses when separated, sampled-MTV penetration
normal seeded with any polytope face normals when overlapping) — so each
unenumerated combination becomes its own kind group at scene build instead
of a runtime virtual dispatch.

Contact manifolds: after the contact normal n (B->A) is known, up to 5
support points per body are generated by tilting the support direction
around n (central + 4 tilts) — flat features (cylinder side/cap, box face)
yield their boundary points at equal depth, while on curved features the
tilted supports collapse onto the central point (deduplicated), mirroring
the multi-vertex manifold `_convex_convex` builds for polytopes.

A torus participates via its convex hull (the Minkowski sum of its center
ring and a ball of its minor radius — exact for outer-surface contact,
approximate across the hole), the same convexity restriction the
reference's GJK path has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import scene as sc
from ..math import quaternion as quat
from . import gjk as gjk_mod

# number of contact slots a support-pair kernel produces (5 per side)
NSLOTS = sc.SUPPORT_NSLOTS


def _sup_sphere(params, verts, nv, d):
    r = params[0]
    dn = jnp.maximum(jnp.linalg.norm(d), 1e-30)
    return d * (r / dn)


def _sup_box(params, verts, nv, d):
    half = params[:3]
    return jnp.where(d >= 0, half, -half)


def _sup_cylinder(params, verts, nv, d):
    # axis = local Y, radius R, height H (narrowphase._cylinder_plane)
    R, H = params[0], params[1]
    radial = jnp.array([d[0], 0.0, d[2]], d.dtype)
    rn = jnp.linalg.norm(radial)
    radial = jnp.where(
        rn > 1e-12,
        radial / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], d.dtype),
    )
    cap = jnp.where(d[1] >= 0, H / 2, -H / 2)
    return R * radial + jnp.array([0.0, 1.0, 0.0], d.dtype) * cap


def _sup_cone(params, verts, nv, d):
    # axis = local Y, apex at +H/2, base radius R at -H/2
    # (ConePrimitive::calc_signed_dist conventions, src/ConePrimitive.cpp)
    R, H = params[0], params[1]
    apex = jnp.array([0.0, H / 2, 0.0], d.dtype)
    radial = jnp.array([d[0], 0.0, d[2]], d.dtype)
    rn = jnp.linalg.norm(radial)
    radial = jnp.where(
        rn > 1e-12,
        radial / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], d.dtype),
    )
    rim = R * radial + jnp.array([0.0, -H / 2, 0.0], d.dtype)
    return jnp.where(jnp.dot(d, apex) >= jnp.dot(d, rim), apex, rim)


def _sup_torus(params, verts, nv, d):
    # axis = local Z (narrowphase._torus_plane); solid torus = ring(Rmaj) ⊕
    # ball(rmin), and Minkowski-sum supports add
    Rmaj, rmin = params[0], params[1]
    ring = jnp.array([d[0], d[1], 0.0], d.dtype)
    rn = jnp.linalg.norm(ring)
    ring = jnp.where(
        rn > 1e-12,
        ring / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], d.dtype),
    )
    dn = jnp.maximum(jnp.linalg.norm(d), 1e-30)
    return Rmaj * ring + rmin * d / dn


def _sup_verts(params, verts, nv, d):
    return gjk_mod.support(verts, nv, d)


_SUPPORT_FNS = {
    sc.SPHERE: _sup_sphere,
    sc.BOX: _sup_box,
    sc.CYLINDER: _sup_cylinder,
    sc.CONE: _sup_cone,
    sc.TORUS: _sup_torus,
    sc.POLYHEDRON: _sup_verts,
}

# types whose pairings the support kernel can always handle
SUPPORT_TYPES = frozenset(_SUPPORT_FNS)


def _world_support(gtype):
    """sup(gp, gq, params, verts, nv, d_world) -> world support point for a
    geometry of static type `gtype` at world pose (gp, gq)."""
    local = _SUPPORT_FNS[gtype]

    def sup(gp, gq, params, verts, nv, d):
        dl = quat.inverse_rotate(gq, d)
        return gp + quat.rotate(gq, local(params, verts, nv, dl))

    return sup


_KERNEL_CACHE = {}


def get_support_kernel(ta: int, tb: int):
    """Cached `make_support_kernel` (one closure per static type pair)."""
    key = (ta, tb)
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = make_support_kernel(ta, tb)
    return _KERNEL_CACHE[key]


def make_support_kernel(ta: int, tb: int):
    """Narrow-phase kernel for an unenumerated convex pair with static types
    (ta, tb). Same interface/returns as the built-in kernels:
    (dist, pa, pb, points (P, NSLOTS, 3), normals, signed-dists (P, NSLOTS)).
    """
    supA = _world_support(ta)
    supB = _world_support(tb)

    def one_pair(pa_, qa, prm_a, va, nva, hn_a, nhn_a,
                 pb_, qb, prm_b, vb, nvb, hn_b, nhn_b):
        dtype = pa_.dtype

        def sA(d):
            return supA(pa_, qa, prm_a, va, nva, d)

        def sB(d):
            return supB(pb_, qb, prm_b, vb, nvb, d)

        def sup_mink(d):
            a = sA(d)
            b = sB(-d)
            return a - b, a, b

        res = gjk_mod.gjk_support(sup_mink, dtype)

        # penetration: minimize t(d) = h_A(d) + h_B(-d) over icosphere
        # directions + both bodies' world-frame hull face normals (exact
        # minimizers for polytope face contacts), compass-refined for the
        # curved side
        def t_of(ds):  # ds (N, 3)
            ha = jax.vmap(lambda d: jnp.dot(d, sA(d)))(ds)
            hb = jax.vmap(lambda d: jnp.dot(-d, sB(-d)))(ds)
            return ha + hb

        FN = hn_a.shape[0]
        extra = jnp.concatenate(
            [quat.rotate(qa[None], hn_a), quat.rotate(qb[None], hn_b)], 0
        )
        extra_ok = jnp.concatenate(
            [jnp.arange(FN) < nhn_a, jnp.arange(hn_b.shape[0]) < nhn_b]
        )
        pen_depth, pen_n = gjk_mod.mtv_support(
            t_of, dtype, extra_dirs=extra, extra_ok=extra_ok
        )

        d = jnp.where(res.intersecting, -pen_depth, res.dist)
        n_sep = res.pa - res.pb
        nn = jnp.linalg.norm(n_sep)
        n_sep = jnp.where(nn > 1e-9, n_sep / jnp.maximum(nn, 1e-30), pen_n)
        n = jnp.where(res.intersecting, pen_n, n_sep)  # B -> A

        # characteristic pair size (max axis extent of either body): the
        # manifold band and dedup tolerances must scale with the geometry —
        # absolute tolerances merge slots on mm-scale scenes and cull
        # boundary points on very large flat features (ADVICE r3). The tilt
        # angle `delta` below is dimensionless and needs no scaling.
        axes = jnp.eye(3, dtype=dtype)
        extA = jax.vmap(lambda e: jnp.dot(e, sA(e)) - jnp.dot(e, sA(-e)))(axes)
        extB = jax.vmap(lambda e: jnp.dot(e, sB(e)) - jnp.dot(e, sB(-e)))(axes)
        scale = jnp.maximum(
            0.5 * jnp.maximum(jnp.max(extA), jnp.max(extB)),
            jnp.asarray(1e-6, dtype),
        )
        face_tol = 10 * jnp.sqrt(
            jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
        ) * scale

        # exact feature-clipping manifold (reference find_contacts_face_face
        # polygon clipping, CCD.inl:599-648): each body's supporting FEATURE
        # for ±n (face polygon / edge / point, by exact value-proximity on
        # per-type boundary candidates), clipped against each other in the
        # contact plane; per-point depth from each feature's affine height.
        # feature-membership tolerance: must exceed (feature span) x
        # (residual normal tilt) or flat features lose vertices to fp noise
        # (a 1-point "face" then corrupts the affine height fit); admitted
        # near-max points of a CURVED feature deviate from the fit plane by
        # at most this tol, so it also bounds the manifold depth error
        tol_feat = jnp.maximum(
            100 * jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype), 1e-6
        ) * scale

        def features_and_fits(n):
            FA, mA_ = _support_feature(
                ta, pa_, qa, prm_a, va, nva, -n, tol_feat)
            FB, mB_ = _support_feature(
                tb, pb_, qb, prm_b, vb, nvb, n, tol_feat)
            o = 0.5 * (sA(-n) + sB(n))
            t1, t2 = _tangents(n)

            def to_plane(F):
                rel = F - o[None, :]
                return jnp.stack([rel @ t1, rel @ t2], axis=-1), rel @ n

            uA, wA = to_plane(FA)
            uB, wB = to_plane(FB)
            coefA = _fit_height(uA, mA_, wA)
            coefB = _fit_height(uB, mB_, wB)
            return FA, mA_, FB, mB_, o, t1, t2, uA, uB, coefA, coefB

        # pass 1 refines the contact normal: a GJK-witness normal between
        # near-touching bodies is ill-conditioned (lateral witness error /
        # gap), but a FACE feature pins the contact plane exactly — take
        # the fitted plane of the side with the larger feature and fold its
        # tilt back into n, then rebuild the features for the exact normal
        _, mA1, _, mB1, _, t1_, t2_, _, _, cA1, cB1 = features_and_fits(n)
        use_b = jnp.sum(mB1) >= jnp.sum(mA1)
        beta = jnp.where(use_b, cB1[1:], cA1[1:])
        n_ref = n - beta[0] * t1_ - beta[1] * t2_
        n = n_ref / jnp.maximum(jnp.linalg.norm(n_ref), 1e-30)

        (FA, mA_, FB, mB_, o, t1, t2, uA, uB, coefA,
         coefB) = features_and_fits(n)

        def pad_sorted(u, m):
            us, cnt = _angular_sort(u, m)
            return (
                jnp.concatenate(
                    [us, jnp.zeros((_PMAX - MF, 2), dtype)], axis=0), cnt,
            )

        PA, cA = pad_sorted(uA, mA_)
        PB, cB = pad_sorted(uB, mB_)
        from .narrowphase import _topk_slots

        pA_clip, mA_clip = _clip_points_by_feature(PA, cA, uB, mB_)
        pB_clip, mB_clip = _clip_points_by_feature(PB, cB, uA, mA_)
        U = jnp.concatenate([pA_clip, pB_clip], axis=0)      # (2*PMAX, 2)
        mU = jnp.concatenate([mA_clip, mB_clip])

        one_u = jnp.concatenate([jnp.ones((U.shape[0], 1), dtype), U],
                                axis=1)
        zA = one_u @ coefA
        zB = one_u @ coefB
        dep = zA - zB                                         # sd per point
        pts_all = (
            o[None, :] + U[:, :1] * t1[None, :] + U[:, 1:2] * t2[None, :]
            + 0.5 * (zA + zB)[:, None] * n[None, :]
        )
        sd_all = jnp.where(mU, dep, jnp.inf)
        idx10, sd = _topk_slots(sd_all[None, :], NSLOTS)
        sd = sd[0]
        pts = pts_all[idx10[0]]

        # separated beyond the manifold band: single GJK-witness contact.
        # The clipped-feature manifold carries exact per-point depths at any
        # near-contact gap, so the band is a fraction of the pair size (it
        # only needs to exclude far-apart bodies whose supporting features
        # no longer face each other); the old tilted-support band (~1e-7·
        # scale in f64) collapsed resting contacts with sub-mm gaps to a
        # single witness point.
        sep = ~res.intersecting & (
            res.dist > jnp.maximum(face_tol, 0.02 * scale)
        )
        point_sep = 0.5 * (res.pa + res.pb)
        pts = jnp.where(sep, point_sep[None, :], pts)
        sd_sep = jnp.full(NSLOTS, jnp.inf, dtype).at[0].set(res.dist)
        sd = jnp.where(sep, sd_sep, sd)

        nrm = jnp.broadcast_to(n[None, :], pts.shape)
        return d, res.pa, res.pb, pts, nrm, sd

    def kernel(scene, pos, quat_b, pairs):
        from .narrowphase import geom_world_pose, _dedup_points

        ga = scene.pair_g1[pairs]
        gb = scene.pair_g2[pairs]
        pa_, qa = geom_world_pose(scene, pos, quat_b, ga)
        pb_, qb = geom_world_pose(scene, pos, quat_b, gb)
        d, wa, wb, pts, nrm, sd = jax.vmap(one_pair)(
            pa_, qa, scene.geom_params[ga], scene.geom_verts[ga],
            scene.geom_nverts[ga], scene.geom_hull_normals[ga],
            scene.geom_nhn[ga],
            pb_, qb, scene.geom_params[gb], scene.geom_verts[gb],
            scene.geom_nverts[gb], scene.geom_hull_normals[gb],
            scene.geom_nhn[gb],
        )
        sd = _dedup_points(pts, sd)
        return d, wa, wb, pts, nrm, sd

    return kernel


def _tangents(n):
    ref = jnp.where(
        jnp.abs(n[0]) < 0.9,
        jnp.array([1.0, 0.0, 0.0], n.dtype),
        jnp.array([0.0, 1.0, 0.0], n.dtype),
    )
    t1 = jnp.cross(n, ref)
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-30)
    t2 = jnp.cross(n, t1)
    return t1, t2


# ---------------- support-feature polygons (exact manifolds) -----------
# For each primitive type, up to MF candidate boundary points of the
# support set in direction d (local frame). A uniform value-proximity
# filter (d·c within tol of the max) then keeps exactly the points lying
# on the supporting FEATURE: a face yields its polygon, an edge its two
# endpoints, a curved feature a single point. The face-clipping manifold
# below intersects the two bodies' features exactly (the reference's
# find_contacts_face_face polygon clipping, include/Moby/CCD.inl:599-648),
# replacing the tilted-support approximation (depth error ~r·delta^2/2).

MF = 8


def _cand_sphere(params, verts, nv, d):
    r = params[0]
    dn = jnp.maximum(jnp.linalg.norm(d), 1e-30)
    p = (d * (r / dn))[None, :]
    return jnp.broadcast_to(p, (MF, 3)), jnp.arange(MF) < 1


def _cand_box(params, verts, nv, d):
    half = params[:3]
    signs = jnp.asarray(
        np.array([[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                  for sz in (-1.0, 1.0)]), d.dtype)
    return signs * half[None, :], jnp.ones(MF, bool)


def _ring_points(radial, axis_v, R, off, n_pts, dtype):
    """n_pts points on a circle of radius R: angle 0 aligned with `radial`,
    offset `off` along the axis. radial/axis_v orthonormal."""
    third = jnp.cross(axis_v, radial)
    ang = jnp.asarray(
        np.arange(n_pts) * (2 * np.pi / n_pts), dtype)
    return (
        R * (jnp.cos(ang)[:, None] * radial[None, :]
             + jnp.sin(ang)[:, None] * third[None, :])
        + off[None, :]
    )


def _cand_cylinder(params, verts, nv, d):
    # axis local Y: 6 rim points of the supported cap (angle 0 radial) +
    # the radial rim point of the opposite cap (side-line partner) + pad
    R, H = params[0], params[1]
    dtype = d.dtype
    radial = jnp.array([d[0], 0.0, d[2]], dtype)
    rn = jnp.linalg.norm(radial)
    radial = jnp.where(
        rn > 1e-12, radial / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], dtype))
    ysign = jnp.where(d[1] >= 0, 1.0, -1.0)
    yhat = jnp.array([0.0, 1.0, 0.0], dtype)
    rim = _ring_points(radial, yhat, R, ysign * (H / 2) * yhat, 6, dtype)
    other = (R * radial - ysign * (H / 2) * yhat)[None, :]
    pts = jnp.concatenate([rim, other, other], axis=0)
    return pts, jnp.arange(MF) < 7


def _cand_cone(params, verts, nv, d):
    # apex +H/2, base rim at -H/2: 6 base-rim points (angle 0 radial) + apex
    R, H = params[0], params[1]
    dtype = d.dtype
    radial = jnp.array([d[0], 0.0, d[2]], dtype)
    rn = jnp.linalg.norm(radial)
    radial = jnp.where(
        rn > 1e-12, radial / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], dtype))
    yhat = jnp.array([0.0, 1.0, 0.0], dtype)
    rim = _ring_points(radial, yhat, R, -(H / 2) * yhat, 6, dtype)
    apex = ((H / 2) * yhat)[None, :]
    pts = jnp.concatenate([rim, apex, apex], axis=0)
    return pts, jnp.arange(MF) < 7


def _cand_torus(params, verts, nv, d):
    # axis local Z: 6 points of the contact circle (radius Rmaj, offset
    # rmin·d̂) + the radial support point; axis-aligned d keeps all 6
    Rmaj, rmin = params[0], params[1]
    dtype = d.dtype
    dn = jnp.maximum(jnp.linalg.norm(d), 1e-30)
    dhat = d / dn
    ring = jnp.array([d[0], d[1], 0.0], dtype)
    rn = jnp.linalg.norm(ring)
    ring = jnp.where(
        rn > 1e-12, ring / jnp.maximum(rn, 1e-30),
        jnp.array([1.0, 0.0, 0.0], dtype))
    zhat = jnp.array([0.0, 0.0, 1.0], dtype)
    circ = _ring_points(ring, zhat, Rmaj, rmin * dhat, 6, dtype)
    main = (Rmaj * ring + rmin * dhat)[None, :]
    pts = jnp.concatenate([circ, main, main], axis=0)
    return pts, jnp.arange(MF) < 7


def _cand_verts(params, verts, nv, d):
    # polyhedron: its vertex table IS the candidate set; the value filter
    # below keeps the supporting face's vertices (MF deepest if more)
    vals = verts @ d
    valid = jnp.arange(verts.shape[0]) < nv
    vals = jnp.where(valid, vals, -jnp.inf)
    k = min(MF, verts.shape[0])
    top, idx = jax.lax.top_k(vals, k)
    pts = verts[idx]
    mask = jnp.isfinite(top)
    if k < MF:
        pts = jnp.concatenate(
            [pts, jnp.broadcast_to(pts[:1], (MF - k, 3))], axis=0)
        mask = jnp.concatenate([mask, jnp.zeros(MF - k, bool)])
    return pts, mask


_CAND_FNS = {
    sc.SPHERE: _cand_sphere,
    sc.BOX: _cand_box,
    sc.CYLINDER: _cand_cylinder,
    sc.CONE: _cand_cone,
    sc.TORUS: _cand_torus,
    sc.POLYHEDRON: _cand_verts,
}


def _support_feature(gtype, gp, gq, prm, va, nva, d_world, tol_scale):
    """World-frame support-feature points of a geometry for direction
    d_world: (pts (MF, 3), mask). Only points whose support value is
    within tol of the max survive (exact feature membership)."""
    dl = quat.inverse_rotate(gq, d_world)
    pts_l, cand = _CAND_FNS[gtype](prm, va, nva, dl)
    vals = pts_l @ dl
    vmax = jnp.max(jnp.where(cand, vals, -jnp.inf))
    keep = cand & (vals >= vmax - tol_scale)
    pts = gp[None, :] + quat.rotate(gq[None, :], pts_l)
    return pts, keep


def _angular_sort(u, mask):
    """Order valid 2D points CCW around their centroid (convex input);
    invalid slots pushed to the end. Returns (sorted u, count)."""
    cnt = jnp.sum(mask)
    c = jnp.sum(jnp.where(mask[:, None], u, 0.0), axis=0) / jnp.maximum(
        cnt, 1)
    ang = jnp.arctan2(u[:, 1] - c[1], u[:, 0] - c[0])
    key = jnp.where(mask, ang, jnp.inf)
    order = jnp.argsort(key)
    return u[order], cnt


_PMAX = 16


def _clip_poly_halfplane(pts, cnt, a, b_, edge_ok):
    """One masked Sutherland–Hodgman step in 2D: clip polygon pts[:cnt]
    against the half-plane left of edge a->b_ (inward = CCW interior).
    Degenerate edges (edge_ok False or zero length) are no-ops.
    pts (PMAX, 2) -> (pts', cnt')."""
    dtype = pts.dtype
    e = b_ - a
    elen = jnp.linalg.norm(e)
    nrm = jnp.stack([-e[1], e[0]])            # inward normal for CCW
    degenerate = (~edge_ok) | (elen < 1e-30)

    idx = jnp.arange(_PMAX)
    valid = idx < cnt
    nxt = jnp.where(idx + 1 < cnt, idx + 1, 0)
    cur = pts
    nxt_p = pts[nxt]
    dc = (cur - a[None, :]) @ nrm
    dn = (nxt_p - a[None, :]) @ nrm
    inside_c = dc >= -1e-30
    inside_n = dn >= -1e-30
    # emission slots: 2 per input vertex (the vertex; the crossing point)
    t = dc / jnp.where(jnp.abs(dc - dn) > 1e-30, dc - dn, 1.0)
    cross = cur + jnp.clip(t, 0.0, 1.0)[:, None] * (nxt_p - cur)
    emit_v = valid & inside_c
    emit_x = valid & (inside_c != inside_n)
    out = jnp.stack([cur, cross], axis=1).reshape(2 * _PMAX, 2)
    em = jnp.stack([emit_v, emit_x], axis=1).reshape(2 * _PMAX)
    # compact: emitted-first stable order preserves polygon order
    order = jnp.argsort(~em)
    out = out[order][:_PMAX]
    cnt2 = jnp.minimum(jnp.sum(em), _PMAX)
    pts2 = jnp.where(degenerate, pts, out)
    cnt2 = jnp.where(degenerate, cnt, cnt2)
    return pts2, cnt2


def _clip_points_by_feature(uP, cP, uQ, mQ):
    """Clip polygon uP[:cP] (ordered CCW) against the halfplanes of the
    ordered feature uQ (count from mask mQ). Returns (pts (PMAX,2),
    mask). A 1-point Q is a no-op (keeps P); a 2-point Q clips P to the
    segment's line (the union with the reverse clip restores extents)."""
    uQs, cQ = _angular_sort(uQ, mQ)
    pts = uP
    cnt = cP

    for i in range(MF):
        a = uQs[i]
        b_ = uQs[jnp.where(i + 1 < cQ, i + 1, 0)]
        edge_ok = (i < cQ) & (cQ >= 2)
        pts, cnt = _clip_poly_halfplane(pts, cnt, a, b_, edge_ok)
    return pts, jnp.arange(_PMAX) < cnt


def _fit_height(u, mask, w):
    """Least-squares affine height w ≈ α + β·u over the masked points
    (Tikhonov-regularized; handles 1-point and collinear features)."""
    dtype = u.dtype
    X = jnp.concatenate([jnp.ones((u.shape[0], 1), dtype), u], axis=1)
    Xm = jnp.where(mask[:, None], X, 0.0)
    wm = jnp.where(mask, w, 0.0)
    A = Xm.T @ Xm + 1e-9 * jnp.eye(3, dtype=dtype)
    b_ = Xm.T @ wm
    # closed-form 3x3 solve (adjugate): keeps this off the LAPACK
    # custom-call path, which was slow for small batches before the GPU
    # port (not yet measured on the GPU)
    c0 = jnp.cross(A[1], A[2])
    c1 = jnp.cross(A[2], A[0])
    c2 = jnp.cross(A[0], A[1])
    det = jnp.dot(A[0], c0)
    adjT = jnp.stack([c0, c1, c2], axis=0)   # rows = cofactor rows
    coef = (adjT @ b_) / jnp.where(jnp.abs(det) > 1e-300, det, 1.0)
    return coef  # (3,): alpha, beta_u, beta_v


# ---------------- closed-form point SDFs (local frame) ----------------
# exact signed distances for the curved primitives, used by the
# trimesh-vs-convex route below (same local-frame conventions as the
# support functions above; gradients via autodiff are the surface normals)

def _sdf_sphere(params, p):
    return jnp.linalg.norm(p) - params[0]


def _sdf_cylinder(params, p):
    # axis local Y, radius R, height H
    R, H = params[0], params[1]
    dr = jnp.sqrt(p[0] ** 2 + p[2] ** 2 + 1e-30) - R
    dy = jnp.abs(p[1]) - H / 2
    d = jnp.stack([dr, dy])
    return jnp.minimum(jnp.max(d), 0.0) + jnp.linalg.norm(
        jnp.maximum(d, 0.0)
    )


def _sdf_cone(params, p):
    # apex at +H/2, base radius R at -H/2 (matches _sup_cone); exact capped
    # cone distance (the standard 2-D cross-section construction)
    R, H = params[0], params[1]
    h = H / 2
    qx = jnp.sqrt(p[0] ** 2 + p[2] ** 2 + 1e-30)
    qy = p[1]
    # k1 = top rim (radius 0 at +h); k2 = lateral edge direction
    k1 = jnp.stack([jnp.zeros_like(R), h])
    k2 = jnp.stack([-R, 2 * h])
    q = jnp.stack([qx, qy])
    # ca: distance to the caps (base disc at -h; apex point at +h)
    cax = qx - jnp.minimum(qx, jnp.where(qy < 0, R, 0.0))
    cay = jnp.abs(qy) - h
    ca = jnp.stack([cax, cay])
    t = jnp.clip(
        jnp.dot(k1 - q, k2) / jnp.maximum(jnp.dot(k2, k2), 1e-30), 0.0, 1.0
    )
    cb = q - k1 + k2 * t
    inside = (cb[0] < 0) & (ca[1] < 0)
    s = jnp.where(inside, -1.0, 1.0)
    return s * jnp.sqrt(
        jnp.minimum(jnp.dot(ca, ca), jnp.dot(cb, cb)) + 1e-30
    )


def _sdf_torus(params, p):
    # axis local Z (matches _sup_torus)
    Rmaj, rmin = params[0], params[1]
    dr = jnp.sqrt(p[0] ** 2 + p[1] ** 2 + 1e-30) - Rmaj
    return jnp.sqrt(dr ** 2 + p[2] ** 2 + 1e-30) - rmin


_SDF_FNS = {
    sc.SPHERE: _sdf_sphere,
    sc.CYLINDER: _sdf_cylinder,
    sc.CONE: _sdf_cone,
    sc.TORUS: _sdf_torus,
}


# ---------------- curved convex vs heightmap ----------------

_HM_KERNEL_CACHE = {}


def get_support_hm_kernel(ta: int):
    if ta not in _HM_KERNEL_CACHE:
        _HM_KERNEL_CACHE[ta] = make_support_hm_kernel(ta)
    return _HM_KERNEL_CACHE[ta]


def make_support_hm_kernel(ta: int):
    """Narrow phase for a curved convex (A) against a heightmap (B):
    support-point sampling against the bilinear grid.

    Reference: `CCD::find_contacts_convex_heightmap`
    (include/Moby/CCD.inl:33,70; impl src/CCD.cpp) walks the convex's
    lowest points over the terrain. Fixed-shape form: 3 fixed-point iterations of
    (support along -terrain-normal -> resample normal under that point),
    then the 5-slot tilted-support manifold of the generic convex kernel,
    each slot's depth measured against the bilinear height under it.
    """
    sup_local = _SUPPORT_FNS[ta]

    def kernel(scene, pos, quat_b, pairs):
        from .narrowphase import _hm_sample, geom_world_pose, _dedup_points

        ga = scene.pair_g1[pairs]
        gb = scene.pair_g2[pairs]
        sp, sq = geom_world_pose(scene, pos, quat_b, ga)
        hp, hq = geom_world_pose(scene, pos, quat_b, gb)
        hm_idx = scene.geom_params[gb, 0].astype(jnp.int32)
        rows = scene.geom_params[gb, 2].astype(jnp.int32)
        cols = scene.geom_params[gb, 3].astype(jnp.int32)
        prm = scene.geom_params[ga]
        va = scene.geom_verts[ga]
        nva = scene.geom_nverts[ga]

        def one(sp_, sq_, prm_, va_, nva_, hp_, hq_, hmi, rr, cc):
            dtype = sp_.dtype

            def sup_hm(d):
                """support point of the convex, heightmap-local frame"""
                dw = quat.rotate(hq_, d)
                dl = quat.inverse_rotate(sq_, dw)
                pl = sup_local(prm_, va_, nva_, dl)
                pw = sp_ + quat.rotate(sq_, pl)
                return quat.inverse_rotate(hq_, pw - hp_)

            def terrain_n(p):
                h, gx, gz = _hm_sample(
                    scene, hmi, jnp.stack([p[0], p[2]]), rr, cc
                )
                n = jnp.stack([-gx, jnp.ones_like(gx), -gz])
                return h, n / jnp.linalg.norm(n)

            def it(n, _):
                p = sup_hm(-n)
                _, n2 = terrain_n(p)
                return n2, None

            n, _ = jax.lax.scan(
                it, jnp.array([0.0, 1.0, 0.0], dtype), None, length=3
            )
            t1, t2 = _tangents(n)
            delta = jnp.asarray(3e-3, dtype)
            tilts = jnp.stack([jnp.zeros_like(n), t1, -t1, t2, -t2])

            def slot(t):
                d = -(n + delta * t)
                d = d / jnp.linalg.norm(d)
                p = sup_hm(d)
                h, nl = terrain_n(p)
                return p, p[1] - h, nl

            ps, dep, nl = jax.vmap(slot)(tilts)       # (5, 3), (5,), (5, 3)
            pw = hp_ + quat.rotate(hq_[None], ps)
            nw = quat.rotate(hq_[None], nl)            # terrain up: B -> A
            i = jnp.argmin(dep)
            dist = dep[i]
            pa = pw[i]
            pb = pa - nw[i] * dist
            return dist, pa, pb, pw, nw, dep

        d, a, b, pts, nrm, sd = jax.vmap(one)(
            sp, sq, prm, va, nva, hp, hq, hm_idx, rows, cols
        )
        sd = _dedup_points(pts, sd)
        return d, a, b, pts, nrm, sd

    return kernel


# ---------------- triangle mesh vs curved convex ----------------

_TM_KERNEL_CACHE = {}


def get_support_tm_kernel(tb: int):
    if tb not in _TM_KERNEL_CACHE:
        _TM_KERNEL_CACHE[tb] = make_support_tm_kernel(tb)
    return _TM_KERNEL_CACHE[tb]


def make_support_tm_kernel(tb: int):
    """Narrow phase for a triangle mesh (A) against a curved convex (B).

    Reference: the generic `find_contacts_generic` fallback
    (include/Moby/CCD.inl:81,649-738) samples mesh vertices against the
    primitive and primitive surface points against the mesh. Fixed-shape form
    (mirrors `_trimesh_convex`): mesh vertices vs the primitive's exact
    closed-form SDF (normals by autodiff), plus support probes of the
    primitive along the inward normals of the 4 nearest mesh faces tested
    against the mesh surface (catches face-interior contacts, e.g. a
    cylinder resting across a large face with no mesh vertex inside it).
    """
    sdf_local = _SDF_FNS[tb]
    sup_local = _SUPPORT_FNS[tb]

    def kernel(scene, pos, quat_b, pairs, nslots):
        from . import trimesh as tmesh
        from .narrowphase import (
            _dedup_points, _mesh_world_tris, _topk_slots, geom_world_pose,
        )

        dtype = pos.dtype
        ga = scene.pair_g1[pairs]   # trimesh
        gb = scene.pair_g2[pairs]   # curved convex
        bp, bq = geom_world_pose(scene, pos, quat_b, gb)
        prm = scene.geom_params[gb]
        vb = scene.geom_verts[gb]
        nvb = scene.geom_nverts[gb]
        vw, vvalid, tv, fvalid = _mesh_world_tris(scene, pos, quat_b, ga)
        nv = vw.shape[1]
        nsl_v = nslots - 8

        # --- mesh vertices vs the primitive SDF
        cl = quat.inverse_rotate(bq[:, None, :], vw - bp[:, None, :])
        sdf_vg = jax.vmap(
            jax.vmap(jax.value_and_grad(lambda p, pr: sdf_local(pr, p)),
                     in_axes=(0, None)),
            in_axes=(0, 0),
        )
        sd_v, g = sdf_vg(cl, prm)
        glen = jnp.linalg.norm(g, axis=-1, keepdims=True)
        n_loc = g / jnp.maximum(glen, 1e-30)
        surf_l = cl - n_loc * sd_v[..., None]   # closest point on primitive
        sd_v = jnp.where(vvalid, sd_v, jnp.inf)
        # outward from the primitive (geom2) = toward the mesh (geom1)
        n_v = quat.rotate(bq[:, None, :], n_loc)
        surf_w = bp[:, None, :] + quat.rotate(bq[:, None, :], surf_l)
        pts_v = vw

        # --- support probes of the primitive vs the mesh surface
        a_ = tv[:, :, 0, :]
        b_ = tv[:, :, 1, :]
        c_ = tv[:, :, 2, :]
        fc = (a_ + b_ + c_) / 3
        fn = jnp.cross(b_ - a_, c_ - a_)
        fl = jnp.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / jnp.maximum(fl, 1e-30)
        fok = fvalid & (fl[..., 0] > 1e-20)
        dc = jnp.where(
            fok, jnp.linalg.norm(fc - bp[:, None, :], axis=-1), jnp.inf
        )
        # 4 nearest faces (smallest dc); meshes with fewer faces repeat the
        # nearest one — the duplicate probe slots dedup to inf below
        k_eff = min(4, dc.shape[1])
        idx_k, _ = _topk_slots(dc, k_eff)
        idx4 = (
            idx_k
            if k_eff == 4
            else jnp.concatenate(
                [idx_k, jnp.repeat(idx_k[:, :1], 4 - k_eff, axis=1)], axis=1
            )
        )
        fn4 = jnp.take_along_axis(fn, idx4[:, :, None], axis=1)   # (P, 4, 3)

        def supw(bp_, bq_, pr, vb_, nvb_, d):
            dl = quat.inverse_rotate(bq_, d)
            return bp_ + quat.rotate(bq_, sup_local(pr, vb_, nvb_, dl))

        # 4 tilted directions around the NEAREST face's normal: on a flat
        # primitive feature (cylinder side line, cone base) the tilted
        # supports walk to the feature boundary, turning the single deepest
        # point into a stable line/face manifold (same trick as the
        # generic convex kernel above)
        fn1 = fn4[:, 0]
        t1, t2 = jax.vmap(_tangents)(fn1)
        delta = jnp.asarray(3e-3, dtype)
        tilts = jnp.stack([t1, -t1, t2, -t2], axis=1)              # (P, 4, 3)
        dirs_t = fn1[:, None, :] + delta * tilts
        dirs_t = dirs_t / jnp.linalg.norm(dirs_t, axis=-1, keepdims=True)
        dirs = jnp.concatenate([fn4, dirs_t], axis=1)              # (P, 8, 3)

        probes = jax.vmap(
            lambda bp_, bq_, pr, vb_, nvb_, ds: jax.vmap(
                lambda d: supw(bp_, bq_, pr, vb_, nvb_, -d)
            )(ds)
        )(bp, bq, prm, vb, nvb, dirs)                              # (P, 8, 3)
        sd_c, q_c, n_out = tmesh.points_vs_mesh(probes, tv, fvalid)
        sep = q_c - probes
        sep_len = jnp.linalg.norm(sep, axis=-1, keepdims=True)
        sep_n = sep / jnp.maximum(sep_len, 1e-30)
        # from the primitive (geom2) toward the mesh (geom1)
        n_c = jnp.where(
            ((sd_c < 0) | (sep_len[..., 0] < 1e-9))[..., None], -n_out, sep_n
        )
        pts_c = probes
        sd_c = jnp.where(jnp.isfinite(sd_c), sd_c, jnp.inf)

        # closest points for conservative advancement (pa on mesh, pb on
        # primitive), over the full slot set before capping
        sdist_full = jnp.concatenate([sd_v, sd_c], axis=1)
        pa_all = jnp.concatenate([vw, q_c], axis=1)
        pb_all = jnp.concatenate([surf_w, probes], axis=1)
        dist = jnp.min(sdist_full, axis=-1)
        imin = jnp.argmin(sdist_full, axis=-1)
        pa = jnp.take_along_axis(pa_all, imin[:, None, None], axis=1)[:, 0]
        pb = jnp.take_along_axis(pb_all, imin[:, None, None], axis=1)[:, 0]

        if nsl_v < nv:
            idx, _ = _topk_slots(sd_v, nsl_v)
            pts_v = jnp.take_along_axis(pts_v, idx[:, :, None], axis=1)
            n_v = jnp.take_along_axis(n_v, idx[:, :, None], axis=1)
            sd_v = jnp.take_along_axis(sd_v, idx, axis=1)

        pts = jnp.concatenate([pts_v, pts_c], axis=1)
        nrm = jnp.concatenate([n_v, n_c], axis=1)
        sdist = jnp.concatenate([sd_v, sd_c], axis=1)
        sdist = _dedup_points(pts, sdist)
        return dist, pa, pb, pts, nrm, sdist

    return kernel
