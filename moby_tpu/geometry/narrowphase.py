"""Vectorized narrow-phase collision kernels.

The reference dispatches per primitive-type pair through a virtual double-
dispatch table (include/Moby/CCD.inl:3-81) one pair at a time; here each
*kind* of pair is processed as one vectorized kernel over all pairs of that
kind (static host-side grouping), producing

* pairwise signed distances + closest points (for conservative advancement;
  reference `CCD::calc_signed_dist`), and
* contact slots (point, normal, depth, active) mirroring each
  `CCD::find_contacts_*` specialization's conventions: which geometry is
  `contact_geom1`, where the contact point sits, which way the normal points.

All outputs are fixed-shape (K contact slots) with boolean activity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import scene as sc
from ..math import quaternion as quat
from ..math.so3 import orthonormal_basis


class PairDist(NamedTuple):
    dist: jnp.ndarray  # (NP,)
    pa: jnp.ndarray    # (NP, 3) closest point on geometry A (world)
    pb: jnp.ndarray    # (NP, 3) closest point on geometry B (world)


class Contacts(NamedTuple):
    active: jnp.ndarray  # (K,) bool
    point: jnp.ndarray   # (K, 3)
    normal: jnp.ndarray  # (K, 3) points from geom2's body toward geom1's body
    depth: jnp.ndarray   # (K,) signed distance at creation
    tan1: jnp.ndarray    # (K, 3)
    tan2: jnp.ndarray    # (K, 3)
    # per-slot identity. For static slots these equal the compile-time
    # scene.slot_s1/slot_s2/slot_pair tables (constant-folded under jit);
    # for pooled slots (SceneBuilder.set_pair_pool) they carry the
    # runtime-culled pair assignment — the slot->body incidence is DATA.
    s1: jnp.ndarray = None    # (K,) int32 pose slot of geom1
    s2: jnp.ndarray = None    # (K,) int32 pose slot of geom2
    pair: jnp.ndarray = None  # (K,) int32 owning candidate pair


def geom_world_pose(scene: sc.Scene, pos, quat_b, gidx):
    """World pose of geometries gidx: pose-slot pose ∘ local pose.

    `pos`/`quat_b` are pose-TABLE arrays (n_pose_slots, ·) covering free
    bodies and articulated links uniformly (see sim.kinematics.compute).
    """
    b = scene.geom_slot[gidx]
    bp = pos[b]
    bq = quat_b[b]
    gp = bp + quat.rotate(bq, scene.geom_pos[gidx])
    gq = quat.mul(bq, scene.geom_quat[gidx])
    return gp, gq


def _sphere_sphere(scene, pos, quat_b, pairs):
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    ca, _ = geom_world_pose(scene, pos, quat_b, ga)
    cb, _ = geom_world_pose(scene, pos, quat_b, gb)
    ra = scene.geom_params[ga, 0]
    rb = scene.geom_params[gb, 0]
    d = ca - cb
    dn = jnp.linalg.norm(d, axis=-1)
    dist = dn - ra - rb
    n = d / jnp.maximum(dn, 1e-30)[..., None]
    pa = ca - n * ra[..., None]
    pb = cb + n * rb[..., None]
    point = 0.5 * (pa + pb)
    return dist, pa, pb, point[:, None, :], n[:, None, :], dist[:, None]


def _sphere_plane(scene, pos, quat_b, pairs):
    ga = scene.pair_g1[pairs]   # sphere
    gb = scene.pair_g2[pairs]   # plane
    ca, _ = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    r = scene.geom_params[ga, 0]
    up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=pos.dtype))
    y = jnp.sum((ca - pp) * up, axis=-1)
    dist = y - r
    # contact point: midway between sphere bottom and the plane surface
    # (reference CCD.inl find_contacts_sphere_plane: y = (y_c - r)/2)
    point = ca - up * ((y + r) / 2)[..., None]
    pa = ca - up * r[..., None]       # lowest point of sphere
    pb = ca - up * y[..., None]       # projection on plane
    n = up
    return dist, pa, pb, point[:, None, :], n[:, None, :], dist[:, None]


def _box_sphere(scene, pos, quat_b, pairs):
    ga = scene.pair_g1[pairs]   # box
    gb = scene.pair_g2[pairs]   # sphere
    bp, bq = geom_world_pose(scene, pos, quat_b, ga)
    cs, _ = geom_world_pose(scene, pos, quat_b, gb)
    half = scene.geom_params[ga, :3]
    r = scene.geom_params[gb, 0]
    # sphere center in box frame
    cl = quat.inverse_rotate(bq, cs - bp)
    clamped = jnp.clip(cl, -half, half)
    dvec = cl - clamped
    dn = jnp.linalg.norm(dvec, axis=-1)
    outside = dn > 1e-12
    # center inside the box: distance to the nearest face (negative)
    face_d = half - jnp.abs(cl)  # (P,3) >= 0 when inside
    min_face = jnp.min(face_d, axis=-1)
    dist = jnp.where(outside, dn - r, -(min_face) - r)
    # closest point on box (world)
    pbox = bp + quat.rotate(bq, clamped)
    dirn = dvec / jnp.maximum(dn, 1e-30)[..., None]
    dir_world = quat.rotate(bq, dirn)
    psph = cs - dir_world * r[..., None]
    sep = dist > 0
    point = jnp.where(sep[..., None], 0.5 * (psph + pbox), psph)
    # normal: from sphere(B) toward box(A) (reference find_contacts_box_sphere)
    n_sep = pbox - psph
    n_sep = n_sep / jnp.maximum(jnp.linalg.norm(n_sep, axis=-1, keepdims=True), 1e-30)
    # overlapping: use direction from box center to sphere center (fallback)
    n_pen = -dir_world
    n = jnp.where(sep[..., None], n_sep, n_pen)
    return dist, pbox, psph, point[:, None, :], n[:, None, :], dist[:, None]


def _plane_generic(scene, pos, quat_b, pairs, nslots):
    """A = plane, B = solid with vertices; one slot per vertex of B
    (reference CCD.inl find_contacts_plane_generic: contacts at B's vertices
    with normal = -plane_up, geom1 = plane). Solids with more vertices than
    slots (scene.VSLOT_CAP) contribute their `nslots` deepest vertices — a
    superset of any physical contact manifold."""
    ga = scene.pair_g1[pairs]   # plane
    gb = scene.pair_g2[pairs]   # vertex solid
    pp, pq = geom_world_pose(scene, pos, quat_b, ga)
    sp, sq = geom_world_pose(scene, pos, quat_b, gb)
    up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=pos.dtype))
    verts = scene.geom_verts[gb]                      # (P, V, 3) local
    V = verts.shape[1]
    nv = scene.geom_nverts[gb]                        # (P,)
    vw = sp[:, None, :] + quat.rotate(sq[:, None, :], verts)  # world verts
    y = jnp.sum((vw - pp[:, None, :]) * up[:, None, :], axis=-1)  # (P, V)
    valid = jnp.arange(V)[None, :] < nv[:, None]
    yv = jnp.where(valid, y, jnp.inf)
    dist = jnp.min(yv, axis=-1)
    # closest points: the lowest vertex and its projection on the plane
    imin = jnp.argmin(yv, axis=-1)
    vmin = jnp.take_along_axis(vw, imin[:, None, None], axis=1)[:, 0, :]
    pbv = vmin
    pav = vmin - up * jnp.take_along_axis(y, imin[:, None], axis=1)
    if nslots < V:
        idx, _ = _topk_slots(yv, nslots)              # deepest nslots
        vw = jnp.take_along_axis(vw, idx[:, :, None], axis=1)
        y = jnp.take_along_axis(y, idx, axis=1)
        valid = jnp.take_along_axis(valid, idx, axis=1)
    # per-vertex contact slots: normal = -up (geom1 = plane)
    n = jnp.broadcast_to(-up[:, None, :], vw.shape)
    sdist = jnp.where(valid, y, jnp.inf)
    return dist, pav, pbv, vw, n, sdist


def _cylinder_plane(scene, pos, quat_b, pairs):
    """A = cylinder (axis = local Y), B = plane; up to 4 contacts
    (reference CCD.inl find_contacts_cylinder_plane)."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    cp_, cq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    R = scene.geom_params[ga, 0]
    H = scene.geom_params[ga, 1]
    dtype = pos.dtype
    up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    axis = quat.rotate(cq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    n_dot = jnp.sum(up * axis, axis=-1)
    axial = jnp.where(n_dot[..., None] > 0, -axis, axis)  # pointing toward plane

    perp = jnp.abs(n_dot) > 1.0 - 1e-8   # axis ⟂ plane (endcap rests)
    par = jnp.abs(n_dot) < 1e-8          # axis ∥ plane (side rests)

    # endcap case: 4 rim points around the low cap
    x_cap = cp_ + axial * (H / 2)[..., None]
    t1, t2 = orthonormal_basis(up)
    angles = jnp.arange(4) * (jnp.pi / 2)
    rim = (
        x_cap[:, None, :]
        + R[:, None, None] * jnp.cos(angles)[None, :, None] * t1[:, None, :]
        + R[:, None, None] * jnp.sin(angles)[None, :, None] * t2[:, None, :]
    )
    d_cap = jnp.sum((x_cap - pp) * up, axis=-1)

    # side case: 2 endpoints of the lowest line
    x_side = cp_ - up * R[..., None]
    e1 = x_side + axial * (H / 2)[..., None]
    e2 = x_side - axial * (H / 2)[..., None]
    d_side = jnp.sum((x_side - pp) * up, axis=-1)

    # edge case: single lowest rim point
    radial = jnp.cross(axial, jnp.cross(axial, up))
    radial = radial / jnp.maximum(jnp.linalg.norm(radial, axis=-1, keepdims=True), 1e-30)
    x_edge = cp_ + axial * (H / 2)[..., None] + radial * R[..., None]
    d_edge = jnp.sum((x_edge - pp) * up, axis=-1)

    dist = jnp.where(perp, d_cap, jnp.where(par, d_side, d_edge))
    pts = jnp.where(
        perp[:, None, None],
        rim,
        jnp.where(
            par[:, None, None],
            jnp.stack([e1, e2, e1, e2], axis=1),
            jnp.stack([x_edge] * 4, axis=1),
        ),
    )
    nact = jnp.where(perp, 4, jnp.where(par, 2, 1))
    valid = jnp.arange(4)[None, :] < nact[:, None]
    sdist = jnp.where(valid, dist[:, None], jnp.inf)
    n = jnp.broadcast_to(up[:, None, :], pts.shape)
    pa = jnp.where(perp[:, None], x_cap, jnp.where(par[:, None], x_side, x_edge))
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _cone_plane(scene, pos, quat_b, pairs):
    """A = cone (axis = local Y, apex at +H/2, base radius R at -H/2:
    ConePrimitive::calc_signed_dist, src/ConePrimitive.cpp:110-150),
    B = plane. Cases: base resting -> 4 rim points; slant resting (axis/plane
    angle = half-angle) -> apex + lowest rim point; otherwise the single
    lowest feature (apex or base rim)."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    cp_, cq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    R = scene.geom_params[ga, 0]
    H = scene.geom_params[ga, 1]
    dtype = pos.dtype
    up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    axis = quat.rotate(cq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    n_dot = jnp.sum(up * axis, axis=-1)

    apex = cp_ + axis * (H / 2)[..., None]
    base = cp_ - axis * (H / 2)[..., None]

    # lowest point of the base rim: walk R down-plane from the base center
    radial = jnp.cross(axis, jnp.cross(axis, up))
    rn = jnp.linalg.norm(radial, axis=-1, keepdims=True)
    t1, t2 = orthonormal_basis(axis)
    radial = jnp.where(rn > 1e-12, radial / jnp.maximum(rn, 1e-30), t1)
    rim_low = base + radial * R[..., None]

    d_apex = jnp.sum((apex - pp) * up, axis=-1)
    d_rim = jnp.sum((rim_low - pp) * up, axis=-1)

    # base-flat case: axis anti-parallel to up (base faces the plane)
    flat = n_dot > 1.0 - 1e-8
    # slant case: apex and rim-low equally close (within tol of each other)
    half_angle = jnp.arctan2(R, H)
    tilt = jnp.arccos(jnp.clip(jnp.abs(n_dot), 0.0, 1.0))
    slant = jnp.abs((jnp.pi / 2 - tilt) - half_angle) < 1e-6

    # base rim points (4) for the flat case
    bt1, bt2 = orthonormal_basis(up)
    angles = jnp.arange(4).astype(dtype) * (jnp.pi / 2)
    rim4 = (
        base[:, None, :]
        + R[:, None, None] * jnp.cos(angles)[None, :, None] * bt1[:, None, :]
        + R[:, None, None] * jnp.sin(angles)[None, :, None] * bt2[:, None, :]
    )
    d_base = jnp.sum((base - pp) * up, axis=-1)

    apex_lower = d_apex < d_rim
    d_point = jnp.minimum(d_apex, d_rim)
    x_point = jnp.where(apex_lower[:, None], apex, rim_low)

    dist = jnp.where(flat, d_base, d_point)
    pts = jnp.where(
        flat[:, None, None],
        rim4,
        jnp.where(
            slant[:, None, None],
            jnp.stack([apex, rim_low, apex, rim_low], axis=1),
            jnp.stack([x_point] * 4, axis=1),
        ),
    )
    nact = jnp.where(flat, 4, jnp.where(slant, 2, 1))
    valid = jnp.arange(4)[None, :] < nact[:, None]
    sdist = jnp.where(valid, dist[:, None], jnp.inf)
    n = jnp.broadcast_to(up[:, None, :], pts.shape)
    pa = jnp.where(flat[:, None], base, x_point)
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _torus_plane(scene, pos, quat_b, pairs):
    """A = torus (axis = local Z), B = plane; aligned case -> 4 ring points
    (reference CCD.inl find_contacts_torus_plane), tilted -> lowest point."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    tp, tq = geom_world_pose(scene, pos, quat_b, ga)
    pp, pq = geom_world_pose(scene, pos, quat_b, gb)
    Rmaj = scene.geom_params[ga, 0]
    rmin = scene.geom_params[ga, 1]
    dtype = pos.dtype
    up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    k = quat.rotate(tq, jnp.array([0.0, 0.0, 1.0], dtype=dtype))
    n_dot_k = jnp.sum(up * k, axis=-1)
    aligned = jnp.abs(n_dot_k) > 1.0 - 100 * 1.5e-8

    h = jnp.sum((tp - pp) * up, axis=-1)
    d_aligned = h - rmin

    # aligned: 4 points on the bottom circle of radius Rmaj
    angles = jnp.arange(4).astype(dtype) / 4 * (2 * jnp.pi) - jnp.pi
    ex = quat.rotate(tq, jnp.array([1.0, 0.0, 0.0], dtype=dtype))
    ey = quat.rotate(tq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
    ring = (
        tp[:, None, :]
        + Rmaj[:, None, None] * jnp.cos(angles)[None, :, None] * ex[:, None, :]
        + Rmaj[:, None, None] * jnp.sin(angles)[None, :, None] * ey[:, None, :]
        - (rmin[:, None] * jnp.sign(n_dot_k)[:, None])[..., None] * k[:, None, :]
    )

    # tilted: lowest point of the tube center circle minus rmin along up
    # center circle direction of steepest descent
    kp = k - up * n_dot_k[..., None]
    kpn = jnp.linalg.norm(kp, axis=-1, keepdims=True)
    # radial direction in torus plane pointing most downward
    rdir = jnp.cross(k, jnp.cross(k, up))
    rdir = rdir / jnp.maximum(jnp.linalg.norm(rdir, axis=-1, keepdims=True), 1e-30)
    plow = tp + Rmaj[..., None] * rdir - rmin[..., None] * up
    d_tilt = jnp.sum((plow - pp) * up, axis=-1)

    dist = jnp.where(aligned, d_aligned, d_tilt)
    pts = jnp.where(aligned[:, None, None], ring, jnp.stack([plow] * 4, axis=1))
    nact = jnp.where(aligned, 4, 1)
    valid = jnp.arange(4)[None, :] < nact[:, None]
    sdist = jnp.where(valid, dist[:, None], jnp.inf)
    n = jnp.broadcast_to(up[:, None, :], pts.shape)
    pa = jnp.where(aligned[:, None], tp - up * (h - d_aligned)[..., None], plow)
    pb = pa - up * dist[..., None]
    return dist, pa, pb, pts, n, sdist


def _point_box_dist_normal(half, p):
    """Signed distance + outward normal (box local frame) for points p
    (..., 3) against a box with half-extents `half` (Primitive
    calc_dist_and_normal semantics)."""
    clamped = jnp.clip(p, -half, half)
    dvec = p - clamped
    dn = jnp.linalg.norm(dvec, axis=-1)
    outside = dn > 1e-12
    face_d = half - jnp.abs(p)
    min_face = jnp.min(face_d, axis=-1)
    iface = jnp.argmin(face_d, axis=-1)
    n_in = jnp.sign(p) * jax.nn.one_hot(iface, 3, dtype=p.dtype)
    n_out = dvec / jnp.maximum(dn, 1e-30)[..., None]
    dist = jnp.where(outside, dn, -min_face)
    n = jnp.where(outside[..., None], n_out, n_in)
    return dist, n


def _box_box(scene, pos, quat_b, pairs, nslots):
    """Box-box via vertex-vs-box both directions (the reference's generic
    narrow phase, CCD.inl find_contacts_generic: vA tested in B with normal
    -n_B, vB tested in A with normal +n_A; geom1 = A)."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    pa_, qa = geom_world_pose(scene, pos, quat_b, ga)
    pb_, qb = geom_world_pose(scene, pos, quat_b, gb)
    ha = scene.geom_params[ga, :3]
    hb = scene.geom_params[gb, :3]
    half_slots = nslots // 2
    V = scene.geom_verts.shape[1]

    # vertices of A in B's frame
    va = scene.geom_verts[ga]                                # (P, V, 3) local A
    va_w = pa_[:, None, :] + quat.rotate(qa[:, None, :], va)
    va_b = quat.inverse_rotate(qb[:, None, :], va_w - pb_[:, None, :])
    dA, nA_local = _point_box_dist_normal(hb[:, None, :], va_b)
    nA_w = quat.rotate(qb[:, None, :], nA_local)             # outward from B

    vb = scene.geom_verts[gb]
    vb_w = pb_[:, None, :] + quat.rotate(qb[:, None, :], vb)
    vb_a = quat.inverse_rotate(qa[:, None, :], vb_w - pa_[:, None, :])
    dB, nB_local = _point_box_dist_normal(ha[:, None, :], vb_a)
    nB_w = quat.rotate(qa[:, None, :], nB_local)             # outward from A

    nva = scene.geom_nverts[ga]
    nvb = scene.geom_nverts[gb]
    validA = jnp.arange(V)[None, :] < nva[:, None]
    validB = jnp.arange(V)[None, :] < nvb[:, None]
    if half_slots < V:
        # slot cap: keep the deepest half_slots vertices per side
        idxA, _ = _topk_slots(jnp.where(validA, dA, jnp.inf), half_slots)
        va_w = jnp.take_along_axis(va_w, idxA[:, :, None], axis=1)
        dA = jnp.take_along_axis(dA, idxA, axis=1)
        nA_w = jnp.take_along_axis(nA_w, idxA[:, :, None], axis=1)
        validA = jnp.take_along_axis(validA, idxA, axis=1)
        idxB, _ = _topk_slots(jnp.where(validB, dB, jnp.inf), half_slots)
        vb_w = jnp.take_along_axis(vb_w, idxB[:, :, None], axis=1)
        dB = jnp.take_along_axis(dB, idxB, axis=1)
        nB_w = jnp.take_along_axis(nB_w, idxB[:, :, None], axis=1)
        validB = jnp.take_along_axis(validB, idxB, axis=1)

    # contact normal convention: from geom2's body toward geom1's body.
    # A-vertex in B: create_contact(cgA, cgB, v, n) with n = B's outward
    # normal at the point -> points toward A ✓.
    # B-vertex in A: create_contact(cgA, cgB, v, -n_A_outward) -> also B->A?
    # The reference negates (find_contacts_generic :662): normal = -n where n
    # is A's outward normal (pointing toward B), so -n points toward A ✓.
    pts = jnp.concatenate([va_w, vb_w], axis=1)
    nrm = jnp.concatenate([nA_w, -nB_w], axis=1)
    sd = jnp.concatenate(
        [jnp.where(validA, dA, jnp.inf), jnp.where(validB, dB, jnp.inf)], axis=1
    )
    dist = jnp.min(sd, axis=1)
    # closest points for CA: vertex with min distance and its projection
    imin = jnp.argmin(sd, axis=1)
    pmin = jnp.take_along_axis(pts, imin[:, None, None], axis=1)[:, 0]
    nmin = jnp.take_along_axis(nrm, imin[:, None, None], axis=1)[:, 0]
    pa_c = pmin
    pb_c = pmin - nmin * dist[:, None]
    return dist, pa_c, pb_c, pts, nrm, sd


def _hm_sample(scene, hm_idx, xz, rows, cols):
    """Bilinear height h(x, z) + gradient on heightmap grids.

    The grid spans x ∈ [-w/2, w/2] (rows), z ∈ [-d/2, d/2] (cols); local
    y-up, like the reference's HeightmapPrimitive (its own `calc_height` has
    integer-truncation bugs — this is the corrected bilinear form).
    xz: (..., 2) local query points. Returns (h, dhdx, dhdz).
    """
    w = scene.hm_size[hm_idx, 0]
    d = scene.hm_size[hm_idx, 1]
    R = rows.astype(xz.dtype)
    C = cols.astype(xz.dtype)
    fx = (xz[..., 0] + w / 2) * (R - 1) / w
    fz = (xz[..., 1] + d / 2) * (C - 1) / d
    fx = jnp.clip(fx, 0.0, R - 1.0001)
    fz = jnp.clip(fz, 0.0, C - 1.0001)
    i0 = jnp.floor(fx).astype(jnp.int32)
    j0 = jnp.floor(fz).astype(jnp.int32)
    s = fx - i0
    t = fz - j0
    H = scene.hm_heights[hm_idx]
    f00 = H[i0, j0]
    f10 = H[i0 + 1, j0]
    f01 = H[i0, j0 + 1]
    f11 = H[i0 + 1, j0 + 1]
    h = (
        f00 * (1 - s) * (1 - t)
        + f10 * s * (1 - t)
        + f01 * (1 - s) * t
        + f11 * s * t
    )
    dx = w / (R - 1)
    dz = d / (C - 1)
    dhdx = ((f10 - f00) * (1 - t) + (f11 - f01) * t) / dx
    dhdz = ((f01 - f00) * (1 - s) + (f11 - f10) * s) / dz
    return h, dhdx, dhdz


def _heightmap_frame(scene, pos, quat_b, gb):
    return geom_world_pose(scene, pos, quat_b, gb)


def _sphere_heightmap(scene, pos, quat_b, pairs):
    """A = sphere, B = heightmap: contact under the sphere center
    (reference CCD find_contacts_sphere_heightmap approximation)."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    cs, _ = geom_world_pose(scene, pos, quat_b, ga)
    hp, hq = _heightmap_frame(scene, pos, quat_b, gb)
    r = scene.geom_params[ga, 0]
    hm_idx = scene.geom_params[gb, 0].astype(jnp.int32)
    rows = scene.geom_params[gb, 2].astype(jnp.int32)
    cols = scene.geom_params[gb, 3].astype(jnp.int32)
    cl = quat.inverse_rotate(hq, cs - hp)          # sphere center, hm frame
    h, gx, gz = jax.vmap(
        lambda hi, p, rr, cc: _hm_sample(scene, hi, p, rr, cc)
    )(hm_idx, cl[:, [0, 2]], rows, cols)
    # local surface normal ∝ (-dh/dx, 1, -dh/dz)
    n_local = jnp.stack([-gx, jnp.ones_like(gx), -gz], axis=-1)
    n_local = n_local / jnp.linalg.norm(n_local, axis=-1, keepdims=True)
    dist = (cl[:, 1] - h) - r
    n = quat.rotate(hq, n_local)
    pa = cs - n * r[:, None]                        # sphere lowest point
    pb = pa - n * dist[:, None]
    point = 0.5 * (pa + pb)
    return dist, pa, pb, point[:, None, :], n[:, None, :], dist[:, None]


def _verts_heightmap(scene, pos, quat_b, pairs, nslots):
    """A = vertex solid, B = heightmap: per-vertex contacts
    (reference find_contacts_convex_heightmap)."""
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    sp, sq = geom_world_pose(scene, pos, quat_b, ga)
    hp, hq = _heightmap_frame(scene, pos, quat_b, gb)
    hm_idx = scene.geom_params[gb, 0].astype(jnp.int32)
    rows = scene.geom_params[gb, 2].astype(jnp.int32)
    cols = scene.geom_params[gb, 3].astype(jnp.int32)
    verts = scene.geom_verts[ga]
    V = verts.shape[1]
    nv = scene.geom_nverts[ga]
    vw = sp[:, None, :] + quat.rotate(sq[:, None, :], verts)
    vl = quat.inverse_rotate(hq[:, None, :], vw - hp[:, None, :])
    h, gx, gz = jax.vmap(
        lambda hi, p, rr, cc: _hm_sample(scene, hi, p, rr, cc)
    )(hm_idx, vl[:, :, [0, 2]], rows, cols)
    n_local = jnp.stack([-gx, jnp.ones_like(gx), -gz], axis=-1)
    n_local = n_local / jnp.linalg.norm(n_local, axis=-1, keepdims=True)
    y = vl[:, :, 1] - h
    valid = jnp.arange(V)[None, :] < nv[:, None]
    sdist = jnp.where(valid, y, jnp.inf)
    dist = jnp.min(sdist, axis=1)
    n = quat.rotate(hq[:, None, :], n_local)
    imin = jnp.argmin(sdist, axis=1)
    pmin = jnp.take_along_axis(vw, imin[:, None, None], axis=1)[:, 0]
    nmin = jnp.take_along_axis(n, imin[:, None, None], axis=1)[:, 0]
    if nslots < V:
        idx, _ = _topk_slots(sdist, nslots)   # deepest nslots vertices
        vw = jnp.take_along_axis(vw, idx[:, :, None], axis=1)
        n = jnp.take_along_axis(n, idx[:, :, None], axis=1)
        sdist = jnp.take_along_axis(sdist, idx, axis=1)
    return dist, pmin, pmin - nmin * dist[:, None], vw, n, sdist


def _topk_by_depth(depth, valid, k):
    """Indices of the k smallest depths among valid slots (iterated masked
    argmin — fixed shape, no sort)."""

    def body(_, carry):
        chosen, excl = carry
        i = jnp.argmin(jnp.where(valid & ~excl, depth, jnp.inf)).astype(
            jnp.int32
        )
        ok = (valid & ~excl)[i]
        chosen = jnp.concatenate([chosen[1:], i[None]])
        excl = excl.at[i].set(excl[i] | ok)
        return chosen, excl

    chosen0 = jnp.zeros(k, jnp.int32)
    excl0 = jnp.zeros_like(valid)
    chosen, excl = jax.lax.fori_loop(0, k, body, (chosen0, excl0))
    return chosen


def _convex_convex(scene, pos, quat_b, pairs):
    """General convex pair: batched GJK witnesses for the separated case +
    sampled-MTV normal (EPA stand-in, see `gjk.mtv`) with a bidirectional
    vertex-vs-supporting-plane manifold when touching/penetrating.

    The reference does polyhedral V-Clip feature walking / signed distance
    (src/Polyhedron.cpp, src/GJK.cpp) producing multi-contact manifolds per
    convex pair; here both sides' vertices near the other body's supporting
    plane become up to 4+4 contact slots (deepest-first), the same
    vertex-contact convention as `find_contacts_plane_generic`.
    Edge-edge-only penetrations fall back to the deepest-vertex pair."""
    from . import gjk as gjk_mod

    dtype = pos.dtype
    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    pa_, qa = geom_world_pose(scene, pos, quat_b, ga)
    pb_, qb = geom_world_pose(scene, pos, quat_b, gb)
    va = pa_[:, None, :] + quat.rotate(qa[:, None, :], scene.geom_verts[ga])
    vb = pb_[:, None, :] + quat.rotate(qb[:, None, :], scene.geom_verts[gb])
    nva = scene.geom_nverts[ga]
    nvb = scene.geom_nverts[gb]
    res = jax.vmap(gjk_mod.gjk)(va, nva, vb, nvb)
    if int(np.max(np.asarray(scene.geom_nhn))) > 0:
        # exact polytope penetration: minimize the Minkowski-difference
        # support over hull face normals of both bodies + pairwise
        # edge-direction cross products (the complete optimum set — equals
        # EPA / the reference's V-Clip answer, src/Polyhedron.cpp:252-340)
        fa = quat.rotate(qa[:, None, :], scene.geom_hull_normals[ga])
        fb = quat.rotate(qb[:, None, :], scene.geom_hull_normals[gb])
        ea = quat.rotate(qa[:, None, :], scene.geom_hull_edges[ga])
        eb = quat.rotate(qb[:, None, :], scene.geom_hull_edges[gb])
        FN = fa.shape[1]
        ED = ea.shape[1]
        ok_fa = jnp.arange(FN)[None, :] < scene.geom_nhn[ga][:, None]
        ok_fb = jnp.arange(FN)[None, :] < scene.geom_nhn[gb][:, None]
        ok_ea = jnp.arange(ED)[None, :] < scene.geom_nhe[ga][:, None]
        ok_eb = jnp.arange(ED)[None, :] < scene.geom_nhe[gb][:, None]
        cr = jnp.cross(ea[:, :, None, :], eb[:, None, :, :]).reshape(
            ea.shape[0], ED * ED, 3
        )
        crn = jnp.linalg.norm(cr, axis=-1, keepdims=True)
        ok_cr = (
            (ok_ea[:, :, None] & ok_eb[:, None, :]).reshape(-1, ED * ED)
            & (crn[..., 0] > 1e-9)
        )
        cr = cr / jnp.maximum(crn, 1e-30)
        cands = jnp.concatenate([fa, fb, cr], axis=1)
        cand_ok = jnp.concatenate([ok_fa, ok_fb, ok_cr], axis=1)
        pen_depth, pen_n = jax.vmap(gjk_mod.mtv_exact)(
            va, nva, vb, nvb, cands, cand_ok
        )
    else:
        # native quickhull unavailable at scene build: sampled-MTV fallback
        pen_depth, pen_n = jax.vmap(gjk_mod.mtv)(va, nva, vb, nvb)

    d = jnp.where(res.intersecting, -pen_depth, res.dist)
    n_sep = res.pa - res.pb
    nn = jnp.linalg.norm(n_sep, axis=-1, keepdims=True)
    n_sep = jnp.where(
        nn > 1e-9, n_sep / jnp.maximum(nn, 1e-30), pen_n
    )
    n = jnp.where(res.intersecting[:, None], pen_n, n_sep)  # B -> A

    # supporting planes: B's extreme toward A (along +n), A's toward B
    vmask_a = jnp.arange(va.shape[1])[None, :] < nva[:, None]
    vmask_b = jnp.arange(vb.shape[1])[None, :] < nvb[:, None]
    dots_a = jnp.einsum("pvk,pk->pv", va, n)
    dots_b = jnp.einsum("pvk,pk->pv", vb, n)
    hB = jnp.max(jnp.where(vmask_b, dots_b, -jnp.inf), axis=1)   # B top
    sA = jnp.min(jnp.where(vmask_a, dots_a, jnp.inf), axis=1)    # A bottom

    face_tol = 10 * jnp.sqrt(jnp.asarray(np.finfo(np.dtype(dtype)).eps))

    # A's vertices vs B's plane (depth = signed distance along n)
    depth_a = dots_a - hB[:, None]
    cand_a = vmask_a & (depth_a <= face_tol)
    # B's vertices vs A's plane
    depth_b = sA[:, None] - dots_b
    cand_b = vmask_b & (depth_b <= face_tol)

    idx_a = jax.vmap(lambda dep, ok: _topk_by_depth(dep, ok, 4))(
        depth_a, cand_a
    )
    idx_b = jax.vmap(lambda dep, ok: _topk_by_depth(dep, ok, 4))(
        depth_b, cand_b
    )
    P = va.shape[0]
    rows = jnp.arange(P)[:, None]
    pts_a = va[rows, idx_a] - 0.5 * depth_a[rows, idx_a][..., None] * n[:, None, :]
    pts_b = vb[rows, idx_b] + 0.5 * depth_b[rows, idx_b][..., None] * n[:, None, :]
    sd_a = jnp.where(cand_a[rows, idx_a], depth_a[rows, idx_a], jnp.inf)
    sd_b = jnp.where(cand_b[rows, idx_b], depth_b[rows, idx_b], jnp.inf)

    pts = jnp.concatenate([pts_a, pts_b], axis=1)          # (P, 8, 3)
    sdist = jnp.concatenate([sd_a, sd_b], axis=1)          # (P, 8)

    # separated: single GJK-witness contact in slot 0
    point_sep = 0.5 * (res.pa + res.pb)
    sep = ~res.intersecting & (res.dist > face_tol)
    pts = jnp.where(sep[:, None, None], point_sep[:, None, :], pts)
    sdist_sep = jnp.concatenate(
        [res.dist[:, None], jnp.full((P, 7), jnp.inf, dtype)], axis=1
    )
    sdist = jnp.where(sep[:, None], sdist_sep, sdist)

    # fallback: penetrating but no vertex-plane candidates (edge-edge):
    # closest points between the supporting segments (the two extreme
    # vertices of each body along the contact normal approximate each
    # body's supporting edge; exact for genuine edge-edge box contacts)
    def _seg_seg_mid(a1, a2, b1, b2):
        u = a2 - a1
        v = b2 - b1
        w0 = a1 - b1
        a_ = jnp.sum(u * u, -1)
        b_ = jnp.sum(u * v, -1)
        c_ = jnp.sum(v * v, -1)
        d_ = jnp.sum(u * w0, -1)
        e_ = jnp.sum(v * w0, -1)
        den = a_ * c_ - b_ * b_
        sn = jnp.where(den > 1e-18, (b_ * e_ - c_ * d_) / jnp.where(den > 1e-18, den, 1.0), 0.0)
        sn = jnp.clip(sn, 0.0, 1.0)
        tn = jnp.where(c_ > 1e-18, (b_ * sn + e_) / jnp.where(c_ > 1e-18, c_, 1.0), 0.0)
        tn = jnp.clip(tn, 0.0, 1.0)
        pa2 = a1 + u * sn[..., None]
        pb2 = b1 + v * tn[..., None]
        return 0.5 * (pa2 + pb2)

    # two extreme vertices of A along -n and of B along +n
    da_sorted = jnp.argsort(jnp.where(vmask_a, dots_a, jnp.inf), axis=1)
    db_sorted = jnp.argsort(jnp.where(vmask_b, -dots_b, jnp.inf), axis=1)
    a1 = va[rows[:, 0], da_sorted[:, 0]]
    a2 = va[rows[:, 0], da_sorted[:, 1]]
    b1 = vb[rows[:, 0], db_sorted[:, 0]]
    b2 = vb[rows[:, 0], db_sorted[:, 1]]
    fb_pt = _seg_seg_mid(a1, a2, b1, b2)

    have = jnp.any(jnp.isfinite(sdist), axis=1)
    pts = jnp.where(have[:, None, None], pts, fb_pt[:, None, :])
    sdist = jnp.where(
        have[:, None],
        sdist,
        jnp.concatenate([d[:, None], jnp.full((P, 7), jnp.inf, dtype)], axis=1),
    )

    nrm = jnp.broadcast_to(n[:, None, :], pts.shape)
    return d, res.pa, res.pb, pts, nrm, sdist


def _mesh_world_tris(scene, pos, quat_b, g):
    """World vertices, world triangle vertices, and face-validity mask of
    triangle-mesh geometries g (one per pair)."""
    from . import trimesh as tmesh

    sp, sq = geom_world_pose(scene, pos, quat_b, g)
    verts = scene.geom_verts[g]                       # (P, V, 3) local
    vw = sp[:, None, :] + quat.rotate(sq[:, None, :], verts)
    faces = scene.geom_faces[g]                       # (P, F, 3)
    tv = tmesh.gather_triangles(vw, faces)            # (P, F, 3, 3)
    fvalid = (
        jnp.arange(faces.shape[1])[None, :] < scene.geom_nfaces[g][:, None]
    )
    vvalid = (
        jnp.arange(verts.shape[1])[None, :] < scene.geom_nverts[g][:, None]
    )
    return vw, vvalid, tv, fvalid


def _topk_slots(sdist, k):
    """Indices + masked sdist of the k smallest signed distances (per row)."""
    vals, idx = jax.lax.top_k(-sdist, k)
    return idx, -vals


def _dedup_points(pts, sd):
    """Mask out later slots whose contact point coincides with an earlier one
    (adjacent faces sharing the closest edge/vertex produce duplicates)."""
    S = pts.shape[-2]
    d2 = jnp.sum(
        (pts[..., :, None, :] - pts[..., None, :, :]) ** 2, axis=-1
    )  # (..., S, S)
    earlier = jnp.arange(S)[None, :] < jnp.arange(S)[:, None]  # (S, S) j < i
    dup = jnp.any((d2 < 1e-16) & earlier[None, :, :], axis=-1)
    return jnp.where(dup, jnp.inf, sd)


def _sphere_trimesh(scene, pos, quat_b, pairs):
    """A = sphere, B = triangle mesh; up to 4 contacts at the nearest faces
    (the reference resolves this through the generic
    `calc_signed_dist`/`calc_dist_and_normal` dispatch over the mesh BVH,
    CCD.inl:649 + TriangleMeshPrimitive::calc_signed_dist)."""
    from . import trimesh as tmesh

    dtype = pos.dtype
    ga = scene.pair_g1[pairs]   # sphere
    gb = scene.pair_g2[pairs]   # mesh
    c, _ = geom_world_pose(scene, pos, quat_b, ga)
    r = scene.geom_params[ga, 0]
    vw, _, tv, fvalid = _mesh_world_tris(scene, pos, quat_b, gb)

    a = tv[:, :, 0, :]
    b = tv[:, :, 1, :]
    c3 = tv[:, :, 2, :]
    q = tmesh.closest_point_triangle(c[:, None, :], a, b, c3)   # (P, F, 3)
    d = jnp.linalg.norm(c[:, None, :] - q, axis=-1)             # (P, F)
    nrm = jnp.cross(b - a, c3 - a)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.maximum(nlen, 1e-30)
    valid = fvalid & (nlen[..., 0] > 1e-20)
    # candidate faces by UNSIGNED distance (signing first would pull in far
    # faces whose outward normal faces away — e.g. the underside of a cube
    # the sphere rests on); the face-normal sign is only meaningful for the
    # locally nearest faces
    du = jnp.where(valid, d, jnp.inf)
    idx, d4u = _topk_slots(du, 4)
    q4 = jnp.take_along_axis(q, idx[:, :, None], axis=1)        # (P, 4, 3)
    n_face4 = jnp.take_along_axis(nrm, idx[:, :, None], axis=1)
    sep_dir = c[:, None, :] - q4
    s4 = jnp.sign(jnp.sum(sep_dir * n_face4, axis=-1))
    s4 = jnp.where(s4 == 0, 1.0, s4).astype(dtype)
    sd4 = jnp.where(jnp.isfinite(d4u), s4 * d4u - r, jnp.inf)
    sep_len = jnp.linalg.norm(sep_dir, axis=-1, keepdims=True)
    sep_n = sep_dir / jnp.maximum(sep_len, 1e-30)
    # normal: from the mesh (geom2) toward the sphere (geom1)
    n4 = jnp.where(
        ((s4 < 0) | (sep_len[..., 0] < 1e-9))[..., None], n_face4, sep_n
    )
    sd4 = _dedup_points(q4, sd4)

    dist = sd4[:, 0]
    pb = q4[:, 0, :]
    pa = c - n4[:, 0, :] * r[:, None]
    pts = 0.5 * (q4 + (c[:, None, :] - n4 * r[:, None, None]))
    return dist, pa, pb, pts, n4, sd4


def _box_point_sdf(half, cl):
    """Signed distance, closest surface point (box local) and outward normal
    for points cl (local box frame). half (P, 3), cl (P, N, 3)."""
    clamped = jnp.clip(cl, -half[:, None, :], half[:, None, :])
    dvec = cl - clamped
    dn = jnp.linalg.norm(dvec, axis=-1)
    outside = dn > 1e-12
    face_d = half[:, None, :] - jnp.abs(cl)          # (P, N, 3)
    ax = jnp.argmin(face_d, axis=-1)                 # (P, N)
    min_face = jnp.min(face_d, axis=-1)
    sd = jnp.where(outside, dn, -min_face)
    n_out = jnp.where(
        outside[..., None],
        dvec / jnp.maximum(dn, 1e-30)[..., None],
        jax.nn.one_hot(ax, 3, dtype=cl.dtype)
        * jnp.sign(jnp.take_along_axis(cl, ax[..., None], axis=-1)),
    )
    # surface point: clamp (outside) or axis projection (inside)
    surf_in = cl + n_out * min_face[..., None]
    surf = jnp.where(outside[..., None], clamped, surf_in)
    return sd, surf, n_out


def _trimesh_convex(scene, pos, quat_b, pairs, nslots):
    """A = triangle mesh, B = box. vmax slots: mesh vertices against the box
    SDF; 8 slots: box corners against the mesh surface. (Reference: generic
    vertex/`calc_dist_and_normal` dispatch, CCD.inl:649.)"""
    from . import trimesh as tmesh

    dtype = pos.dtype
    ga = scene.pair_g1[pairs]   # trimesh
    gb = scene.pair_g2[pairs]   # box
    bp, bq = geom_world_pose(scene, pos, quat_b, gb)
    half = scene.geom_params[gb, :3]
    vw, vvalid, tv, fvalid = _mesh_world_tris(scene, pos, quat_b, ga)
    nv = vw.shape[1]
    nsl_v = nslots - 8   # vertex slots (cap); the other 8 are box corners

    # --- mesh vertices vs box SDF
    cl = quat.inverse_rotate(bq[:, None, :], vw - bp[:, None, :])
    sd_v, _surf, n_loc = _box_point_sdf(half, cl)
    sd_v = jnp.where(vvalid, sd_v, jnp.inf)
    n_v = quat.rotate(bq[:, None, :], n_loc)   # outward from box = g2 -> g1
    pts_v = vw

    # --- box corners vs mesh surface
    signs = jnp.array(
        [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
         for sz in (-1.0, 1.0)], dtype)
    corners_l = signs[None, :, :] * half[:, None, :]
    cw = bp[:, None, :] + quat.rotate(bq[:, None, :], corners_l)  # (P, 8, 3)
    sd_c, q_c, n_out = tmesh.points_vs_mesh(cw, tv, fvalid)
    sep_dir = q_c - cw
    sep_len = jnp.linalg.norm(sep_dir, axis=-1, keepdims=True)
    sep_n = sep_dir / jnp.maximum(sep_len, 1e-30)
    # normal from the box (geom2) toward the mesh (geom1): -outward of the
    # mesh when the corner has penetrated (or sits exactly on the surface),
    # toward the surface otherwise
    n_c = jnp.where(
        ((sd_c < 0) | (sep_len[..., 0] < 1e-9))[..., None], -n_out, sep_n
    )
    pts_c = cw
    sd_c = jnp.where(jnp.isfinite(sd_c), sd_c, jnp.inf)

    # closest points for the conservative-advancement direction: on the mesh
    # (pa) and on the box (pb) — part A pairs (mesh vertex, box surface),
    # part B pairs (mesh surface, box corner); computed over the FULL vertex
    # set before any slot capping
    surf_w = bp[:, None, :] + quat.rotate(bq[:, None, :], _surf)
    sdist_full = jnp.concatenate([sd_v, sd_c], axis=1)
    pa_all = jnp.concatenate([vw, q_c], axis=1)
    pb_all = jnp.concatenate([surf_w, cw], axis=1)
    dist = jnp.min(sdist_full, axis=-1)
    imin = jnp.argmin(sdist_full, axis=-1)
    pa = jnp.take_along_axis(pa_all, imin[:, None, None], axis=1)[:, 0, :]
    pb = jnp.take_along_axis(pb_all, imin[:, None, None], axis=1)[:, 0, :]

    if nsl_v < nv:
        # slot cap: deepest nsl_v mesh vertices
        idx, _ = _topk_slots(sd_v, nsl_v)
        pts_v = jnp.take_along_axis(pts_v, idx[:, :, None], axis=1)
        n_v = jnp.take_along_axis(n_v, idx[:, :, None], axis=1)
        sd_v = jnp.take_along_axis(sd_v, idx, axis=1)

    pts = jnp.concatenate([pts_v, pts_c], axis=1)
    nrm = jnp.concatenate([n_v, n_c], axis=1)
    sdist = jnp.concatenate([sd_v, sd_c], axis=1)
    return dist, pa, pb, pts, nrm, sdist


def _trimesh_trimesh(scene, pos, quat_b, pairs):
    """A, B triangle meshes: deepest 4 vertices of each against the other's
    surface (vertex-vs-closest-triangle with face-normal sign)."""
    from . import trimesh as tmesh

    ga = scene.pair_g1[pairs]
    gb = scene.pair_g2[pairs]
    vwA, vvA, tvA, fvA = _mesh_world_tris(scene, pos, quat_b, ga)
    vwB, vvB, tvB, fvB = _mesh_world_tris(scene, pos, quat_b, gb)

    # A's vertices vs B's surface
    sdA, qA, nA_out = tmesh.points_vs_mesh(vwA, tvB, fvB)
    sdA = jnp.where(vvA, sdA, jnp.inf)
    idxA, sd4A = _topk_slots(sdA, 4)
    ptsA = jnp.take_along_axis(vwA, idxA[:, :, None], axis=1)
    qA4 = jnp.take_along_axis(qA, idxA[:, :, None], axis=1)
    noutA = jnp.take_along_axis(nA_out, idxA[:, :, None], axis=1)
    sepA = ptsA - qA4
    sepA_len = jnp.linalg.norm(sepA, axis=-1, keepdims=True)
    sepAn = sepA / jnp.maximum(sepA_len, 1e-30)
    # normal from B (geom2) toward A (geom1): B's outward normal when
    # penetrating or exactly on the surface (sep vanishes), else the
    # separation direction
    useA = (sd4A < 0) | (sepA_len[..., 0] < 1e-9)
    nA4 = jnp.where(useA[..., None], noutA, sepAn)

    # B's vertices vs A's surface
    sdB, qB, nB_out = tmesh.points_vs_mesh(vwB, tvA, fvA)
    sdB = jnp.where(vvB, sdB, jnp.inf)
    idxB, sd4B = _topk_slots(sdB, 4)
    ptsB = jnp.take_along_axis(vwB, idxB[:, :, None], axis=1)
    qB4 = jnp.take_along_axis(qB, idxB[:, :, None], axis=1)
    noutB = jnp.take_along_axis(nB_out, idxB[:, :, None], axis=1)
    sepB = qB4 - ptsB
    sepB_len = jnp.linalg.norm(sepB, axis=-1, keepdims=True)
    sepBn = sepB / jnp.maximum(sepB_len, 1e-30)
    useB = (sd4B < 0) | (sepB_len[..., 0] < 1e-9)
    nB4 = jnp.where(useB[..., None], -noutB, sepBn)

    pts = jnp.concatenate([ptsA, ptsB], axis=1)
    nrm = jnp.concatenate([nA4, nB4], axis=1)
    sdist = jnp.concatenate([sd4A, sd4B], axis=1)
    sdist = _dedup_points(pts, sdist)

    # pa on mesh A, pb on mesh B (CA direction pa - pb must not vanish)
    pa_all = jnp.concatenate([ptsA, qB4], axis=1)
    pb_all = jnp.concatenate([qA4, ptsB], axis=1)
    dist = jnp.min(sdist, axis=-1)
    imin = jnp.argmin(sdist, axis=-1)
    pa = jnp.take_along_axis(pa_all, imin[:, None, None], axis=1)[:, 0, :]
    pb = jnp.take_along_axis(pb_all, imin[:, None, None], axis=1)[:, 0, :]
    return dist, pa, pb, pts, nrm, sdist


_KERNELS = {
    sc.K_SPHERE_SPHERE: _sphere_sphere,
    sc.K_SPHERE_PLANE: _sphere_plane,
    sc.K_BOX_SPHERE: _box_sphere,
    sc.K_CYLINDER_PLANE: _cylinder_plane,
    sc.K_TORUS_PLANE: _torus_plane,
    sc.K_CONE_PLANE: _cone_plane,
    sc.K_SPHERE_HEIGHTMAP: _sphere_heightmap,
    sc.K_CONVEX_CONVEX: _convex_convex,
    sc.K_SPHERE_TRIMESH: _sphere_trimesh,
    sc.K_TRIMESH_TRIMESH: _trimesh_trimesh,
}


def narrow_phase(scene: sc.Scene, pos, quat_b, tol):
    """Compute pairwise distances and contact slots at the given configuration.

    Returns (PairDist, Contacts). A contact slot is active when its own signed
    distance <= tol AND the owning pair's distance < tol (reference:
    ConstraintSimulator::find_unilateral_constraints, src:488-537, combined
    with each find_contacts_* kernel's own `dist > TOL` cull).
    """
    NP_ = scene.n_pairs
    K = scene.n_contacts
    dtype = pos.dtype

    # per-kind kernel outputs are gathered by a STATIC permutation instead
    # of scattered into zero-initialized tables: the kind groups partition
    # pairs/slots exactly once, so `concatenate + take(static argsort)` is
    # value-identical, and the dynamic-index scatters it replaces were real
    # device-time kernels in the MPC profile
    d_parts, a_parts, b_parts = [], [], []
    pt_parts, n_parts, sd_parts = [], [], []
    pair_idx_parts, slot_idx_parts = [], []
    s1_parts, s2_parts, sp_parts = [], [], []

    for grp in scene.kind_groups.values():
        kind = grp["kind"]
        pairs = grp["pairs"]
        slots = grp["slots"]
        if len(pairs) == 0:
            continue
        if grp.get("pooled"):
            # runtime pair pool (set_pair_pool): prune the class's candidate
            # pairs to the `cap` nearest by the bounding-sphere distance
            # lower bound, then run the kernel on the selected (traced)
            # pairs only — the fixed-shape sweep-and-prune
            # (/root/reference/src/CCD.cpp:702-990 redesigned as one fused
            # vector pass + top_k instead of sorted axis lists).
            cap = grp["cap"]
            nsl = grp["nslots"]
            cand = jnp.asarray(pairs)                    # (P,) static ids
            g1 = scene.pair_g1[cand]
            g2 = scene.pair_g2[cand]
            c1, _ = geom_world_pose(scene, pos, quat_b, g1)
            c2, _ = geom_world_pose(scene, pos, quat_b, g2)
            db = (jnp.linalg.norm(c1 - c2, axis=-1)
                  - scene.geom_rmax[g1] - scene.geom_rmax[g2])
            _, sel_local = jax.lax.top_k(-db, cap)
            # ascending pair order -> stable slot assignment while the
            # neighbor set is stable (keeps zlast warm starts valid)
            sel_local = jnp.sort(sel_local)
            sel = cand[sel_local]                        # (cap,) traced
            d, a, b, pts, nrm, sd = _KERNELS[kind](
                scene, pos, quat_b, sel)
            # full candidate-pair distances: the cheap bound (a true lower
            # bound -> conservative for CA) with exact values scattered in
            d_parts.append(db.at[sel_local].set(d))
            a_parts.append(c1.at[sel_local].set(a))
            b_parts.append(c2.at[sel_local].set(b))
            pair_idx_parts.append(np.asarray(pairs))
            pt_parts.append(pts.reshape(-1, 3))
            n_parts.append(nrm.reshape(-1, 3))
            sd_parts.append(sd.reshape(-1))
            slot_idx_parts.append(np.asarray(slots))
            sel_rep = jnp.repeat(sel, nsl)
            sp_parts.append(sel_rep)
            s1_parts.append(scene.geom_slot[scene.pair_g1[sel_rep]])
            s2_parts.append(scene.geom_slot[scene.pair_g2[sel_rep]])
            continue
        if "kernel" in grp:
            # custom plugin kernel (CollisionDetectionPlugin equivalent)
            d, a, b, pts, nrm, sd = grp["kernel"](scene, pos, quat_b, pairs)
        elif kind == sc.K_PLANE_GENERIC:
            d, a, b, pts, nrm, sd = _plane_generic(
                scene, pos, quat_b, pairs, grp["nslots"]
            )
        elif kind == sc.K_BOX_BOX:
            d, a, b, pts, nrm, sd = _box_box(
                scene, pos, quat_b, pairs, grp["nslots"]
            )
        elif kind == sc.K_VERTS_HEIGHTMAP:
            d, a, b, pts, nrm, sd = _verts_heightmap(
                scene, pos, quat_b, pairs, grp["nslots"]
            )
        elif kind == sc.K_TRIMESH_CONVEX:
            d, a, b, pts, nrm, sd = _trimesh_convex(
                scene, pos, quat_b, pairs, grp["nslots"]
            )
        elif kind >= sc.K_SUPPORT_TM_BASE:
            # triangle mesh vs curved convex (static convex type in kind)
            from .support import get_support_tm_kernel

            d, a, b, pts, nrm, sd = get_support_tm_kernel(
                kind - sc.K_SUPPORT_TM_BASE
            )(scene, pos, quat_b, pairs, grp["nslots"])
        elif kind >= sc.K_SUPPORT_HM_BASE:
            # curved convex vs heightmap (static convex type in kind)
            from .support import get_support_hm_kernel

            d, a, b, pts, nrm, sd = get_support_hm_kernel(
                kind - sc.K_SUPPORT_HM_BASE
            )(scene, pos, quat_b, pairs)
        elif kind >= sc.K_SUPPORT_BASE:
            # generic convex pair with static types encoded in the kind
            from .support import get_support_kernel

            ta = (kind - sc.K_SUPPORT_BASE) // 16
            tb = (kind - sc.K_SUPPORT_BASE) % 16
            d, a, b, pts, nrm, sd = get_support_kernel(ta, tb)(
                scene, pos, quat_b, pairs
            )
        else:
            d, a, b, pts, nrm, sd = _KERNELS[kind](scene, pos, quat_b, pairs)
        d_parts.append(d)
        a_parts.append(a)
        b_parts.append(b)
        pt_parts.append(pts.reshape(-1, 3))
        n_parts.append(nrm.reshape(-1, 3))
        sd_parts.append(sd.reshape(-1))
        pair_idx_parts.append(np.asarray(pairs))
        slot_idx_parts.append(np.asarray(slots))
        slots_np = np.asarray(slots)
        sp_parts.append(scene.slot_pair[slots_np])
        s1_parts.append(scene.slot_s1[slots_np])
        s2_parts.append(scene.slot_s2[slots_np])

    if pair_idx_parts:
        pair_perm = np.argsort(np.concatenate(pair_idx_parts))
        dist = jnp.concatenate(d_parts)[pair_perm]
        pa = jnp.concatenate(a_parts)[pair_perm]
        pb = jnp.concatenate(b_parts)[pair_perm]
    else:
        dist = jnp.zeros(NP_, dtype)
        pa = jnp.zeros((NP_, 3), dtype)
        pb = jnp.zeros((NP_, 3), dtype)
    if slot_idx_parts and K:
        slot_perm = np.argsort(np.concatenate(slot_idx_parts))
        cpoint = jnp.concatenate(pt_parts)[slot_perm]
        cnormal = jnp.concatenate(n_parts)[slot_perm]
        csdist = jnp.concatenate(sd_parts)[slot_perm]
    else:
        cpoint = jnp.zeros((K, 3), dtype)
        cnormal = jnp.zeros((K, 3), dtype)
        csdist = jnp.full(K, jnp.inf, dtype)
    if slot_idx_parts and K:
        slot_perm = np.argsort(np.concatenate(slot_idx_parts))
        slot_s1 = jnp.concatenate(s1_parts)[slot_perm].astype(jnp.int32)
        slot_s2 = jnp.concatenate(s2_parts)[slot_perm].astype(jnp.int32)
        slot_pr = jnp.concatenate(sp_parts)[slot_perm].astype(jnp.int32)
    else:
        slot_s1 = scene.slot_s1
        slot_s2 = scene.slot_s2
        slot_pr = scene.slot_pair

    pair_dist_of_slot = dist[slot_pr]
    active = (csdist <= tol) & (pair_dist_of_slot < tol)
    t1, t2 = orthonormal_basis(cnormal)
    return (
        PairDist(dist=dist, pa=pa, pb=pb),
        Contacts(
            active=active,
            point=cpoint,
            normal=cnormal,
            depth=jnp.where(jnp.isfinite(csdist), csdist, 0.0),
            tan1=t1,
            tan2=t2,
            s1=slot_s1,
            s2=slot_s2,
            pair=slot_pr,
        ),
    )


def pair_distances(scene: sc.Scene, pos, quat_b) -> PairDist:
    """Distances + closest points only (CA loop hot path)."""
    pd, _ = narrow_phase(scene, pos, quat_b, jnp.inf)
    return pd


def plane_generic_sweep_bound(scene: sc.Scene, pt, near_zero):
    """Vertex-sweep CA bound for touching plane-vs-vertex-solid pairs
    (CCD::calc_next_CA_Euler_step_polyhedron_plane, src/CCD.cpp:407-461,
    dispatched from calc_next_CA_Euler_step_generic :238-401): every solid
    vertex still separated from the contact plane can reach it no sooner than
    dist / max(0, -n·v_rel + |ω_rel|·r).  Returns a (n_pairs,) bound, +inf
    for pairs of other kinds (the reference's "don't know what to do" INF
    fallback) and for vertices moving away."""
    INF = jnp.inf
    dtype = pt.pos.dtype
    out = jnp.full(scene.n_pairs, INF, dtype)
    for kind, grp in scene.kind_groups.items():
        if kind != sc.K_PLANE_GENERIC or len(grp["pairs"]) == 0:
            continue
        pairs = grp["pairs"]
        ga = scene.pair_g1[pairs]   # plane
        gb = scene.pair_g2[pairs]   # vertex solid
        pp, pq = geom_world_pose(scene, pt.pos, pt.quat, ga)
        sp, sq = geom_world_pose(scene, pt.pos, pt.quat, gb)
        up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype=dtype))
        # the CA bound sweeps ALL vertices (independent of the contact-slot
        # cap: any vertex can reach the plane)
        verts = scene.geom_verts[gb]
        V = verts.shape[1]
        nv = scene.geom_nverts[gb]
        vw = sp[:, None, :] + quat.rotate(sq[:, None, :], verts)
        y = jnp.sum((vw - pp[:, None, :]) * up[:, None, :], axis=-1)
        # ignore vertices already at the plane (reference: dist < NEAR_ZERO)
        valid = (jnp.arange(V)[None, :] < nv[:, None]) & (y >= near_zero)

        s1 = scene.geom_slot[ga]
        s2 = scene.geom_slot[gb]
        # relative linear velocity at the solid's geometry origin (the
        # reference transforms the spatial velocity to the polyhedron pose)
        v1 = pt.vel[s1] + jnp.cross(pt.omega[s1], sp - pt.pos[s1])
        v2 = pt.vel[s2] + jnp.cross(pt.omega[s2], sp - pt.pos[s2])
        lv_dot_n = -jnp.sum(up * (v2 - v1), axis=-1)
        w_rel = jnp.linalg.norm(pt.omega[s2] - pt.omega[s1], axis=-1)
        r = jnp.linalg.norm(verts, axis=-1)
        speed = jnp.maximum(0.0, lv_dot_n[:, None] + w_rel[:, None] * r)
        step = jnp.where(
            valid & (speed > 0.0), y / jnp.maximum(speed, 1e-300), INF
        )
        bound = jnp.min(
            jnp.concatenate([step, jnp.full((len(pairs), 1), INF, dtype)], 1),
            axis=-1,
        )
        out = out.at[pairs].set(bound)
    return out
