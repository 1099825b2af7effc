"""Triangle-mesh geometry: point-triangle kernels, mesh mass properties,
OBJ indexed-mesh loading.

Fixed-shape counterpart of the reference's `TriangleMeshPrimitive`
(src/TriangleMeshPrimitive.cpp:1-1169) and the mass-property integrals of
`TessellatedPolyhedron` (src/TessellatedPolyhedron.cpp, after Mirtich's
polyhedral mass properties): instead of a BVH walked pointer-by-pointer, a
mesh is a fixed-shape (VMAX, 3) vertex table + (FMAX, 3) face-index table and
every query is a masked reduction over all faces — the all-pairs "broad
phase within the primitive" that maps onto vector units instead of branchy
tree descent.

Meshes are assumed watertight with outward-oriented faces (the reference
makes the same assumption for its signed distances,
TriangleMeshPrimitive::calc_signed_dist).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------- loading

def load_obj(path):
    """Load a Wavefront OBJ as an indexed triangle mesh.

    Returns (verts (V, 3) float64, faces (F, 3) int32). Polygon faces are
    fan-triangulated. (The reference reads meshes through
    `IndexedTriArray::read_from_obj`, src/IndexedTriArray.cpp.)
    """
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


# ------------------------------------------------------- mass properties

def mesh_mass_properties(verts, faces, density=1.0):
    """Volume, center of mass, and inertia tensor (about the COM, in the
    mesh frame) of a watertight outward-oriented triangle mesh.

    Divergence-theorem tetrahedron decomposition against the origin — the
    same integrals `TessellatedPolyhedron::calc_volume_ints` computes
    (reference src/TessellatedPolyhedron.cpp). Returns
    (volume, com (3,), J (3,3) about com, mass) at the given density.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    # signed tetra volumes against the origin
    cr = np.cross(b, c)
    vol6 = np.einsum("ij,ij->i", a, cr)   # 6 * signed volume
    volume = vol6.sum() / 6.0
    # tetra centroid (0 + a + b + c)/4, tetra volume vol6/6:
    # integral of x over the tet = vol6/24 * (a + b + c)
    com = ((a + b + c) * vol6[:, None] / 24.0).sum(axis=0) / max(volume, 1e-300)

    # inertia integrals: for each tetra with vertices 0, a, b, c the integral
    # of x_i x_j over the tetra is V/20 * (sum_k sum_l<=k v_k,i v_l,j sym.)
    # Use the standard covariance formulation:
    #   C = sum_tets (vol6/120) * (P^T P + trace-term), P rows = a, b, c
    C = np.zeros((3, 3))
    for i in range(len(a)):
        P = np.stack([a[i], b[i], c[i]])
        s = P.sum(axis=0)
        Ci = (P.T @ P + np.outer(s, s)) * (vol6[i] / 120.0)
        C += Ci
    # shift to COM
    C -= volume * np.outer(com, com)
    J = np.eye(3) * np.trace(C) - C
    mass = density * volume
    return volume, com, density * J, mass


def mesh_inertia(mass, verts, faces):
    """(3, 3) inertia about the COM scaled to the given total mass."""
    volume, com, J_unit, _ = mesh_mass_properties(verts, faces, density=1.0)
    if volume <= 0:
        raise ValueError("mesh has non-positive volume (check orientation)")
    return J_unit * (mass / volume), com, volume


# ------------------------------------------------- point-triangle kernels

def closest_point_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p; branchless Voronoi-region
    select (Ericson, Real-Time Collision Detection §5.1.5). Batched over
    leading dims."""
    tiny = jnp.asarray(1e-30, p.dtype)

    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    def safe_div(x, y):
        return x / jnp.where(jnp.abs(y) > tiny, y, 1.0)

    # interior
    denom = va + vb + vc
    v_int = safe_div(vb, denom)
    w_int = safe_div(vc, denom)
    q = a + ab * v_int[..., None] + ac * w_int[..., None]
    # edge bc
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    r_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    q = jnp.where(r_bc[..., None], b + (c - b) * w_bc[..., None], q)
    # edge ac
    w_ac = safe_div(d2, d2 - d6)
    r_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    q = jnp.where(r_ac[..., None], a + ac * w_ac[..., None], q)
    # edge ab
    v_ab = safe_div(d1, d1 - d3)
    r_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    q = jnp.where(r_ab[..., None], a + ab * v_ab[..., None], q)
    # vertices
    r_c = (d6 >= 0) & (d5 <= d6)
    q = jnp.where(r_c[..., None], c, q)
    r_b = (d3 >= 0) & (d4 <= d3)
    q = jnp.where(r_b[..., None], b, q)
    r_a = (d1 <= 0) & (d2 <= 0)
    q = jnp.where(r_a[..., None], a, q)
    return q


def gather_triangles(verts_w, faces, ):
    """(P, V, 3) world verts + (P, F, 3) index table -> (P, F, 3, 3)."""
    return jax.vmap(lambda v, f: v[f])(verts_w, faces)


# face-axis tile size: below this the (N, F) product materializes whole;
# above, a lax.scan over face tiles bounds the working set to (N, CHUNK)
# while keeping the identical closest-face result (the fixed-shape stand-in
# for the reference's BVH descent, TriangleMeshPrimitive::get_BVH_root)
FACE_CHUNK = 256


def _closest_face_block(points, tv, valid_f):
    """Min over one face block: (dmin (P, N), qmin, nmin) — unsigned."""
    a = tv[:, None, :, 0, :]   # (P, 1, Fc, 3)
    b = tv[:, None, :, 1, :]
    c = tv[:, None, :, 2, :]
    p = points[:, :, None, :]  # (P, N, 1, 3)
    q = closest_point_triangle(p, a, b, c)       # (P, N, Fc, 3)
    d = jnp.linalg.norm(p - q, axis=-1)          # (P, N, Fc)

    nrm = jnp.cross(tv[:, :, 1, :] - tv[:, :, 0, :],
                    tv[:, :, 2, :] - tv[:, :, 0, :])   # (P, Fc, 3)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    degenerate = nlen[..., 0] < 1e-20
    nrm = nrm / jnp.maximum(nlen, 1e-30)

    valid = valid_f & ~degenerate                # (P, Fc)
    dv = jnp.where(valid[:, None, :], d, jnp.inf)
    imin = jnp.argmin(dv, axis=-1)               # (P, N)
    qmin = jnp.take_along_axis(q, imin[:, :, None, None], axis=2)[:, :, 0, :]
    nmin = jnp.take_along_axis(
        jnp.broadcast_to(nrm[:, None, :, :], q.shape),
        imin[:, :, None, None], axis=2,
    )[:, :, 0, :]
    dmin = jnp.take_along_axis(dv, imin[:, :, None], axis=2)[:, :, 0]
    return dmin, qmin, nmin


def points_vs_mesh(points, tv, face_valid):
    """Signed distance of query points to a watertight outward-oriented mesh.

    points (P, N, 3); tv (P, F, 3, 3) triangle vertices; face_valid (P, F).
    Returns (sdist (P, N), q (P, N, 3) closest surface point,
    n_out (P, N, 3) outward normal of the owning face).

    Sign: positive outside, negative inside, decided by the closest face's
    outward normal (shallow-penetration regime — the same convention as the
    reference's `TriangleMeshPrimitive::calc_signed_dist`). Meshes beyond
    FACE_CHUNK faces stream through a face-tiled scan so the (N, F) product
    never materializes (memory O(N·FACE_CHUNK), compute unchanged).
    """
    dtype = points.dtype
    F = tv.shape[1]
    if F <= FACE_CHUNK:
        dmin, qmin, nmin = _closest_face_block(points, tv, face_valid)
    else:
        nch = -(-F // FACE_CHUNK)
        pad = nch * FACE_CHUNK - F
        tv_p = jnp.pad(tv, ((0, 0), (0, pad), (0, 0), (0, 0)))
        fv_p = jnp.pad(face_valid, ((0, 0), (0, pad)))
        P, N = points.shape[:2]
        tv_c = tv_p.reshape(P, nch, FACE_CHUNK, 3, 3)
        fv_c = fv_p.reshape(P, nch, FACE_CHUNK)

        def body(carry, inp):
            dmin, qmin, nmin = carry
            tvc, fvc = inp
            d2, q2, n2 = _closest_face_block(points, tvc, fvc)
            better = d2 < dmin
            return (
                jnp.where(better, d2, dmin),
                jnp.where(better[..., None], q2, qmin),
                jnp.where(better[..., None], n2, nmin),
            ), None

        init = (
            jnp.full((P, N), jnp.inf, dtype),
            jnp.zeros((P, N, 3), dtype),
            jnp.zeros((P, N, 3), dtype),
        )
        (dmin, qmin, nmin), _ = jax.lax.scan(
            body, init,
            (jnp.swapaxes(tv_c, 0, 1), jnp.swapaxes(fv_c, 0, 1)),
        )

    s = jnp.sign(jnp.sum((points - qmin) * nmin, axis=-1))
    s = jnp.where(s == 0, 1.0, s).astype(dtype)
    sdist = jnp.where(jnp.isfinite(dmin), s * dmin, jnp.inf)
    return sdist, qmin, nmin


def extrude_polygon(poly_xz, y0, y1, apex: int = 0):
    """Watertight triangle mesh of a prism: the simple polygon `poly_xz`
    ((N, 2), in the xz plane, any winding) extruded along y from y0 to y1.

    Caps are fan-triangulated from vertex `apex`, so the polygon must be
    star-shaped as seen from that vertex (true for convex polygons from any
    vertex, and for a V-notch channel from the notch vertex). Faces come out
    outward-oriented (orientation fixed by a signed-volume check).
    """
    poly = np.asarray(poly_xz, np.float64)
    # normalize winding to CCW in the (x, z) plane (shoelace > 0) so caps and
    # sides come out consistently outward
    shoelace = np.sum(
        poly[:, 0] * np.roll(poly[:, 1], -1)
        - np.roll(poly[:, 0], -1) * poly[:, 1]
    )
    if shoelace < 0:
        poly = poly[::-1].copy()
        apex = len(poly) - 1 - apex
    n = len(poly)
    lo = np.stack([poly[:, 0], np.full(n, float(y0)), poly[:, 1]], axis=1)
    hi = np.stack([poly[:, 0], np.full(n, float(y1)), poly[:, 1]], axis=1)
    verts = np.concatenate([lo, hi])   # lo: 0..n-1, hi: n..2n-1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        # side quad (lo_i, hi_i, hi_j, lo_j), outward for a CCW (x, z) polygon
        faces.append([i, n + i, n + j])
        faces.append([i, n + j, j])
    for k in range(1, n - 1):
        a = apex
        b = (apex + k) % n
        c = (apex + k + 1) % n
        # CCW in (x, z) has triangle normal -y: that is the bottom cap
        faces.append([a, b, c])              # bottom cap (outward -y)
        faces.append([n + a, n + c, n + b])  # top cap (outward +y)
    faces = np.asarray(faces, np.int32)
    vol, _, _, _ = mesh_mass_properties(verts, faces)
    if vol <= 0:
        raise ValueError("extrude_polygon produced a non-positive volume "
                         "(polygon not simple, or not star-shaped from apex)")
    return verts, faces
