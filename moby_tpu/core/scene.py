"""Scene compilation: a Moby-style scene -> static fixed-shape arrays.

Accelerator-first design: where the reference keeps a pointer graph of bodies,
geometries and per-pair `ContactParameters` resolved at runtime
(`src/ConstraintSimulator.cpp:82-155`), we compile the whole scene host-side
into a `Scene` pytree of fixed-shape arrays:

* rigid bodies and articulated-body links -> "pose slots": a flat table of
  world poses/velocities recomputed each step (free body i = slot i;
  link l of articulated body k = slot nb + link_offset),
* generalized coordinates -> one global gc vector: 6 per enabled free body
  ([v; ω] spatial, the reference's eSpatial layout) followed by each
  articulated body's nv joint velocities,
* collision geometries -> typed parameter table with local poses folded in,
* candidate pairs -> a static pair table grouped by narrow-phase kind
  (the reference's double-dispatch table, include/Moby/CCD.inl:3-81,
  becomes per-kind vectorized kernels),
* contact slots -> fixed-K layout with per-slot static contact parameters
  (epsilon, mu, NK, compliance) resolved from ContactParameters at build,
* joint limits -> fixed slots (2 per limited dof: upper+lower), active when
  q crosses the limit (ArticulatedBody::find_limit_constraints),
* friction-cone rows -> a static (contact, cos θ, sin θ) table mirroring
  `setup_QP`'s NK/2 half-plane rows (src/ImpactConstraintHandlerQP.cpp:456-479).

One simulation step is a pure jittable function of (State, Scene); a batch of
scenarios is `vmap` over State.
"""

from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import config as cfg
from ..dynamics import model as amdl

# geometry type codes
SPHERE = 0
PLANE = 1
BOX = 2
CYLINDER = 3
CONE = 4
TORUS = 5
HEIGHTMAP = 6
POLYHEDRON = 7
NONE = 8          # ghost geometry: anchor for custom/plugin contact kernels
TRIMESH = 9       # non-convex indexed triangle mesh (TriangleMeshPrimitive)

# narrow-phase kind codes (mirrors CCD::find_contacts dispatch,
# include/Moby/CCD.inl:3-81)
K_SPHERE_SPHERE = 0   # A=sphere, B=sphere, 1 slot
K_SPHERE_PLANE = 1    # A=sphere, B=plane, 1 slot
K_BOX_SPHERE = 2      # A=box, B=sphere, 1 slot
K_PLANE_GENERIC = 3   # A=plane, B=vertex-carrying solid, vmax slots
K_CYLINDER_PLANE = 4  # A=cylinder, B=plane, 4 slots
K_TORUS_PLANE = 5     # A=torus, B=plane, 4 slots
K_BOX_BOX = 6         # A=box, B=box: vertex-vs-box both ways, 2*vmax slots
K_SPHERE_HEIGHTMAP = 7   # A=sphere, B=heightmap, 1 slot
K_VERTS_HEIGHTMAP = 8    # A=vertex solid, B=heightmap, vmax slots
K_CONVEX_CONVEX = 9      # A,B convex clouds: GJK + MTV manifold, 8 slots
K_CONE_PLANE = 10        # A=cone, B=plane, 4 slots
K_SPHERE_TRIMESH = 11    # A=sphere, B=triangle mesh, 4 slots
K_TRIMESH_CONVEX = 12    # A=trimesh, B=box: verts-vs-box + corners-vs-mesh
K_TRIMESH_TRIMESH = 13   # A,B trimeshes: verts-vs-faces both ways, 8 slots

# generic convex-convex support-function fallback (the reference's GJK +
# get_supporting_point generic dispatch, include/Moby/CCD.inl:649-738):
# kinds >= K_SUPPORT_BASE encode the STATIC type pair as
# K_SUPPORT_BASE + ta*16 + tb so each combination compiles to its own
# vectorized kernel (geometry/support.py)
K_SUPPORT_BASE = 100
SUPPORT_CONVEX_TYPES = frozenset(
    {SPHERE, BOX, CYLINDER, CONE, TORUS, POLYHEDRON}
)
SUPPORT_NSLOTS = 10   # 5 tilted support points per side
# curved convex (cylinder/cone/torus) vs heightmap: support-point sampling
# against the bilinear grid (reference find_contacts_convex_heightmap,
# include/Moby/CCD.inl:33,70). kind = K_SUPPORT_HM_BASE + ta (A=convex,
# B=heightmap).
K_SUPPORT_HM_BASE = 300
SUPPORT_HM_NSLOTS = 5
# triangle mesh vs curved convex: mesh vertices against the primitive's
# closed-form SDF + primitive support probes against the mesh surface
# (reference generic find_contacts_generic, CCD.inl:81,649-738).
# kind = K_SUPPORT_TM_BASE + tb (A=trimesh, B=convex).
K_SUPPORT_TM_BASE = 400
CURVED_CONVEX_TYPES = frozenset({CYLINDER, CONE, TORUS})
# pairs with legitimately no contact kernel (two fixed environment fields /
# plugin ghost anchors) — skipped silently, like the reference never
# registering them in its dispatch table
_SKIP = "skip"


# vertex-driven contact-slot cap: pair kinds that emit one slot per vertex
# cap at the VSLOT_CAP deepest vertices instead (kernels top-k select when
# the geometry has more). A physical contact manifold needs <= ~8 points;
# without the cap a 1k-vertex mesh would blow the QP-LCP to 5000+ variables.
# Scenes with vmax <= VSLOT_CAP (all the reference golden scenes: boxes have
# 8 vertices) are bit-identical to the uncapped layout.
VSLOT_CAP = 16

# pair kinds eligible for runtime pair pooling (SceneBuilder.set_pair_pool):
# bounded geometries with pure-gather kernels that accept traced pair indices
_POOLABLE_KINDS = frozenset({K_SPHERE_SPHERE, K_BOX_SPHERE})


def _kind_nslots(kind: int, vmax: int) -> int:
    if kind >= K_SUPPORT_TM_BASE:
        # capped mesh verts inside the primitive + 8 support probes vs mesh
        # (4 nearest-face normals + 4 tilted around the nearest one, which
        # turn a flat-feature contact into a stable line/face manifold)
        return min(vmax, VSLOT_CAP) + 8
    if kind >= K_SUPPORT_HM_BASE:
        return SUPPORT_HM_NSLOTS
    if kind >= K_SUPPORT_BASE:
        return SUPPORT_NSLOTS
    if kind in (K_SPHERE_SPHERE, K_SPHERE_PLANE, K_BOX_SPHERE):
        return 1
    if kind == K_PLANE_GENERIC:
        return min(vmax, VSLOT_CAP)
    if kind in (K_CYLINDER_PLANE, K_TORUS_PLANE, K_CONE_PLANE):
        return 4
    if kind == K_BOX_BOX:
        return 2 * min(vmax, VSLOT_CAP)
    if kind == K_SPHERE_HEIGHTMAP:
        return 1
    if kind == K_VERTS_HEIGHTMAP:
        return min(vmax, VSLOT_CAP)
    if kind == K_CONVEX_CONVEX:
        return 8  # 4+4 bidirectional vertex-vs-supporting-plane manifold
    if kind == K_SPHERE_TRIMESH:
        return 4
    if kind == K_TRIMESH_CONVEX:
        # capped mesh verts in box + 8 box corners vs mesh
        return min(vmax, VSLOT_CAP) + 8
    if kind == K_TRIMESH_TRIMESH:
        return 8  # 4+4 deepest vertices-vs-faces, both directions
    raise ValueError(f"unknown kind {kind}")


def static_field(default=None):
    """A `pytree_dataclass` field kept out of the pytree's children: it is
    part of the treedef (aux data), so a change of value retraces."""
    return dataclasses.field(default=default, metadata={"static": True})


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree. Fields made with
    `static_field` are aux data; every other field is a child (None
    children are empty subtrees). `obj.replace(**changes)` returns a copy
    with the given fields changed."""
    cls = dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


class ABEntry:
    """Static per-articulated-body metadata (not a pytree leaf)."""

    def __init__(self, name, model: amdl.ArticulatedModel, gc_off, q_off, v_off):
        self.name = name
        self.model = model
        self.gc_off = gc_off  # column offset in the global gc vector
        self.q_off = q_off    # offset into State.q_art
        self.v_off = v_off    # offset into State.qd_art


@pytree_dataclass
class Scene:
    """Static compiled scene. All arrays fixed-shape; `vmap`-compatible."""

    # ---- free rigid bodies (nb,)
    mass: jnp.ndarray
    inv_mass: jnp.ndarray        # 0 for disabled
    inertia: jnp.ndarray         # (nb, 3, 3) body frame
    inv_inertia: jnp.ndarray
    enabled: jnp.ndarray         # (nb,) bool

    # ---- pose slots (ns = nb + total links)
    slot_enabled: jnp.ndarray    # (ns,) bool
    slot_rmax: jnp.ndarray       # (ns,) farthest-point distance (CA bound)

    # ---- geometries (ng,)
    geom_slot: jnp.ndarray       # (ng,) int32 pose slot
    geom_pos: jnp.ndarray        # (ng, 3) local position in slot frame
    geom_quat: jnp.ndarray       # (ng, 4) local orientation (xyzw)
    geom_params: jnp.ndarray     # (ng, 4)

    # ---- candidate pairs (np_,)
    pair_g1: jnp.ndarray
    pair_g2: jnp.ndarray
    pair_kind: jnp.ndarray
    pair_slot0: jnp.ndarray
    pair_nslots: jnp.ndarray

    # ---- contact slots (K,)
    slot_pair: jnp.ndarray       # (K,) owning pair
    slot_s1: jnp.ndarray         # (K,) pose slot of geom1 (Moby's contact_geom1)
    slot_s2: jnp.ndarray         # (K,) pose slot of geom2
    slot_eps: jnp.ndarray
    slot_mu_c: jnp.ndarray
    slot_mu_v: jnp.ndarray
    slot_compliance: jnp.ndarray
    slot_compliant: jnp.ndarray   # (K,) bool: penalty (spring-damper) contact
    slot_truecone: jnp.ndarray    # (K,) bool: NK = inf -> true friction cone
    slot_kp: jnp.ndarray          # (K,) penalty stiffness
    slot_kv: jnp.ndarray          # (K,) penalty damping

    # ---- joint-limit slots (NL,)
    lim_gc_col: jnp.ndarray      # (NL,) int32 gc column of the limited dof
    lim_q_idx: jnp.ndarray       # (NL,) int32 index into q_art of the dof
    lim_upper: jnp.ndarray       # (NL,) bool
    lim_value: jnp.ndarray       # (NL,) limit position
    lim_eps: jnp.ndarray         # (NL,) limit restitution

    # ---- friction-cone rows (NF,)
    fr_con: jnp.ndarray
    fr_cos: jnp.ndarray
    fr_sin: jnp.ndarray

    # ---- vertex table (plane_generic contacts / CA bounds)
    geom_verts: jnp.ndarray      # (ng, VMAX, 3)
    geom_nverts: jnp.ndarray     # (ng,)

    # ---- heightmap grids (HEIGHTMAP geoms; params[0] = grid slot)
    hm_heights: jnp.ndarray      # (n_hm, R, C)
    hm_size: jnp.ndarray         # (n_hm, 2): width (x), depth (z)

    # ---- forces / solver config
    gravity: jnp.ndarray
    contact_dist_thresh: jnp.ndarray
    min_step_size: jnp.ndarray
    dissipation_lambda: jnp.ndarray  # (nb,)
    drag_lin: jnp.ndarray            # (nb,) linear drag coefficient
    drag_ang: jnp.ndarray            # (nb,) angular drag coefficient

    # ---- static metadata
    nb: int = static_field(0)
    ng: int = static_field(0)
    n_pose_slots: int = static_field(0)
    ngc: int = static_field(0)
    nq_art: int = static_field(0)
    nv_art: int = static_field(0)
    n_pairs: int = static_field(0)
    n_contacts: int = static_field(0)
    n_friction_rows: int = static_field(0)
    n_limits: int = static_field(0)
    vmax: int = static_field(0)
    geom_faces: jnp.ndarray = None   # (ng, FMAX, 3) int32 triangle indices
    geom_nfaces: jnp.ndarray = None  # (ng,)
    # hull candidate directions for exact convex-convex penetration
    # (face normals + edge dirs, local frame, deduped up to sign)
    geom_hull_normals: jnp.ndarray = None  # (ng, FN, 3)
    geom_nhn: jnp.ndarray = None           # (ng,)
    geom_hull_edges: jnp.ndarray = None    # (ng, ED, 3)
    geom_nhe: jnp.ndarray = None           # (ng,)
    # all contacts have mu >= 100 -> the no-slip MLCP model
    # (ImpactConstraintHandler::apply_model's `all_inf` branch, :123-131)
    use_noslip: bool = static_field(False)
    # any contact requests the true friction cone (NK = UINF) -> the NQP
    # model for the whole problem (use_qp_solver, :629-640)
    use_nqp: bool = static_field(False)
    # contact slots disagree on the impact model -> per-island (per connected
    # constraint group) model routing at runtime, the reference's per-group
    # dispatch (`apply_model`, src/ImpactConstraintHandler.cpp:113-151)
    mixed_models: bool = static_field(False)
    has_compliant: bool = static_field(False)
    # constraint-stabilization iteration cap (XML
    # constraint-stabilization-max-iterations; 0 disables)
    stab_max_iters: int = static_field(4)
    # legacy velocity-first integration ordering (the stepper that produced
    # some of the reference's golden trajectories, predating the current
    # position-first TimeSteppingSimulator::do_mini_step): per step,
    # v <- impact(v + a*h) evaluated at q_k, then q <- q + v_plus * h
    legacy_velocity_first: bool = static_field(False)
    arts: Any = static_field(())      # tuple[ABEntry]
    bilaterals: Any = static_field(())  # tuple[Bilateral]
    kind_groups: Any = static_field(None)
    body_names: Any = static_field(None)
    # (ng,) shape-only bounding radius (pair-pool broad-phase cull bound)
    geom_rmax: jnp.ndarray = None
    # any kind group is pooled (set_pair_pool): contact-slot pair/body
    # identity is runtime data (Contacts.s1/s2/pair), islands collapse to
    # one group, and the static slot_s1/s2/pair tables are placeholders
    # for the pooled block
    has_dyn_slots: bool = static_field(False)

    @property
    def n_vars(self) -> int:
        """QP variable layout [cn cs ct ncs nct l]
        (UnilateralConstraintProblemData.h:187-205)."""
        return 5 * self.n_contacts + self.n_limits

    @property
    def n_ineq(self) -> int:
        return self.n_contacts + self.n_limits + self.n_friction_rows

    @property
    def n_lcp(self) -> int:
        return self.n_vars + self.n_ineq


@pytree_dataclass
class State:
    """Dynamic simulation state (one scenario)."""

    pos: jnp.ndarray     # (nb, 3)
    quat: jnp.ndarray    # (nb, 4)
    vel: jnp.ndarray     # (nb, 3)
    omega: jnp.ndarray   # (nb, 3)
    q_art: jnp.ndarray   # (nq_art,)
    qd_art: jnp.ndarray  # (nv_art,)
    time: jnp.ndarray
    zlast: jnp.ndarray
    zlast_active: jnp.ndarray
    min_dist_obs: jnp.ndarray
    # solver-effort observability (the reference's LCP pivot counters,
    # include/Moby/LCP.h:30): accumulated over the mini-steps of the last
    # `step` call; int32 scalars
    solver_pivots: jnp.ndarray = None
    solver_fallbacks: jnp.ndarray = None


@dataclass
class BodyDef:
    name: str
    mass: float = 0.0
    inertia: np.ndarray = None
    pos: np.ndarray = None
    quat: np.ndarray = None
    lin_vel: np.ndarray = None
    ang_vel: np.ndarray = None
    enabled: bool = True
    dissipation: float = 1.0
    compliant: bool = False


@dataclass
class GeomDef:
    body: str                    # body name or "abname/linkname"
    gtype: int
    params: np.ndarray
    pos: np.ndarray = None
    quat: np.ndarray = None
    verts: np.ndarray = None
    rmax: float = None           # override for the CA motion-bound radius
    heights: np.ndarray = None   # (R, C) grid for HEIGHTMAP geoms
    faces: np.ndarray = None     # (F, 3) int triangle indices for TRIMESH


@dataclass
class ContactParams:
    """Reference ContactParameters defaults (ContactParameters.cpp:23-26)."""

    epsilon: float = 0.0
    mu_coulomb: float = 0.0
    mu_viscous: float = 0.0
    nk: int = 4            # friction-cone edges; <= 0 means the true cone
                           # (reference contact_NK == UINF -> NQP model,
                           # ImpactConstraintHandler::use_qp_solver :629)
    compliance: float = 0.0
    penalty_kp: float = 0.0
    penalty_kv: float = 0.0
    # cap on this pair's contact-manifold slots (0 = kernel default).
    # Vertex-driven kernels keep their max_slots DEEPEST points; a stable
    # resting manifold needs 3-4, while a 128-vertex hull otherwise claims
    # VSLOT_CAP slots and every slot is 6+ LCP rows — the dominant cost of
    # articulated contact-MPC on mesh-hull geometry.
    max_slots: int = 0


def box_vertices(hx, hy, hz) -> np.ndarray:
    return np.array(
        [
            [sx * hx, sy * hy, sz * hz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ]
    )


def _hull_candidate_dirs(verts):
    """Face unit normals and edge unit directions (each deduped up to sign)
    of conv(verts), via the native quickhull (scipy-qhull fallback inside
    `native.convex_hull` keeps this available on a fresh clone). Returns
    (normals (FN,3), edge_dirs (ED,3)), or (None, None) only for genuinely
    degenerate (flat/collinear) vertex clouds."""
    try:
        from .. import native

        hv, faces = native.convex_hull(np.asarray(verts, np.float64))
    except ValueError:
        return None, None
    if len(faces) == 0:
        return None, None

    def dedup_dirs(d):
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-300)
        # canonical hemisphere (sign-insensitive consumers evaluate both)
        flip = (d[:, 0] < -1e-12) | (
            (np.abs(d[:, 0]) <= 1e-12) & (d[:, 1] < -1e-12)
        ) | (
            (np.abs(d[:, 0]) <= 1e-12) & (np.abs(d[:, 1]) <= 1e-12)
            & (d[:, 2] < 0)
        )
        d = np.where(flip[:, None], -d, d)
        return np.unique(np.round(d, 9), axis=0)

    a, b, c = hv[faces[:, 0]], hv[faces[:, 1]], hv[faces[:, 2]]
    fn = np.cross(b - a, c - a)
    ln = np.linalg.norm(fn, axis=1)
    fn = fn[ln > 1e-12]
    normals = dedup_dirs(fn)

    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]
    )
    ev = hv[edges[:, 1]] - hv[edges[:, 0]]
    le = np.linalg.norm(ev, axis=1)
    ev = ev[le > 1e-12]
    edge_dirs = dedup_dirs(ev)
    return normals, edge_dirs


def sphere_inertia(mass, r):
    return np.eye(3) * (2.0 / 5.0 * mass * r * r)


def box_inertia(mass, hx, hy, hz):
    lx, ly, lz = 2 * hx, 2 * hy, 2 * hz
    return np.diag(
        [
            mass / 12.0 * (ly * ly + lz * lz),
            mass / 12.0 * (lx * lx + lz * lz),
            mass / 12.0 * (lx * lx + ly * ly),
        ]
    )


def cylinder_inertia(mass, r, h):
    ix = mass * (3 * r * r + h * h) / 12.0
    return np.diag([ix, 0.5 * mass * r * r, ix])


@dataclass
class ABDef:
    """Articulated body under construction."""

    name: str
    model: amdl.ArticulatedModel
    q0: np.ndarray = None
    qd0: np.ndarray = None
    link_names: List[str] = None


class SceneBuilder:
    """Host-side scene assembly (XMLReader + Simulator setup equivalent)."""

    def __init__(self, dtype=None):
        self.dtype = dtype or cfg.default_dtype()
        self.bodies: list[BodyDef] = []
        self.geoms: list[GeomDef] = []
        self.arts: list[ABDef] = []
        self.contact_params: dict[tuple[str, str], ContactParams] = {}
        self.gravity = np.zeros(3)
        self.contact_dist_thresh = 1e-6
        self.min_step_size = cfg.NEAR_ZERO_F64
        self.stab_max_iters = 4
        self.legacy_velocity_first = False
        self.disabled_pairs: set[tuple[str, str]] = set()
        # custom plugin contact kernels: (body1, body2, kernel, nslots)
        self.custom_pairs: list = []
        # broad-phase pair pools: kind -> max runtime-selected pairs
        # (see set_pair_pool)
        self.pair_pools: dict[int, int] = {}
        # per-body drag coefficients (StokesDragForce / DampingForce)
        self.drag_lin: dict = {}
        self.drag_ang: dict = {}

    def add_gear_constraint(self, ab_name, link_a, link_b, ratio):
        """Gear ratio coupling between two 1-dof joints of an articulated
        body (`Moby::Gears`, include/Moby/Gears.h:40-45): the OUTBOARD link
        names identify the joints."""
        self._gears = getattr(self, "_gears", [])
        self._gears.append((ab_name, link_a, link_b, float(ratio)))

    def add_point_constraint(self, body1, anchor1, body2, anchor2):
        """Ball-joint loop constraint pinning two bodies' anchor points
        (simulator-level implicit joints, src/Simulator.cpp:604-805)."""
        self._points = getattr(self, "_points", [])
        self._points.append(
            (body1, np.asarray(anchor1, float), body2, np.asarray(anchor2, float))
        )

    def add_planar_constraint(self, outboard, inboard, normal):
        """Planar implicit joint: `outboard` translates in `inboard`'s plane
        and rotates about its normal (Moby::PlanarJoint as a simulator-level
        ImplicitConstraint, example/planar-joint/constrained.xml). `normal`
        is given in the inboard body's frame."""
        self._planars = getattr(self, "_planars", [])
        self._planars.append(
            (outboard, inboard, np.asarray(normal, float))
        )

    def add_custom_pair(self, body1, body2, kernel, nslots):
        """Register a plugin narrow-phase kernel between two bodies (the
        reference's CollisionDetectionPlugin mechanism). `kernel(scene,
        pos_table, quat_table, pair_idx_array)` must return the same tuple as
        the built-in kernels: (dist, pa, pb, points (P, nslots, 3), normals,
        signed-dists (P, nslots))."""
        self.custom_pairs.append((body1, body2, kernel, nslots))

    # ---------------- bodies / geoms ----------------
    def add_body(self, name, **kw) -> BodyDef:
        b = BodyDef(name=name, **kw)
        if b.inertia is None:
            b.inertia = np.eye(3)
        if b.pos is None:
            b.pos = np.zeros(3)
        if b.quat is None:
            b.quat = np.array([0.0, 0.0, 0.0, 1.0])
        if b.lin_vel is None:
            b.lin_vel = np.zeros(3)
        if b.ang_vel is None:
            b.ang_vel = np.zeros(3)
        self.bodies.append(b)
        return b

    def add_articulated(self, name, model: amdl.ArticulatedModel, q0=None, qd0=None,
                        link_names=None) -> ABDef:
        ab = ABDef(
            name=name,
            model=model,
            q0=np.asarray(q0) if q0 is not None else np.asarray(model.neutral_q()),
            qd0=np.asarray(qd0) if qd0 is not None else np.zeros(model.nv),
            link_names=link_names or [lk.name for lk in model.links],
        )
        self.arts.append(ab)
        return ab

    def add_geom(self, body, gtype, params, pos=None, quat=None, verts=None,
                 rmax=None, heights=None, faces=None):
        g = GeomDef(
            body=body,
            gtype=gtype,
            params=np.asarray(params, dtype=np.float64),
            pos=np.zeros(3) if pos is None else np.asarray(pos, np.float64),
            quat=np.array([0, 0, 0, 1.0]) if quat is None else np.asarray(quat, np.float64),
            verts=verts,
            rmax=rmax,
            heights=heights,
            faces=None if faces is None else np.asarray(faces, np.int32),
        )
        if g.gtype == TRIMESH:
            if g.verts is None or g.faces is None:
                raise ValueError("TRIMESH geometry needs verts and faces")
        if g.gtype == BOX and g.verts is None:
            g.verts = box_vertices(*g.params[:3])
        self.geoms.append(g)
        return g

    def set_contact_params(self, name1, name2, cp: ContactParams):
        self.contact_params[tuple(sorted((name1, name2)))] = cp

    def set_gravity(self, g):
        self.gravity = np.asarray(g, np.float64)

    # ---------------- compile ----------------
    def _lookup_cp(self, n1, n2) -> ContactParams:
        return self.contact_params.get(tuple(sorted((n1, n2))), ContactParams())

    def set_pair_pool(self, gtype_a, gtype_b, max_pairs: int):
        """Cap the contact slots of one geometry-kind class to `max_pairs`
        runtime-culled candidate pairs — the fixed-shape redesign of the
        reference's swept-sphere sweep-and-prune broad phase
        (/root/reference/src/CCD.cpp:702-990, sort_AABBs :903).

        Where the reference maintains sorted axis lists on the CPU, here the
        class's candidate pairs (still enumerated statically at compile) are
        pruned EVERY STEP to the `max_pairs` nearest by a bounding-sphere
        distance lower bound (one fused (P,)-vectorized pass + top_k), and
        only the selected pairs run narrow phase and own contact slots. The
        per-slot body incidence becomes data (Contacts.s1/s2/pair), so the
        LCP size scales with max_pairs instead of O(n_bodies^2).

        Constraints (checked at compile): bounded-geometry kinds only
        (sphere/sphere, box/sphere), uniform ContactParams across the class,
        no compliant members, finite mu (< 1e2: the QP model), linearized
        cones (nk > 0). Selected pairs are re-sorted ascending so slot
        assignment is stable while the neighbor set is stable (keeps
        `zlast` warm starts valid for resting piles).
        """
        kind, _ = self._pair_kind(gtype_a, gtype_b)
        if kind not in _POOLABLE_KINDS:
            raise ValueError(
                "set_pair_pool supports bounded convex pair kinds "
                "(sphere/sphere, box/sphere); got kind "
                f"{kind} for gtypes ({gtype_a}, {gtype_b})"
            )
        self.pair_pools[kind] = int(max_pairs)

    def _pair_kind(self, ta, tb):
        if ta == SPHERE and tb == SPHERE:
            return K_SPHERE_SPHERE, False
        if ta == SPHERE and tb == PLANE:
            return K_SPHERE_PLANE, False
        if ta == PLANE and tb == SPHERE:
            return K_SPHERE_PLANE, True
        if ta == SPHERE and tb == BOX:
            return K_BOX_SPHERE, True
        if ta == BOX and tb == SPHERE:
            return K_BOX_SPHERE, False
        if ta in (BOX, POLYHEDRON) and tb == PLANE:
            return K_PLANE_GENERIC, True
        if ta == PLANE and tb in (BOX, POLYHEDRON):
            return K_PLANE_GENERIC, False
        if ta == CYLINDER and tb == PLANE:
            return K_CYLINDER_PLANE, False
        if ta == PLANE and tb == CYLINDER:
            return K_CYLINDER_PLANE, True
        if ta == CONE and tb == PLANE:
            return K_CONE_PLANE, False
        if ta == PLANE and tb == CONE:
            return K_CONE_PLANE, True
        if ta == TORUS and tb == PLANE:
            return K_TORUS_PLANE, False
        if ta == PLANE and tb == TORUS:
            return K_TORUS_PLANE, True
        if ta == BOX and tb == BOX:
            return K_BOX_BOX, False
        if ta == SPHERE and tb == HEIGHTMAP:
            return K_SPHERE_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb == SPHERE:
            return K_SPHERE_HEIGHTMAP, True
        if ta in (BOX, POLYHEDRON) and tb == HEIGHTMAP:
            return K_VERTS_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb in (BOX, POLYHEDRON):
            return K_VERTS_HEIGHTMAP, True
        # curved convex vs heightmap: support sampling against the grid
        # (reference find_contacts_convex_heightmap, CCD.inl:33,70)
        if ta in CURVED_CONVEX_TYPES and tb == HEIGHTMAP:
            return K_SUPPORT_HM_BASE + ta, False
        if ta == HEIGHTMAP and tb in CURVED_CONVEX_TYPES:
            return K_SUPPORT_HM_BASE + tb, True
        if ta == POLYHEDRON and tb in (POLYHEDRON, BOX):
            return K_CONVEX_CONVEX, False
        if ta == BOX and tb == POLYHEDRON:
            return K_CONVEX_CONVEX, False
        # triangle meshes (TriangleMeshPrimitive; narrow-phase analogs of the
        # reference's generic calc_signed_dist dispatch, CCD.inl:649)
        if ta == TRIMESH and tb == PLANE:
            return K_PLANE_GENERIC, True
        if ta == PLANE and tb == TRIMESH:
            return K_PLANE_GENERIC, False
        if ta == TRIMESH and tb == HEIGHTMAP:
            return K_VERTS_HEIGHTMAP, False
        if ta == HEIGHTMAP and tb == TRIMESH:
            return K_VERTS_HEIGHTMAP, True
        if ta == SPHERE and tb == TRIMESH:
            return K_SPHERE_TRIMESH, False
        if ta == TRIMESH and tb == SPHERE:
            return K_SPHERE_TRIMESH, True
        if ta == TRIMESH and tb == BOX:
            return K_TRIMESH_CONVEX, False
        if ta == BOX and tb == TRIMESH:
            return K_TRIMESH_CONVEX, True
        if ta == TRIMESH and tb == TRIMESH:
            return K_TRIMESH_TRIMESH, False
        # convex clouds carry compile-time hull triangles, so they meet
        # meshes through the mesh-mesh kernel
        if ta == TRIMESH and tb == POLYHEDRON:
            return K_TRIMESH_TRIMESH, False
        if ta == POLYHEDRON and tb == TRIMESH:
            return K_TRIMESH_TRIMESH, True
        # curved convex vs triangle mesh: mesh verts vs primitive SDF +
        # support probes vs mesh (reference generic path, CCD.inl:81,649)
        if ta == TRIMESH and tb in CURVED_CONVEX_TYPES:
            return K_SUPPORT_TM_BASE + tb, False
        if ta in CURVED_CONVEX_TYPES and tb == TRIMESH:
            return K_SUPPORT_TM_BASE + ta, True
        # generic convex-convex fallback: any remaining pair of convex
        # primitives routes through the support-function GJK/MTV kernel
        # (sphere-vs-polyhedron, cylinder-vs-cylinder, cone-vs-box, ...)
        if ta in SUPPORT_CONVEX_TYPES and tb in SUPPORT_CONVEX_TYPES:
            if ta <= tb:
                return K_SUPPORT_BASE + ta * 16 + tb, False
            return K_SUPPORT_BASE + tb * 16 + ta, True
        # two fixed environment fields / plugin ghost anchors: nothing to do
        if ta == NONE or tb == NONE:
            return _SKIP, False
        if {ta, tb} <= {PLANE, HEIGHTMAP}:
            return _SKIP, False
        return None, False

    def compile(self):
        dt = self.dtype
        nb = len(self.bodies)
        name_to_body = {b.name: i for i, b in enumerate(self.bodies)}

        # pose-slot map: free body i -> slot i, link l of ab k -> nb + offset
        slot_names = {b.name: i for i, b in enumerate(self.bodies)}
        slot_owner = [("free", i, 0) for i in range(nb)]
        total_links = 0
        gc_off = 6 * nb
        q_off = v_off = 0
        art_entries = []
        for k, ab in enumerate(self.arts):
            for l, lname in enumerate(ab.link_names):
                slot_names[f"{ab.name}/{lname}"] = nb + total_links + l
                slot_owner.append(("link", k, l))
            art_entries.append(ABEntry(ab.name, ab.model, gc_off, q_off, v_off))
            total_links += ab.model.nl
            gc_off += ab.model.nv
            q_off += ab.model.nq
            v_off += ab.model.nv
        ns = nb + total_links
        ngc = gc_off
        nq_art, nv_art = q_off, v_off

        mass = np.array([b.mass for b in self.bodies], dt) if nb else np.zeros(0, dt)
        inertia = (
            np.stack([b.inertia for b in self.bodies]).astype(dt)
            if nb
            else np.zeros((0, 3, 3), dt)
        )
        enabled = np.array([b.enabled for b in self.bodies], bool)
        inv_mass = np.where(
            enabled & (mass > 0), 1.0 / np.where(mass > 0, mass, 1.0), 0.0
        ).astype(dt)
        inv_inertia = np.zeros_like(inertia)
        for i, b in enumerate(self.bodies):
            if enabled[i] and b.mass > 0:
                inv_inertia[i] = np.linalg.inv(b.inertia)

        slot_enabled = np.concatenate([enabled, np.ones(total_links, bool)])

        # materialize ghost geometries anchoring custom plugin pairs
        all_geoms = list(self.geoms)
        custom_rows = []
        for (b1n, b2n, kern, nsl) in self.custom_pairs:
            ga = len(all_geoms)
            all_geoms.append(
                GeomDef(body=b1n, gtype=NONE, params=np.zeros(1),
                        pos=np.zeros(3), quat=np.array([0, 0, 0, 1.0]),
                        rmax=0.0)
            )
            gb = len(all_geoms)
            all_geoms.append(
                GeomDef(body=b2n, gtype=NONE, params=np.zeros(1),
                        pos=np.zeros(3), quat=np.array([0, 0, 0, 1.0]),
                        rmax=0.0)
            )
            custom_rows.append((ga, gb, kern, nsl))

        ng = len(all_geoms)
        geom_slot = np.array(
            [slot_names[g.body] for g in all_geoms], np.int32
        ) if ng else np.zeros(0, np.int32)
        geom_pos = np.stack([g.pos for g in all_geoms]).astype(dt) if ng else np.zeros((0, 3), dt)
        geom_quat = np.stack([g.quat for g in all_geoms]).astype(dt) if ng else np.zeros((0, 4), dt)
        geom_params = np.zeros((ng, 4), dt)
        for i, g in enumerate(all_geoms):
            geom_params[i, : len(g.params)] = g.params

        vmax = max([1] + [len(g.verts) for g in all_geoms if g.verts is not None])
        geom_verts = np.zeros((ng, vmax, 3), dt)
        geom_nverts = np.zeros(ng, np.int32)
        for g in all_geoms:
            if g.gtype == POLYHEDRON and g.faces is None and g.verts is not None:
                # derive hull triangles for the convex cloud so trimesh-vs-
                # polyhedron pairs can route through the mesh kernels
                # (indices mapped back into the original cloud ordering);
                # only a genuinely degenerate cloud may skip (ValueError) —
                # anything else must fail loudly, not lose contacts
                try:
                    from .. import native

                    hv, hf = native.convex_hull(
                        np.asarray(g.verts, np.float64))
                    if len(hf):
                        lookup = {
                            tuple(np.round(v, 12)): k
                            for k, v in enumerate(
                                np.asarray(g.verts, np.float64))
                        }
                        remap = np.array(
                            [lookup[tuple(np.round(v, 12))] for v in hv],
                            np.int32)
                        g.faces = remap[hf]
                except ValueError:
                    pass
        fmax = max([1] + [len(g.faces) for g in all_geoms if g.faces is not None])
        geom_faces = np.zeros((ng, fmax, 3), np.int32)
        geom_nfaces = np.zeros(ng, np.int32)
        # hull candidate directions (exact convex-convex penetration): only
        # for vertex-cloud geoms that meet another convex in a
        # K_CONVEX_CONVEX pair; TRIMESH/heightmap geoms skip
        hull_dirs = {}
        for i, g in enumerate(all_geoms):
            if g.verts is not None and g.gtype in (BOX, POLYHEDRON):
                nrm_, ed_ = _hull_candidate_dirs(g.verts)
                if nrm_ is not None:
                    hull_dirs[i] = (nrm_, ed_)
        fn_max = max([1] + [len(v[0]) for v in hull_dirs.values()])
        ed_max = max([1] + [len(v[1]) for v in hull_dirs.values()])
        geom_hull_normals = np.zeros((ng, fn_max, 3), dt)
        geom_nhn = np.zeros(ng, np.int32)
        geom_hull_edges = np.zeros((ng, ed_max, 3), dt)
        geom_nhe = np.zeros(ng, np.int32)
        for i, (nrm_, ed_) in hull_dirs.items():
            geom_hull_normals[i, : len(nrm_)] = nrm_
            geom_nhn[i] = len(nrm_)
            geom_hull_edges[i, : len(ed_)] = ed_
            geom_nhe[i] = len(ed_)
        for i, g in enumerate(all_geoms):
            if g.verts is not None:
                geom_verts[i, : len(g.verts)] = g.verts
                geom_nverts[i] = len(g.verts)
            if g.faces is not None:
                geom_faces[i, : len(g.faces)] = g.faces
                geom_nfaces[i] = len(g.faces)

        # heightmap grid storage: geom_params[0] becomes the grid slot index
        hm_list = [g for g in all_geoms if g.gtype == HEIGHTMAP]
        if hm_list:
            Rm_ = max(g.heights.shape[0] for g in hm_list)
            Cm_ = max(g.heights.shape[1] for g in hm_list)
            hm_heights = np.zeros((len(hm_list), Rm_, Cm_), dt)
            hm_size = np.zeros((len(hm_list), 2), dt)
            hmi = 0
            for i, g in enumerate(all_geoms):
                if g.gtype == HEIGHTMAP:
                    hgrid = np.asarray(g.heights, dt)
                    hm_heights[hmi, : hgrid.shape[0], : hgrid.shape[1]] = hgrid
                    hm_size[hmi] = g.params[:2]
                    geom_params[i, 0] = hmi
                    geom_params[i, 2] = hgrid.shape[0]
                    geom_params[i, 3] = hgrid.shape[1]
                    hmi += 1
        else:
            hm_heights = np.zeros((1, 2, 2), dt)
            hm_size = np.ones((1, 2), dt)

        # rmax per pose slot (reference CCD.cpp:739)
        slot_rmax = np.zeros(ns, dt)
        # shape-only bounding radius per geometry (around the geom origin) —
        # the broad-phase pair-pool cull bound: dist(g1, g2) >=
        # |c1 - c2| - geom_rmax1 - geom_rmax2 with c the geom world centers
        geom_rmax_np = np.zeros(ng, dt)
        for i, g in enumerate(all_geoms):
            t = g.gtype
            if t == SPHERE:
                geom_rmax_np[i] = g.params[0]
            elif t == BOX:
                geom_rmax_np[i] = float(np.linalg.norm(g.params[:3]))
            elif t in (CYLINDER, CONE):
                geom_rmax_np[i] = float(
                    math.hypot(g.params[0], g.params[1] / 2))
            elif t == TORUS:
                geom_rmax_np[i] = float(g.params[0] + g.params[1])
            elif t in (POLYHEDRON, TRIMESH) and g.verts is not None:
                geom_rmax_np[i] = float(
                    np.max(np.linalg.norm(g.verts, axis=1)))
            else:
                geom_rmax_np[i] = np.inf  # unbounded (plane/heightmap)
        for i, g in enumerate(all_geoms):
            s = geom_slot[i]
            off = np.linalg.norm(g.pos)
            t = g.gtype
            if g.rmax is not None:
                # explicit override (plugin geometries without a primitive
                # have rmax 0 in the reference — CCD.cpp:739 never fills it)
                slot_rmax[s] = max(slot_rmax[s], g.rmax)
                continue
            if t == SPHERE:
                r = off + g.params[0]
            elif t == BOX:
                r = off + float(np.linalg.norm(g.params[:3]))
            elif t in (CYLINDER, CONE):
                r = off + float(math.hypot(g.params[0], g.params[1] / 2))
            elif t == TORUS:
                r = off + float(g.params[0] + g.params[1])
            elif t in (POLYHEDRON, TRIMESH) and g.verts is not None:
                r = off + float(np.max(np.linalg.norm(g.verts, axis=1)))
            else:
                r = off
            slot_rmax[s] = max(slot_rmax[s], r)

        # candidate pairs: geometry pairs across distinct pose slots where at
        # least one side is dynamic (enabled) — CollisionDetection.cpp:48-54
        def slot_body_key(s):
            kind, k, l = slot_owner[s]
            return ("b", k) if kind == "free" else ("a", k, l)

        def slot_cp_names(s):
            """ContactParameters names for this slot, most specific first:
            link-level ("ab/link") then articulated-body level — the
            reference's fallback hierarchy geom->body->abody
            (ConstraintSimulator.cpp:82-155)."""
            kind, k, l = slot_owner[s]
            if kind == "free":
                return [self.bodies[k].name]
            ab = self.arts[k]
            return [f"{ab.name}/{ab.link_names[l]}", ab.name]

        def slot_names_all(s):
            """Names this slot answers to for DisabledPair matching: the
            body/link name and (for links) the articulated-body name."""
            kind, k, l = slot_owner[s]
            if kind == "free":
                return [self.bodies[k].name]
            return [self.arts[k].link_names[l], self.arts[k].name]

        def pair_disabled(si, sj):
            for a in slot_names_all(si):
                for b in slot_names_all(sj):
                    if tuple(sorted((a, b))) in self.disabled_pairs:
                        return True
            return False

        pair_rows = []
        for i in range(ng):
            for j in range(i + 1, ng):
                si, sj = geom_slot[i], geom_slot[j]
                if slot_body_key(si) == slot_body_key(sj):
                    continue
                # skip pairs within the same articulated body? The reference
                # does check them (self-collision) — keep cross-link pairs
                # unless geometry-less.
                if not (slot_enabled[si] or slot_enabled[sj]):
                    continue
                if pair_disabled(si, sj):
                    continue
                ta, tb = all_geoms[i].gtype, all_geoms[j].gtype
                kind, flip = self._pair_kind(ta, tb)
                if kind is _SKIP:
                    continue
                if kind is None:
                    # loud failure instead of silent contact loss (the
                    # reference would at least attempt its generic
                    # calc_signed_dist path on any pair, CCD.inl:649)
                    tn = {
                        SPHERE: "SPHERE", PLANE: "PLANE", BOX: "BOX",
                        CYLINDER: "CYLINDER", CONE: "CONE", TORUS: "TORUS",
                        HEIGHTMAP: "HEIGHTMAP", POLYHEDRON: "POLYHEDRON",
                        NONE: "NONE", TRIMESH: "TRIMESH",
                    }
                    raise ValueError(
                        f"no narrow-phase kernel for geometry pair "
                        f"{tn.get(ta, ta)} vs {tn.get(tb, tb)} "
                        f"(bodies '{all_geoms[i].body}' / "
                        f"'{all_geoms[j].body}'). Decompose the shape, "
                        f"register a plugin kernel via add_custom_pair, or "
                        f"opt the pair out with "
                        f"builder.disabled_pairs.add((name1, name2)) "
                        f"(sorted tuple). Note: before round 3 such pairs "
                        f"were silently ignored; this raise is deliberate."
                    )
                ga, gb = (j, i) if flip else (i, j)
                pair_rows.append((ga, gb, kind))

        # custom plugin pairs (negative-coded kinds)
        custom_kernels = {}
        for ci, (ga, gb, kern, nsl) in enumerate(custom_rows):
            kind = -(ci + 1)
            custom_kernels[kind] = (kern, nsl)
            pair_rows.append((ga, gb, kind))

        n_pairs = len(pair_rows)
        pair_g1 = np.array([p[0] for p in pair_rows], np.int32)
        pair_g2 = np.array([p[1] for p in pair_rows], np.int32)
        pair_kind = np.array([p[2] for p in pair_rows], np.int32)

        # contact slots
        s_pair, s_s1, s_s2 = [], [], []
        s_eps, s_mu_c, s_mu_v, s_comp, s_nk = [], [], [], [], []
        s_compliant, s_kp, s_kv, s_truecone = [], [], [], []

        def _body_compliant(slot):
            kind, k, l = slot_owner[slot]
            return self.bodies[k].compliant if kind == "free" else False
        # kinds whose kernels take an nslots argument and top-k to it (the
        # only ones a per-pair max_slots cap may shrink)
        _CAPPABLE = {K_PLANE_GENERIC, K_BOX_BOX, K_VERTS_HEIGHTMAP,
                     K_TRIMESH_CONVEX}
        # pass 1: per-pair slot count + resolved contact params
        def _cp_for(s1, s2):
            for n1 in slot_cp_names(s1):
                for n2 in slot_cp_names(s2):
                    key = tuple(sorted((n1, n2)))
                    if key in self.contact_params:
                        return self.contact_params[key]
            return ContactParams()

        pair_cp = []
        pair_nsl = []
        for p, (ga, gb, kind) in enumerate(pair_rows):
            nsl = (
                custom_kernels[kind][1] if kind < 0 else _kind_nslots(kind, vmax)
            )
            cp = _cp_for(int(geom_slot[ga]), int(geom_slot[gb]))
            if cp.max_slots > 0 and kind in _CAPPABLE:
                nsl = min(nsl, cp.max_slots)
            pair_cp.append(cp)
            pair_nsl.append(nsl)

        # pooled classes (set_pair_pool): a (kind, nslots) group whose
        # candidate count exceeds the pool cap shares cap*nslots runtime-
        # assigned slots instead of per-pair static slots — the fixed-shape redesign
        # of the reference's sweep-and-prune broad phase (CCD.cpp:702-990)
        group_of: dict = {}
        for p, (ga, gb, kind) in enumerate(pair_rows):
            group_of.setdefault((int(kind), int(pair_nsl[p])), []).append(p)
        pooled_caps: dict = {}
        for gkey, plist in group_of.items():
            cap = self.pair_pools.get(gkey[0])
            if cap is None or len(plist) <= cap:
                continue
            c0 = pair_cp[plist[0]]
            for p in plist[1:]:
                if pair_cp[p] != c0:
                    raise ValueError(
                        "set_pair_pool requires uniform ContactParams "
                        f"across the pooled class (kind {gkey[0]}): pair "
                        f"{p} differs from pair {plist[0]}"
                    )
            if c0.mu_coulomb >= 1e2:
                raise ValueError(
                    "pooled pair classes route through the QP model; "
                    "mu_coulomb >= 100 (no-slip MLCP) is unsupported"
                )
            if c0.nk <= 0:
                raise ValueError(
                    "pooled pair classes route through the QP model; "
                    "nk <= 0 (true-cone NQP) is unsupported"
                )
            for p in plist:
                ga, gb, _ = pair_rows[p]
                if (_body_compliant(int(geom_slot[ga]))
                        or _body_compliant(int(geom_slot[gb]))):
                    raise ValueError(
                        "pooled pair classes do not support compliant "
                        "bodies (penalty contacts need static slot->pair "
                        "ownership)"
                    )
            pooled_caps[gkey] = cap

        # pass 2: slot allocation. Unpooled pairs get per-pair slots in pair
        # order (bit-identical layout to the pre-pooling compiler for every
        # existing scene); each pooled group appends ONE shared block of
        # cap*nslots slots whose pair/body identity is assigned at runtime
        # by the narrow-phase cull (Contacts.s1/s2/pair).
        pair_slot0 = np.zeros(n_pairs, np.int32)
        pair_nslots = np.zeros(n_pairs, np.int32)
        for p, (ga, gb, kind) in enumerate(pair_rows):
            if (int(kind), int(pair_nsl[p])) in pooled_caps:
                continue
            nsl = pair_nsl[p]
            cp = pair_cp[p]
            pair_slot0[p] = len(s_pair)
            s1 = int(geom_slot[ga])
            s2 = int(geom_slot[gb])
            pair_nslots[p] = nsl
            for _ in range(nsl):
                s_pair.append(p)
                s_s1.append(s1)
                s_s2.append(s2)
                s_eps.append(cp.epsilon)
                s_mu_c.append(cp.mu_coulomb)
                s_mu_v.append(cp.mu_viscous)
                s_comp.append(cp.compliance)
                # nk <= 0 = true cone (NQP); friction rows are then unused
                s_nk.append(max(4, cp.nk) if cp.nk > 0 else 4)
                s_truecone.append(cp.nk <= 0)
                s_compliant.append(_body_compliant(s1) or _body_compliant(s2))
                s_kp.append(cp.penalty_kp)
                s_kv.append(cp.penalty_kv)
        pool_slot0: dict = {}
        for gkey in sorted(pooled_caps):
            plist = group_of[gkey]
            cap = pooled_caps[gkey]
            nsl = gkey[1]
            cp = pair_cp[plist[0]]
            pool_slot0[gkey] = len(s_pair)
            ga0, gb0, _ = pair_rows[plist[0]]
            for _ in range(cap * nsl):
                # static placeholders; narrow phase overrides identity
                s_pair.append(plist[0])
                s_s1.append(int(geom_slot[ga0]))
                s_s2.append(int(geom_slot[gb0]))
                s_eps.append(cp.epsilon)
                s_mu_c.append(cp.mu_coulomb)
                s_mu_v.append(cp.mu_viscous)
                s_comp.append(cp.compliance)
                s_nk.append(max(4, cp.nk) if cp.nk > 0 else 4)
                s_truecone.append(False)
                s_compliant.append(False)
                s_kp.append(cp.penalty_kp)
                s_kv.append(cp.penalty_kv)
        K = len(s_pair)
        if pooled_caps:
            # pooled scenes solve one constraint group (no static island
            # incidence): per-island model routing and the no-slip / NQP
            # routes are compile-time rejected above for the pooled class;
            # the UNpooled slots must agree on the QP model too
            if any(m >= 1e2 for m, c in zip(s_mu_c, s_compliant) if not c):
                raise ValueError(
                    "scenes with pooled pair classes cannot mix in "
                    "mu >= 100 (no-slip) contacts")
            if any(t for t, c in zip(s_truecone, s_compliant) if not c):
                raise ValueError(
                    "scenes with pooled pair classes cannot mix in "
                    "true-cone (nk <= 0) contacts")

        # friction rows: θ_j = j/(NK/2-1)·π/2 (setup_QP:461-479)
        fr_con, fr_cos, fr_sin = [], [], []
        for i in range(K):
            half = s_nk[i] // 2
            for j in range(half):
                theta = (j / (half - 1)) * (math.pi / 2) if half > 1 else 0.0
                fr_con.append(i)
                fr_cos.append(math.cos(theta))
                fr_sin.append(math.sin(theta))
        NF = len(fr_con)

        # joint-limit slots: 2 per dof with a finite limit
        lim_gc_col, lim_q_idx, lim_upper, lim_value, lim_eps = [], [], [], [], []
        for k, ab in enumerate(self.arts):
            ent = art_entries[k]
            m = ab.model
            for li, lk in enumerate(m.links):
                jd = lk.joint
                ndof = amdl.NV[m.jtype[li]]
                if jd.hi is None and jd.lo is None:
                    continue
                for d in range(ndof):
                    hi = jd.hi[d] if jd.hi is not None else np.inf
                    lo = jd.lo[d] if jd.lo is not None else -np.inf
                    col = ent.gc_off + m.v_off[li] + d
                    qix = ent.q_off + m.q_off[li] + d
                    if np.isfinite(hi):
                        lim_gc_col.append(col)
                        lim_q_idx.append(qix)
                        lim_upper.append(True)
                        lim_value.append(hi)
                        lim_eps.append(getattr(jd, "restitution", 0.0) or 0.0)
                    if np.isfinite(lo):
                        lim_gc_col.append(col)
                        lim_q_idx.append(qix)
                        lim_upper.append(False)
                        lim_value.append(lo)
                        lim_eps.append(getattr(jd, "restitution", 0.0) or 0.0)
        NL = len(lim_gc_col)

        # bilateral implicit constraints
        from ..sim.bilateral import Bilateral, GEAR, POINT

        bilaterals = []
        for (abn, la, lb, ratio) in getattr(self, "_gears", []):
            k = [i for i, ab in enumerate(self.arts) if ab.name == abn][0]
            ab = self.arts[k]
            ent = art_entries[k]
            m = ab.model
            ia = ab.link_names.index(la)
            ib = ab.link_names.index(lb)
            bilaterals.append(
                Bilateral(
                    btype=GEAR,
                    col_a=ent.gc_off + m.v_off[ia],
                    col_b=ent.gc_off + m.v_off[ib],
                    ratio=ratio,
                    q_idx_a=ent.q_off + m.q_off[ia],
                    q_idx_b=ent.q_off + m.q_off[ib],
                    q0_a=float(ab.q0[m.q_off[ia]]),
                    q0_b=float(ab.q0[m.q_off[ib]]),
                )
            )
        for (b1n, a1, b2n, a2) in getattr(self, "_points", []):
            bilaterals.append(
                Bilateral(
                    btype=POINT,
                    slot_a=slot_names[b1n],
                    slot_b=slot_names[b2n],
                    anchor_a=tuple(a1),
                    anchor_b=tuple(a2),
                )
            )
        from ..sim.bilateral import PLANAR as _PLANAR

        for (out_n, in_n, nrm) in getattr(self, "_planars", []):
            sa = slot_names[out_n]
            sb = slot_names[in_n]

            def _body_pose(name):
                kb = name_to_body.get(name)
                if kb is None:
                    raise ValueError(
                        f"planar constraint on unknown body {name}")
                return self.bodies[kb].pos, self.bodies[kb].quat

            pa0, qa0 = _body_pose(out_n)
            pb0, qb0 = _body_pose(in_n)

            def _qmul(q1, q2):
                x1, y1, z1, w1 = q1
                x2, y2, z2, w2 = q2
                return np.array([
                    w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                    w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                    w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                ])

            def _qrot(q, v):
                qv = np.array([v[0], v[1], v[2], 0.0])
                qc = np.array([-q[0], -q[1], -q[2], q[3]])
                return _qmul(_qmul(q, qv), qc)[:3]

            n_w0 = _qrot(qb0, nrm / max(np.linalg.norm(nrm), 1e-300))
            offset0 = float(n_w0 @ (np.asarray(pa0) - np.asarray(pb0)))
            qrel0 = _qmul(
                np.asarray(qa0, float),
                np.array([-qb0[0], -qb0[1], -qb0[2], qb0[3]], float),
            )
            bilaterals.append(
                Bilateral(
                    btype=_PLANAR,
                    slot_a=sa,
                    slot_b=sb,
                    normal=tuple(nrm / max(np.linalg.norm(nrm), 1e-300)),
                    offset0=offset0,
                    qrel0=tuple(qrel0),
                )
            )

        # groups keyed by (kind, nslots): pairs of one kind may carry
        # different per-pair manifold caps (ContactParams.max_slots) and
        # each cap compiles its own vectorized kernel call. Pooled groups
        # (set_pair_pool) carry their full candidate-pair list + the shared
        # runtime-assigned slot block.
        kind_groups = {}
        for gkey, v in group_of.items():
            if gkey in pooled_caps:
                cap = pooled_caps[gkey]
                kind_groups[gkey] = {
                    "kind": gkey[0],
                    "pairs": np.array(v, np.int32),
                    "slots": pool_slot0[gkey] + np.arange(
                        cap * gkey[1], dtype=np.int32),
                    "nslots": gkey[1],
                    "pooled": True,
                    "cap": cap,
                }
            else:
                kind_groups[gkey] = {
                    "kind": gkey[0],
                    "pairs": np.array(v, np.int32),
                    "slots": np.concatenate(
                        [
                            pair_slot0[p]
                            + np.arange(pair_nslots[p], dtype=np.int32)
                            for p in v
                        ]
                    ),
                    "nslots": gkey[1],
                    **({"kernel": custom_kernels[gkey[0]][0]} if gkey[0] < 0
                       else {}),
                }

        scene = Scene(
            mass=jnp.array(mass),
            inv_mass=jnp.array(inv_mass),
            inertia=jnp.array(inertia),
            inv_inertia=jnp.array(inv_inertia),
            enabled=jnp.array(enabled),
            slot_enabled=jnp.array(slot_enabled),
            slot_rmax=jnp.array(slot_rmax),
            geom_slot=jnp.array(geom_slot),
            geom_pos=jnp.array(geom_pos),
            geom_quat=jnp.array(geom_quat),
            geom_params=jnp.array(geom_params),
            geom_rmax=jnp.array(geom_rmax_np),
            has_dyn_slots=bool(pooled_caps),
            pair_g1=jnp.array(pair_g1),
            pair_g2=jnp.array(pair_g2),
            pair_kind=jnp.array(pair_kind),
            pair_slot0=jnp.array(pair_slot0),
            pair_nslots=jnp.array(pair_nslots),
            slot_pair=jnp.array(np.array(s_pair, np.int32)),
            slot_s1=jnp.array(np.array(s_s1, np.int32)),
            slot_s2=jnp.array(np.array(s_s2, np.int32)),
            slot_eps=jnp.array(np.array(s_eps, dt)),
            slot_mu_c=jnp.array(np.array(s_mu_c, dt)),
            slot_mu_v=jnp.array(np.array(s_mu_v, dt)),
            slot_compliance=jnp.array(np.array(s_comp, dt)),
            slot_compliant=jnp.array(np.array(s_compliant, bool) if K else np.zeros(0, bool)),
            slot_truecone=jnp.array(np.array(s_truecone, bool) if K else np.zeros(0, bool)),
            slot_kp=jnp.array(np.array(s_kp, dt)),
            slot_kv=jnp.array(np.array(s_kv, dt)),
            lim_gc_col=jnp.array(np.array(lim_gc_col, np.int32)),
            lim_q_idx=jnp.array(np.array(lim_q_idx, np.int32)),
            lim_upper=jnp.array(np.array(lim_upper, bool)),
            lim_value=jnp.array(np.array(lim_value, dt)),
            lim_eps=jnp.array(np.array(lim_eps, dt)),
            fr_con=jnp.array(np.array(fr_con, np.int32)),
            fr_cos=jnp.array(np.array(fr_cos, dt)),
            fr_sin=jnp.array(np.array(fr_sin, dt)),
            geom_verts=jnp.array(geom_verts),
            geom_nverts=jnp.array(geom_nverts),
            geom_faces=jnp.array(geom_faces),
            geom_nfaces=jnp.array(geom_nfaces),
            geom_hull_normals=jnp.array(geom_hull_normals),
            geom_nhn=jnp.array(geom_nhn),
            geom_hull_edges=jnp.array(geom_hull_edges),
            geom_nhe=jnp.array(geom_nhe),
            hm_heights=jnp.array(hm_heights),
            hm_size=jnp.array(hm_size),
            gravity=jnp.array(self.gravity.astype(dt)),
            contact_dist_thresh=jnp.array(self.contact_dist_thresh, dt),
            min_step_size=jnp.array(self.min_step_size, dt),
            dissipation_lambda=jnp.array(
                np.array([b.dissipation for b in self.bodies], dt)
            ),
            drag_lin=jnp.array(
                np.array([self.drag_lin.get(b.name, 0.0) for b in self.bodies], dt)
            ),
            drag_ang=jnp.array(
                np.array([self.drag_ang.get(b.name, 0.0) for b in self.bodies], dt)
            ),
            nb=nb,
            ng=ng,
            n_pose_slots=ns,
            ngc=ngc,
            nq_art=nq_art,
            nv_art=nv_art,
            n_pairs=n_pairs,
            n_contacts=K,
            n_friction_rows=NF,
            n_limits=NL,
            vmax=vmax,
            use_noslip=bool(
                K > 0
                and all(
                    m >= 1e2 for m, c in zip(s_mu_c, s_compliant) if not c
                )
                and not all(s_compliant)
            ),
            use_nqp=bool(
                K > 0
                and any(
                    t for t, c in zip(s_truecone, s_compliant) if not c
                )
            ),
            # slots disagree on the model -> islands can route differently
            # (rigid slots only; compliant slots never reach the impact solve)
            mixed_models=bool(
                K > 0
                and (
                    (
                        any(m >= 1e2 for m, c in zip(s_mu_c, s_compliant) if not c)
                        and any(m < 1e2 for m, c in zip(s_mu_c, s_compliant) if not c)
                    )
                    or (
                        any(t for t, c in zip(s_truecone, s_compliant) if not c)
                        and any(
                            (not t) and m < 1e2
                            for t, m, c in zip(s_truecone, s_mu_c, s_compliant)
                            if not c
                        )
                    )
                )
            ),
            has_compliant=bool(any(s_compliant)),
            stab_max_iters=int(self.stab_max_iters),
            legacy_velocity_first=bool(self.legacy_velocity_first),
            arts=tuple(art_entries),
            bilaterals=tuple(bilaterals),
            kind_groups=kind_groups,
            body_names=tuple(b.name for b in self.bodies),
        )

        q_art = (
            np.concatenate([ab.q0 for ab in self.arts]).astype(dt)
            if self.arts
            else np.zeros(0, dt)
        )
        qd_art = (
            np.concatenate([ab.qd0 for ab in self.arts]).astype(dt)
            if self.arts
            else np.zeros(0, dt)
        )

        state = State(
            pos=jnp.array(
                np.stack([b.pos for b in self.bodies]).astype(dt)
                if nb
                else np.zeros((0, 3), dt)
            ),
            quat=jnp.array(
                np.stack([b.quat for b in self.bodies]).astype(dt)
                if nb
                else np.zeros((0, 4), dt)
            ),
            vel=jnp.array(
                np.stack([b.lin_vel for b in self.bodies]).astype(dt)
                if nb
                else np.zeros((0, 3), dt)
            ),
            omega=jnp.array(
                np.stack([b.ang_vel for b in self.bodies]).astype(dt)
                if nb
                else np.zeros((0, 3), dt)
            ),
            q_art=jnp.array(q_art),
            qd_art=jnp.array(qd_art),
            time=jnp.array(0.0, dt),
            zlast=jnp.zeros(scene.n_lcp, dt),
            zlast_active=jnp.zeros(K, bool),
            min_dist_obs=jnp.zeros(n_pairs, dt),
            solver_pivots=jnp.zeros((), jnp.int32),
            solver_fallbacks=jnp.zeros((), jnp.int32),
        )
        return scene, state
