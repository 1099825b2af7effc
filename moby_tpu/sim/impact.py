"""Impact/impulse resolution: the Drumwright–Shell QP-as-LCP model.

Mirrors the reference's live solver path
(`ImpactConstraintHandler::apply_model`, src/ImpactConstraintHandler.cpp:96):

1. connected constraint groups over enabled bodies (islands), dropping groups
   with no impacting (`eNegative`) constraint
   (`UnilateralConstraint::determine_connected_constraints` +
   `remove_inactive_groups`, src/UnilateralConstraint.cpp:940-1220);
2. contact/limit Jacobians over the global generalized coordinates and all
   Delassus cross blocks (`compute_problem_data`,
   src/ImpactConstraintHandler.cpp:1898+): free bodies are 6-dof blocks,
   articulated bodies couple through their joint-space mass matrix H(q)
   (X = inv(M), compute_X :1590);
3. the QP stacked as a monolithic KKT LCP `[[H, -M'], [M, 0]]`
   (`setup_QP` + `solve_qp_work`, src/ImpactConstraintHandlerQP.cpp:94-499)
   solved by `lcp_fast_regularized(-20,4,-8)` with Lemke fallback, warm-started
   from the previous step's solution (`_zlast`);
4. Poisson restitution with the conditional second impact solve
   (`apply_restitution` + re-solve, src/ImpactConstraintHandler.cpp:577-602).

Fixed-shape design: one *joint* LCP over all islands instead of per-island solves.
For the convex QP model the two are trajectory-equivalent: the joint system is
block-diagonal across islands and the per-body wrench of any LCP solution is
unique, so velocity updates match. Inactive islands are masked out exactly as
`remove_inactive_groups` drops them.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..core import scene as sc
from ..dynamics import aba as art_dyn
from ..geometry.narrowphase import Contacts
from ..math import quaternion as quat
from ..solvers import lcp
from .kinematics import PoseTable, gc_velocity, apply_gc_velocity_delta


class ImpactResult(NamedTuple):
    dv: jnp.ndarray          # (ngc,) total velocity change
    zlast: jnp.ndarray
    zlast_active: jnp.ndarray
    impulses_n: jnp.ndarray  # (K,)
    pivots: jnp.ndarray = None     # () int32: LCP pivot count of this solve
    fallbacks: jnp.ndarray = None  # () int32: solver-cascade fallback count
    # the LCP solution actually applied THIS step (zero when the solve was
    # gated out) — unlike zlast, which passes the warm-start seed through
    # on no-impact steps. The MPC record/replay path replays exactly this.
    z_step: jnp.ndarray = None


def contact_velocities(scene: sc.Scene, pt: PoseTable, con: Contacts):
    """Per-slot relative velocity of body1's material point minus body2's,
    projected on (n, t1, t2) (UnilateralConstraint::calc_constraint_vel)."""
    s1, s2 = con.s1, con.s2
    r1 = con.point - pt.pos[s1]
    r2 = con.point - pt.pos[s2]
    vp1 = pt.vel[s1] + jnp.cross(pt.omega[s1], r1)
    vp2 = pt.vel[s2] + jnp.cross(pt.omega[s2], r2)
    rv = vp1 - vp2
    return (
        jnp.sum(rv * con.normal, axis=-1),
        jnp.sum(rv * con.tan1, axis=-1),
        jnp.sum(rv * con.tan2, axis=-1),
    )


def island_labels(scene: sc.Scene, active):
    """Connected components over *enabled* pose slots through active contacts;
    links of one articulated body are always mutually connected
    (src/UnilateralConstraint.cpp:958-1065). Disabled bodies are not nodes."""
    import numpy as _np

    ns = scene.n_pose_slots
    labels0 = jnp.arange(ns, dtype=jnp.int32)
    s1, s2 = scene.slot_s1, scene.slot_s2
    both = scene.slot_enabled[s1] & scene.slot_enabled[s2] & active
    big = jnp.int32(ns)

    # static slot-incidence matrix of the contact slots: inc[k, s] == slot k
    # touches pose slot s. Propagation becomes one masked (K, ns) reduce-min
    # per sweep — all fusible elementwise + reduce, no scatters (the
    # dynamic-index .at[].min lowered to real scatter kernels that showed in
    # the MPC device profile).
    K = int(scene.n_contacts)
    s1_np = _np.asarray(s1)
    s2_np = _np.asarray(s2)
    inc = _np.zeros((K, ns), bool)
    inc[_np.arange(K), s1_np] = True
    inc[_np.arange(K), s2_np] = True
    inc_j = jnp.asarray(inc)

    # static AB cliques + bilateral-joint edges
    ab_ranges = []
    off = scene.nb
    for ent in scene.arts:
        ab_ranges.append((off, off + ent.model.nl))
        off += ent.model.nl
    bi_edges = [
        (b.slot_a, b.slot_b)
        for b in scene.bilaterals
        if getattr(b, "btype", -1) == 1  # POINT joints couple two slots
    ]

    def body(_, labels):
        m = jnp.minimum(labels[s1], labels[s2])
        upd = jnp.where(both, m, big)
        prop = jnp.min(
            jnp.where(inc_j, upd[:, None], big), axis=0,
            initial=_np.int32(ns),
        ).astype(jnp.int32)
        labels = jnp.minimum(labels, prop)
        for a, b in ab_ranges:
            mn = jnp.min(labels[a:b])
            labels = labels.at[a:b].set(mn)
        for sa, sb in bi_edges:
            mn = jnp.minimum(labels[sa], labels[sb])
            labels = labels.at[sa].set(mn)
            labels = labels.at[sb].set(mn)
        return labels

    return jax.lax.fori_loop(0, ns, body, labels0)


def limit_activity_state(scene: sc.Scene, st, near_zero):
    """Active limit slots (q beyond the limit:
    ArticulatedBody::find_limit_constraints) and their constraint velocity
    (±qd: compute_limit_components / calc_constraint_vel)."""
    if scene.n_limits == 0:
        z = jnp.zeros(0, bool)
        return z, jnp.zeros(0, st.pos.dtype)
    q = st.q_art[scene.lim_q_idx]
    qd = st.qd_art[scene.lim_gc_col - 6 * scene.nb]
    act = jnp.where(scene.lim_upper, q >= scene.lim_value, q <= scene.lim_value)
    vel = jnp.where(scene.lim_upper, -qd, qd)
    return act, vel


class Problem(NamedTuple):
    Jn: jnp.ndarray   # (K, ngc)
    Js: jnp.ndarray
    Jt: jnp.ndarray
    Jl: jnp.ndarray   # (NL, ngc) signed limit rows
    Minv: jnp.ndarray  # (ngc, ngc)
    Ann: jnp.ndarray
    Ans: jnp.ndarray
    Ant: jnp.ndarray
    Anl: jnp.ndarray
    Ass: jnp.ndarray
    Ast: jnp.ndarray
    Asl: jnp.ndarray
    Att: jnp.ndarray
    Atl: jnp.ndarray
    All: jnp.ndarray
    Cn_v: jnp.ndarray
    Cs_v: jnp.ndarray
    Ct_v: jnp.ndarray
    L_v: jnp.ndarray
    # stacked forms (the hot-path representation; the named blocks above are
    # views into these for the nqp/noslip/stabilization consumers)
    Jall: jnp.ndarray = None  # (3K+NL, ngc) rows [Jn; Js; Jt; Jl]
    A: jnp.ndarray = None     # (3K+NL, 3K+NL) Jall Minv Jall^T
    bv: jnp.ndarray = None    # (3K+NL,) Jall v
    # free-body block-diagonal inverse inertia (n_live, 6, 6), set for scenes
    # with no articulated bodies/bilaterals: inv(M) products run as per-body
    # einsums, so the dense (ngc, ngc) Minv (and, under the MPC linearizers,
    # its full tangent stack) never enters the hot path
    Minv_blk: jnp.ndarray = None
    # live-compressed contact rows (3K+NL, n_live, 6) for the same scenes:
    # J products (Delassus, bv, impulse application) contract over live
    # bodies only, without a full-ngc Jall detour in the hot graph
    Jr_live: jnp.ndarray = None


def _contact_rows(scene, pt: PoseTable, con: Contacts, act, d_vec):
    """(K, ngc) rows: [d, r×d]·W_s1 − [d, r×d]·W_s2
    (add_contact_dir_to_Jacobian, src/ImpactConstraintHandler.cpp:1857)."""
    s1, s2 = con.s1, con.s2
    dm = jnp.where(act[:, None], d_vec, 0.0)
    r1 = con.point - pt.pos[s1]
    r2 = con.point - pt.pos[s2]
    w1 = jnp.concatenate([dm, jnp.cross(r1, dm)], axis=-1)  # (K, 6)
    w2 = jnp.concatenate([dm, jnp.cross(r2, dm)], axis=-1)
    J = jnp.einsum("ki,kij->kj", w1, pt.W[s1]) - jnp.einsum(
        "ki,kij->kj", w2, pt.W[s2]
    )
    return J


def _live_free_idx(scene: sc.Scene):
    import numpy as _np

    live_np = _np.asarray(scene.enabled) & (_np.asarray(scene.mass) > 0)
    return _np.nonzero(live_np)[0]


def free_inv_inertia_blocks_live(scene: sc.Scene, quat_b):
    """(n_live, 6, 6) inverse spatial inertia blocks of the statically-live
    free bodies, in world frame. Live-compressed end to end: slicing a full
    (nb, ...) table instead costs a padded cotangent per linearization
    tangent under the MPC backward pass."""
    dtype = quat_b.dtype
    il = _live_free_idx(scene)
    R = quat.to_matrix(quat_b[il])
    Iinv_w = R @ scene.inv_inertia[il] @ jnp.swapaxes(R, -1, -2)
    nl = len(il)
    eye3 = jnp.eye(3, dtype=dtype)
    z3 = jnp.zeros((nl, 3, 3), dtype)
    lin = scene.inv_mass[il, None, None] * eye3[None]
    return jnp.concatenate(
        [
            jnp.concatenate([lin, z3], axis=-1),
            jnp.concatenate([z3, Iinv_w], axis=-1),
        ],
        axis=-2,
    )


def free_inv_inertia_blocks(scene: sc.Scene, quat_b):
    """(nb, 6, 6) per-free-body inverse spatial inertia blocks in world
    (zero rows for disabled/massless fixtures)."""
    dtype = quat_b.dtype
    nb = scene.nb
    il = _live_free_idx(scene)
    blk_l = free_inv_inertia_blocks_live(scene, quat_b)
    if len(il) == nb:
        return blk_l
    return jnp.zeros((nb, 6, 6), dtype).at[il].set(blk_l)


def gc_inv_inertia(scene: sc.Scene, st, quat_b):
    """Dense (ngc, ngc) inverse inertia: 6x6 free-body blocks + per-AB
    joint-space H(q)^{-1} (the reference's X, compute_X :1590)."""
    ngc = scene.ngc
    dtype = st.pos.dtype
    nb = scene.nb
    if nb:
        blk = free_inv_inertia_blocks(scene, quat_b)  # (nb, 6, 6)
        # block-diagonal placement by pad+concat (per-body scatter .at[].set
        # ops and the einsum-with-identity alternative both showed up as
        # real device time in the MPC profile — the einsum's VJP cost 4 ms
        # per sweep; pad/concat transpose to cheap slices)
        if nb == 1:
            free = blk[0]
        else:
            rows = [
                jnp.pad(blk[b], ((0, 0), (6 * b, 6 * (nb - 1 - b))))
                for b in range(nb)
            ]
            free = jnp.concatenate(rows, axis=0)
        if ngc == 6 * nb:
            return free
        bands = [jnp.pad(free, ((0, 0), (0, ngc - 6 * nb)))]
    else:
        bands = []
    for ent in scene.arts:
        m = ent.model
        q = st.q_art[ent.q_off : ent.q_off + m.nq]
        H = art_dyn.crb(m, q)
        # SPD joint-space inverse: on the f32 route LAPACK's
        # `jnp.linalg.inv` lowers to an LU whose traced-index row swaps emit
        # chains of (B, 1, 1) dynamic-update-slices, which a profile of the
        # arm MPC sweep found costly before the GPU port (not yet measured
        # on the GPU). The fused Gauss–Jordan needs no pivoting on SPD H;
        # f64 (CPU regression mode) keeps LAPACK bit-exactness.
        if jnp.dtype(dtype) == jnp.float32:
            from ..solvers.lcp import gj_invert_pd

            Hinv, _ = gj_invert_pd(H)
        else:
            Hinv = jnp.linalg.inv(H)
        bands.append(
            jnp.pad(
                Hinv,
                ((0, 0), (ent.gc_off, ngc - ent.gc_off - m.nv)),
            )
        )
    if not bands:
        return jnp.zeros((ngc, ngc), dtype)
    # gc layout is contiguous (6 per free body, then each AB's nv): the
    # row bands concatenate into the full block-diagonal inverse
    return jnp.concatenate(bands, axis=0)


def assemble_problem(scene, st, pt: PoseTable, con: Contacts, act, act_lim) -> Problem:
    """One stacked Jacobian Jall = [Jn; Js; Jt; Jl], ONE Delassus
    A = Jall Minv Jall^T and one bv = Jall v — instead of 3 row builds,
    4 J@Minv products and 10 cross-block matmuls. The per-op work here is
    tiny (launch-latency dominates a vmapped contact step), so collapsing
    ~25 kernels into ~5 is the win; the named blocks are slices of A."""
    dtype = st.pos.dtype
    K = scene.n_contacts
    NL = scene.n_limits
    ngc = scene.ngc

    # contact rows for all 3 directions in one einsum batch
    if K:
        s1 = jnp.concatenate([con.s1] * 3)
        s2 = jnp.concatenate([con.s2] * 3)
        D = jnp.concatenate([con.normal, con.tan1, con.tan2], axis=0)
        act3 = jnp.concatenate([act] * 3)
        pts = jnp.concatenate([con.point] * 3, axis=0)
        dm = jnp.where(act3[:, None], D, 0.0)
        r1 = pts - pt.pos[s1]
        r2 = pts - pt.pos[s2]
        w1 = jnp.concatenate([dm, jnp.cross(r1, dm)], axis=-1)  # (3K, 6)
        w2 = jnp.concatenate([dm, jnp.cross(r2, dm)], axis=-1)
        J3 = jnp.einsum("ki,kij->kj", w1, pt.W[s1]) - jnp.einsum(
            "ki,kij->kj", w2, pt.W[s2]
        )
    else:
        J3 = jnp.zeros((0, ngc), dtype)

    if NL:
        sign = jnp.where(scene.lim_upper, -1.0, 1.0).astype(dtype)
        sign = jnp.where(act_lim, sign, 0.0)
        Jl = jnp.zeros((NL, ngc), dtype).at[
            jnp.arange(NL), scene.lim_gc_col
        ].set(sign)
    else:
        Jl = jnp.zeros((0, ngc), dtype)

    Jall = jnp.concatenate([J3, Jl], axis=0)  # (3K+NL, ngc)

    Minv = gc_inv_inertia(scene, st, st.quat)
    if scene.bilaterals:
        # X = projected inverse inertia (compute_X, :1590)
        from . import bilateral as bil

        Jb, _ = bil.constraint_rows(scene, st, pt)
        Minv = bil.project_inv_inertia(Minv, Jb)
    v = gc_velocity(scene, st)

    # free-body scenes: Delassus via per-body 6x6 blocks, restricted to the
    # statically-live bodies (Jall's columns for disabled fixtures are
    # identically zero: their PoseTable.W rows are zero). Same contraction,
    # but the dense Minv becomes dead in graphs that never consume it (the
    # MPC replay path), which prunes its tangent stack under linearization,
    # and the dead-body blocks never enter the products at all.
    Minv_blk = None
    Jr_live = None
    # Gate on every ENABLED body being massive: an enabled-but-massless
    # (kinematic) body has zero Minv blocks but nonzero velocity rows in
    # bv = Jall @ v, which the live compression below (masked on
    # enabled & mass>0) would silently drop (ADVICE r4 medium). Such
    # scenes take the dense path.
    import numpy as _np
    _all_enabled_massive = bool(
        ((_np.asarray(scene.mass) > 0) | ~_np.asarray(scene.enabled)).all())
    if (not scene.arts and not scene.bilaterals and scene.nb and K
            and _all_enabled_massive):
        # Jr_live wiring assumes pose-slot index == body index; this holds
        # on this gated path (no articulated bodies => the state IS the
        # pose table) — assert it so a future slot-layout change fails
        # loudly instead of silently mis-wiring contact rows (ADVICE r4).
        assert scene.n_pose_slots == scene.nb, (
            "Jr_live fast path requires pose-slot index == body index "
            f"(n_pose_slots={scene.n_pose_slots}, nb={scene.nb})")

        il = _live_free_idx(scene)
        Minv_blk = free_inv_inertia_blocks_live(scene, st.quat)
        # live-compressed rows straight from the per-slot wrenches: J[k]'s
        # block for live body b is ±w1/w2 — no (·, ngc) intermediate and no
        # einsum against the constant W table in the hot graph (NL == 0
        # here: joint limits imply articulated bodies). The incidence masks
        # come from con.s1/s2: compile-time constants for static scenes
        # (XLA folds the comparison), runtime one-hot rows for pooled
        # scenes (set_pair_pool), where slot->body identity is data.
        il_j = jnp.asarray(il, jnp.int32)
        s1_3 = jnp.concatenate([con.s1] * 3)
        s2_3 = jnp.concatenate([con.s2] * 3)
        m1 = (s1_3[:, None] == il_j[None, :]).astype(dtype)
        m2 = (s2_3[:, None] == il_j[None, :]).astype(dtype)
        Jr_live = (m1[:, :, None] * w1[:, None, :]
                   - m2[:, :, None] * w2[:, None, :])  # (3K, n_live, 6)
        A = jnp.einsum("anp,npq,bnq->ab", Jr_live, Minv_blk, Jr_live)
        bv = jnp.einsum(
            "anp,np->a", Jr_live, v.reshape(scene.nb, 6)[il])
    else:
        A = (Jall @ Minv) @ Jall.T
        bv = Jall @ v

    return Problem(
        Minv_blk=Minv_blk, Jr_live=Jr_live,
        Jn=Jall[:K], Js=Jall[K : 2 * K], Jt=Jall[2 * K : 3 * K],
        Jl=Jall[3 * K :], Minv=Minv,
        Ann=A[:K, :K], Ans=A[:K, K : 2 * K], Ant=A[:K, 2 * K : 3 * K],
        Anl=A[:K, 3 * K :],
        Ass=A[K : 2 * K, K : 2 * K], Ast=A[K : 2 * K, 2 * K : 3 * K],
        Asl=A[K : 2 * K, 3 * K :],
        Att=A[2 * K : 3 * K, 2 * K : 3 * K], Atl=A[2 * K : 3 * K, 3 * K :],
        All=A[3 * K :, 3 * K :],
        Cn_v=bv[:K],
        Cs_v=bv[K : 2 * K],
        Ct_v=bv[2 * K : 3 * K],
        L_v=bv[3 * K :],
        Jall=Jall, A=A, bv=bv,
    )


import numpy as _np
from functools import lru_cache


@lru_cache(maxsize=64)
def _qp_tables_cached(key):
    (K, NL, NF, fr, fr_cos, fr_sin, mu_c, mu_v, compliance, dtname) = key
    fr = _np.array(fr, _np.int64)
    fr_cos = _np.array(fr_cos)
    fr_sin = _np.array(fr_sin)
    mu_c = _np.array(mu_c)
    mu_v = _np.array(mu_v)
    compliance = _np.array(compliance)
    dt = _np.dtype(dtname)
    NV = 5 * K + NL
    NI = K + NL + NF
    n = NV + NI

    # variable -> (row of A, sign): x = [cn, cs, ct, ncs, nct, l]
    vm = _np.concatenate([
        _np.arange(K), K + _np.arange(K), 2 * K + _np.arange(K),
        K + _np.arange(K), 2 * K + _np.arange(K), 3 * K + _np.arange(NL),
    ]).astype(_np.int64)
    vs = _np.concatenate([
        _np.ones(K), _np.ones(K), _np.ones(K),
        -_np.ones(K), -_np.ones(K), _np.ones(NL),
    ])
    # inequality row -> (row of A, sign); friction rows have no A part
    im = _np.concatenate([
        _np.arange(K), 3 * K + _np.arange(NL), _np.zeros(NF, _np.int64)])
    is_ = _np.concatenate([_np.ones(K), _np.ones(NL), _np.zeros(NF)])
    # constant friction-cone rows (slot_mu_c / fan cos/sin are scene statics)
    Mf = _np.zeros((NI, NV))
    r0 = K + NL
    for j in range(NF):
        Mf[r0 + j, fr[j]] = mu_c[fr[j]]
        Mf[r0 + j, K + fr[j]] = -fr_cos[j]
        Mf[r0 + j, 3 * K + fr[j]] = -fr_cos[j]
        Mf[r0 + j, 2 * K + fr[j]] = -fr_sin[j]
        Mf[r0 + j, 4 * K + fr[j]] = -fr_sin[j]

    rm = _np.concatenate([vm, im])        # (n,) A-row per MM row
    rs = _np.concatenate([vs, is_])
    cm = _np.concatenate([vm, im])        # (n,) A-col per MM col
    cs_sign = _np.concatenate([vs, -is_])  # upper-right block is -Mineq^T

    I = _np.broadcast_to(rm[:, None], (n, n)).copy()
    J = _np.broadcast_to(cm[None, :], (n, n)).copy()
    S = rs[:, None] * cs_sign[None, :]
    # zero the (ineq, ineq) block; the lower-left block is already +Mineq
    # (rs[NV:] = is_, cs_sign[:NV] = vs)
    S[NV:, NV:] = 0.0
    C = _np.zeros((n, n))
    C[_np.arange(K), _np.arange(K)] += compliance        # H compliance diag
    C[NV:, :NV] += Mf                                    # +Mineq friction
    C[:NV, NV:] += -Mf.T                                 # -Mineq^T

    # qq = qs * bv[qm] + qt * tvel[qf]
    qm = _np.concatenate([vm, im]).astype(_np.int64)
    qs = _np.concatenate([vs, is_])
    qf = _np.zeros(n, _np.int64)
    qt = _np.zeros(n)
    qf[NV + r0 : NV + r0 + NF] = fr
    qt[NV + r0 : NV + r0 + NF] = mu_v[fr]

    return (
        _np.ascontiguousarray(I), _np.ascontiguousarray(J),
        S.astype(dt), C.astype(dt),
        qm, qs.astype(dt), qf, qt.astype(dt),
    )


def _qp_tables(scene: sc.Scene, dtype):
    key = (
        scene.n_contacts, scene.n_limits, scene.n_friction_rows,
        tuple(_np.asarray(scene.fr_con).tolist()),
        tuple(_np.asarray(scene.fr_cos).tolist()),
        tuple(_np.asarray(scene.fr_sin).tolist()),
        tuple(_np.asarray(scene.slot_mu_c).tolist()),
        tuple(_np.asarray(scene.slot_mu_v).tolist()),
        tuple(_np.asarray(scene.slot_compliance).tolist()),
        _np.dtype(dtype).name,
    )
    return _qp_tables_cached(key)


def build_qp_lcp(scene: sc.Scene, p: Problem, act, act_lim):
    """Stack the QP into the monolithic KKT LCP (setup_QP + solve_qp_work).

    Variables x = [cn, cs, ct, ncs, nct, l]; inequality rows
    [Cn·v+ >= 0 (K)], [L·v+ >= 0 (NL)], [friction (NF)].
    MM = [[H, -M'], [M, 0]],  qq = [c, Cn_v, L_v, mu_visc·|v_t|].

    Every MM entry is (± an entry of the stacked Delassus A) + a static
    constant, so the whole stack is ONE gather + FMA against trace-time
    index/sign/const tables (`_qp_tables`) — the block-concatenate
    formulation cost ~25 small kernels per step, which dominated the
    vmapped MPC rollout (launch-bound, not FLOP-bound).
    """
    K = scene.n_contacts
    dtype = p.Ann.dtype
    I, J, S, C, qm, qs, qf, qt = _qp_tables(scene, dtype)

    bv = jnp.concatenate([p.Cn_v, p.Cs_v, p.Ct_v, p.L_v])
    MM = jnp.asarray(S) * p.A[jnp.asarray(I), jnp.asarray(J)] + jnp.asarray(C)
    qq = jnp.asarray(qs) * bv[jnp.asarray(qm)]
    # viscous term mu_v*|v_t|: statically skipped when every mu_v is zero —
    # not just dead weight: d sqrt(x^2+y^2) at (0,0) is 0/0 = NaN, and a
    # resting contact has EXACTLY zero tangential velocity, so under
    # jacrev the zero qt weight times the NaN subgradient poisoned the
    # whole (M, q) pullback (with the from_matrix trap, the second half of
    # the bug that froze the articulated MPC backward pass through r4).
    # With nonzero mu_v the sqrt argument is floored at tiny: the value
    # shift is ~1e-19 and the |v_t| subgradient at 0 becomes 0 (the
    # correct element of the subdifferential).
    if scene.n_friction_rows and float(
            _np.max(_np.asarray(scene.slot_mu_v))) != 0.0:
        tiny = jnp.asarray(_np.finfo(_np.dtype(dtype)).tiny, dtype)
        tvel = jnp.sqrt(jnp.maximum(p.Cs_v ** 2 + p.Ct_v ** 2, tiny))
        qq = qq + jnp.asarray(qt) * tvel[jnp.asarray(qf)]

    fr = scene.fr_con
    var_act = jnp.concatenate([act] * 5 + [act_lim])
    row_act = jnp.concatenate([act, act_lim, act[fr]])
    mask = jnp.concatenate([var_act, row_act])
    return MM, qq, mask


def unstack_impulses(scene: sc.Scene, z):
    K = scene.n_contacts
    cn = z[:K]
    cs = z[K : 2 * K] - z[3 * K : 4 * K]
    ct = z[2 * K : 3 * K] - z[4 * K : 5 * K]
    l = z[5 * K : 5 * K + scene.n_limits]
    return cn, cs, ct, l


@lru_cache(maxsize=64)
def _impulse_vec_tables(K, NL, dtname):
    ga = _np.concatenate([
        _np.arange(K), K + _np.arange(K), 2 * K + _np.arange(K),
        5 * K + _np.arange(NL)]).astype(_np.int64)
    gb = _np.concatenate([
        _np.zeros(K, _np.int64), 3 * K + _np.arange(K),
        4 * K + _np.arange(K), _np.zeros(NL, _np.int64)])
    gc = _np.concatenate([
        _np.zeros(K), -_np.ones(K), -_np.ones(K), _np.zeros(NL)])
    return ga, gb, gc.astype(_np.dtype(dtname))


def _impulse_vec(scene: sc.Scene, z):
    """z (n_lcp,) -> stacked impulse (3K+NL,) = [cn, cs-ncs, ct-nct, l]
    as one gather-FMA (static index tables, cached like `_qp_tables`)."""
    ga, gb, gc = _impulse_vec_tables(
        scene.n_contacts, scene.n_limits, _np.dtype(z.dtype).name
    )
    return z[ga] + jnp.asarray(gc) * z[gb]


def impulse_dv(scene, p: Problem, cn, cs, ct, l):
    """dv = inv(M)(Jn'cn + Js'cs + Jt'ct + Jl'l) (update_from_stacked)."""
    w = p.Jn.T @ cn + p.Js.T @ cs + p.Jt.T @ ct + p.Jl.T @ l
    return p.Minv @ w


def _min_constraint_vel(Cn_v, act, L_v, act_lim):
    vals = jnp.concatenate(
        [
            jnp.where(act, Cn_v, jnp.inf),
            jnp.where(act_lim, L_v, jnp.inf),
            jnp.array([jnp.inf], Cn_v.dtype),
        ]
    )
    return jnp.min(vals)


def resolve_impacts(
    scene: sc.Scene, st, pt: PoseTable, con: Contacts, zlast, zlast_active,
    lcp_solver=None, act_filter=None, lim_filter=None,
) -> ImpactResult:
    """Full impact pipeline for one step (QP model). Returns the gc velocity
    delta (zero when no constraint is impacting —
    `calc_impacting_unilateral_constraint_forces` early-out).

    `lcp_solver(M, q, mask, z0) -> (z, ok)` defaults to the production
    pivoting cascade; the MPC layer substitutes the IFT-differentiable solve.
    `act_filter`/`lim_filter` restrict the solve to a subset of contact/limit
    slots (per-island model dispatch: groups routed to another model are
    masked out here).
    """
    if lcp_solver is None:
        lcp_solver = lambda M, q, m, z0, skip=None: lcp.solve_lcp(
            M, q, m, z0=z0, skip=skip, with_stats=True
        )

    def call_solver(M, q, m, z0_, skip_):
        """Normalize (z, ok) / (z, ok, stats) solver returns."""
        out = lcp_solver(M, q, m, z0_, skip=skip_)
        if len(out) == 3:
            return out
        z_, ok_ = out
        return z_, ok_, lcp.LCPStats(
            pivots=jnp.zeros((), jnp.int32), fallback=jnp.array(False)
        )
    dtype = st.pos.dtype
    nz = cfg.near_zero(dtype)
    K = scene.n_contacts

    act, act_lim, cn_vel, lim_vel = _active(scene, st, pt, con, nz)
    if act_filter is not None:
        act = act & act_filter
    if lim_filter is not None and scene.n_limits:
        act_lim = act_lim & lim_filter
    any_impact = jnp.any(act) | (jnp.any(act_lim) if scene.n_limits else False)

    p = assemble_problem(scene, st, pt, con, act, act_lim)
    MM, qq, mask = build_qp_lcp(scene, p, act, act_lim)

    same = jnp.all(zlast_active == act) & jnp.any(zlast_active)
    z0 = jnp.where(same, zlast, jnp.zeros_like(zlast))

    # nothing impacting -> dv is zeroed below anyway; skip the pivot loops
    # (`calc_impacting_unilateral_constraint_forces` early-out)
    z, ok, st1 = call_solver(MM, qq, mask, z0, ~any_impact)
    cn1 = z[:K]
    imp1 = _impulse_vec(scene, z)
    # post-solve constraint velocities via the Delassus operator
    # (bv + A imp == bv + Jall dv, no ngc round trip)
    bv1 = p.bv + p.A @ imp1
    Cn_v1 = bv1[:K]
    L_v1 = bv1[3 * K :]
    minv = _min_constraint_vel(Cn_v1, act, L_v1, act_lim)

    # Poisson restitution: scale cn and l segments of the stacked z
    # (apply_restitution(q, z), src/ImpactConstraintHandler.cpp:470-500).
    # When every restitution coefficient is zero (compile-time static) the
    # scaled impulses vanish, `changed` is always False and dv == dv1 —
    # skip the whole second assembly + gated solve (a large per-step saving
    # for the eps=0 MPC scenes).
    import numpy as _np

    eps_all_zero = (
        (K == 0 or float(_np.max(_np.asarray(scene.slot_eps))) == 0.0)
        and (scene.n_limits == 0
             or float(_np.max(_np.asarray(scene.lim_eps))) == 0.0)
    )
    def _impulse_to_dv(imp):
        """dv = inv(M) Jallᵀ imp, through the live-compressed blocks when
        the scene provides them (free bodies, no bilaterals)."""
        if p.Jr_live is not None:
            import numpy as _np

            il = _live_free_idx(scene)
            w_l = jnp.einsum("anp,a->np", p.Jr_live, imp)
            dv_l = jnp.einsum("npq,nq->np", p.Minv_blk, w_l)
            if len(il) == scene.nb:
                return dv_l.reshape(-1)
            rows = (6 * il[:, None] + _np.arange(6)[None]).reshape(-1)
            return jnp.zeros(scene.ngc, imp.dtype).at[rows].set(
                dv_l.reshape(-1))
        return p.Minv @ (p.Jall.T @ imp)

    if eps_all_zero:
        dv = _impulse_to_dv(imp1)
        z_f = z
        dv = jnp.where(any_impact, dv, jnp.zeros_like(dv))
        if scene.bilaterals:
            # λ-correction removing bilateral constraint-velocity violation
            # (update_from_stacked :355-379) — applied regardless of
            # unilateral impacts: a violating velocity (e.g. initial
            # conditions against an implicit joint) must not persist until
            # an unrelated impact fires
            from . import bilateral as bil

            Jb, _ = bil.constraint_rows(scene, st, pt)
            Minv_raw = gc_inv_inertia(scene, st, st.quat)
            v_pre = gc_velocity(scene, st)
            dv = dv + bil.velocity_correction(Minv_raw, Jb, v_pre + dv)
        z_out = jnp.where(any_impact, z_f, zlast)
        za_out = jnp.where(any_impact, act, zlast_active)
        cn_total = jnp.where(any_impact, cn1, jnp.zeros(K, dtype))
        pivots = st1.pivots.astype(jnp.int32)
        fallbacks = st1.fallback.astype(jnp.int32)
        return ImpactResult(
            dv, z_out, za_out, cn_total, pivots, fallbacks,
            z_step=jnp.where(any_impact, z_f, jnp.zeros_like(z_f)),
        )

    zr = z.at[:K].multiply(scene.slot_eps)
    if scene.n_limits:
        zr = zr.at[5 * K : 5 * K + scene.n_limits].multiply(scene.lim_eps)
    changed = jnp.any(zr[:K] > nz)
    if scene.n_limits:
        changed = changed | jnp.any(zr[5 * K : 5 * K + scene.n_limits] > nz)

    cn2 = zr[:K]
    imp2 = _impulse_vec(scene, zr)
    bv2 = bv1 + p.A @ imp2
    Cn_v2 = bv2[:K]
    L_v2 = bv2[3 * K :]
    minv_plus = _min_constraint_vel(Cn_v2, act, L_v2, act_lim)

    need_resolve = changed & (minv_plus < 0.0) & (minv_plus < minv - nz)

    # second impact problem from post-restitution velocities
    p2 = p._replace(
        Cn_v=Cn_v2,
        Cs_v=bv2[K : 2 * K],
        Ct_v=bv2[2 * K : 3 * K],
        L_v=L_v2,
    )
    MM2, qq2, _ = build_qp_lcp(scene, p2, act, act_lim)
    # the second impact solve only matters when restitution re-triggers
    # impacts — gate its pivot loops out otherwise (depth saving)
    z3, _, st3 = call_solver(MM2, qq2, mask, z, ~need_resolve)
    cn3 = z3[:K]
    imp3 = _impulse_vec(scene, z3)

    zero = jnp.zeros_like(imp1)
    imp_tot = (
        imp1
        + jnp.where(changed, imp2, zero)
        + jnp.where(need_resolve, imp3, zero)
    )
    dv = _impulse_to_dv(imp_tot)
    z_f = jnp.where(need_resolve, z3, z)

    dv = jnp.where(any_impact, dv, jnp.zeros_like(dv))
    if scene.bilaterals:
        # λ-correction removing bilateral constraint-velocity violation
        # (update_from_stacked, :355-379) — ungated: see eps_all_zero path
        from . import bilateral as bil

        Jb, _ = bil.constraint_rows(scene, st, pt)
        Minv_raw = gc_inv_inertia(scene, st, st.quat)
        v_pre = gc_velocity(scene, st)
        dv = dv + bil.velocity_correction(Minv_raw, Jb, v_pre + dv)
    z_out = jnp.where(any_impact, z_f, zlast)
    za_out = jnp.where(any_impact, act, zlast_active)
    cn_total = jnp.where(
        any_impact,
        cn1 + jnp.where(changed, cn2, 0.0) + jnp.where(need_resolve, cn3, 0.0),
        jnp.zeros(K, dtype),
    )
    pivots = (st1.pivots + st3.pivots).astype(jnp.int32)
    fallbacks = st1.fallback.astype(jnp.int32) + st3.fallback.astype(jnp.int32)
    return ImpactResult(
        dv, z_out, za_out, cn_total, pivots, fallbacks,
        z_step=jnp.where(any_impact, z_f, jnp.zeros_like(z_f)),
    )


def group_labels(scene, con):
    """Island label of every contact slot and limit slot (the connected
    constraint groups of `determine_connected_constraints`).

    Pooled scenes (set_pair_pool): slot->body incidence is runtime data, so
    the static island propagation doesn't apply — the whole scene is one
    constraint group (conservative: separating members simply receive zero
    impulses in the joint solve; model routing is compile-time uniform)."""
    if scene.has_dyn_slots:
        return (jnp.zeros(scene.n_contacts, jnp.int32),
                jnp.zeros(scene.n_limits, jnp.int32))
    labels = island_labels(scene, con.active)
    ns = scene.n_pose_slots
    s1, s2 = scene.slot_s1, scene.slot_s2
    lab1 = jnp.where(scene.slot_enabled[s1], labels[s1], jnp.int32(ns))
    lab2 = jnp.where(scene.slot_enabled[s2], labels[s2], jnp.int32(ns))
    con_lab = jnp.minimum(lab1, lab2)

    if scene.n_limits:
        col_to_slot = jnp.zeros(scene.ngc, jnp.int32)
        off = scene.nb
        for ent in scene.arts:
            col_to_slot = col_to_slot.at[
                ent.gc_off : ent.gc_off + ent.model.nv
            ].set(off)
            off += ent.model.nl
        lim_lab = labels[col_to_slot[scene.lim_gc_col]]
    else:
        lim_lab = jnp.zeros(0, jnp.int32)
    return con_lab, lim_lab


def model_masks(scene, con):
    """Per-island impact-model routing (`apply_model`'s per-group dispatch,
    src/ImpactConstraintHandler.cpp:113-151): a group where every active
    contact has mu >= 100 uses the no-slip MLCP; else a group with any
    true-cone contact (NK = inf) uses the NQP; else the QP. Returns
    ((act_ns, lim_ns), (act_nqp, lim_nqp), (act_qp, lim_qp)) slot filters.
    """
    ns = scene.n_pose_slots
    con_lab, lim_lab = group_labels(scene, con)
    slot_inf = scene.slot_mu_c >= 1e2
    slot_tc = scene.slot_truecone

    grp_finite = jnp.zeros(ns + 1, bool).at[con_lab].max(
        con.active & ~slot_inf
    )
    grp_tc = jnp.zeros(ns + 1, bool).at[con_lab].max(con.active & slot_tc)

    con_ns = ~grp_finite[con_lab]
    con_nqp = grp_tc[con_lab] & ~con_ns
    con_qp = ~con_ns & ~con_nqp
    lim_ns = ~grp_finite[lim_lab]
    lim_nqp = grp_tc[lim_lab] & ~lim_ns
    lim_qp = ~lim_ns & ~lim_nqp
    return (con_ns, lim_ns), (con_nqp, lim_nqp), (con_qp, lim_qp)


def _active(scene, st, pt, con, nz):
    """Solve masks (contacts, limits) plus raw constraint velocities."""
    cn_vel, _, _ = contact_velocities(scene, pt, con)
    lim_act, lim_vel = limit_activity_state(scene, st, nz)

    con_lab, lim_lab = group_labels(scene, con)

    # "group has an impacting member" via label comparison instead of a
    # scatter-max over a (ns+1,) table: O(K^2) fused bools beat a scatter
    # kernel at the K this engine batches (dstep hot path)
    def _any_in_group(lab_q, lab_src, flags):
        return jnp.any(
            (lab_q[:, None] == lab_src[None, :]) & flags[None, :], axis=1
        )

    neg_con = con.active & (cn_vel < -nz)
    if scene.n_limits:
        neg_lim = lim_act & (lim_vel < -nz)
        act = con.active & (
            _any_in_group(con_lab, con_lab, neg_con)
            | _any_in_group(con_lab, lim_lab, neg_lim)
        )
        act_lim = lim_act & (
            _any_in_group(lim_lab, con_lab, neg_con)
            | _any_in_group(lim_lab, lim_lab, neg_lim)
        )
    else:
        act = con.active & _any_in_group(con_lab, con_lab, neg_con)
        act_lim = lim_act
    return act, act_lim, cn_vel, lim_vel
