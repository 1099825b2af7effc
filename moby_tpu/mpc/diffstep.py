"""Differentiable contact dynamics step for MPC / trajectory optimization.

The regression-faithful stepper (`sim.stepper.step`) has data-dependent
while loops (conservative advancement, stabilization) that block reverse-mode
AD. This module provides the MPC-grade step: fixed step size (no CA
sub-stepping — MPC steps are small), one impact solve through the
IFT-differentiable LCP (`solvers.difflcp`), no stabilization loop. Controls
enter as generalized forces u (scene.ngc): wrenches on free bodies + joint
torques on articulated dofs.

This is the `f(x, u)` of the contact-implicit MPC north star
(BASELINE.json): thousands of these batch per device under `vmap`, shard
over a device mesh, and differentiate end-to-end for iLQR/SQP.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import scene as sc
from ..dynamics import aba as art_dyn
from ..geometry import narrowphase as nph
from ..math import quaternion as quat
from ..sim import impact, kinematics
from ..sim.stepper import forward_dynamics_free, integrate_art_q
from ..solvers.difflcp import (
    solve_lcp_diff_mpc,
    solve_lcp_given,
    solve_lcp_given_fwd,
)


def _diff_lcp(M, q, mask, z0, skip=None):
    if skip is None:
        skip = jnp.array(False)
    return solve_lcp_diff_mpc(M, q, mask, z0, skip), jnp.array(True)


def _replay_lcp(z_rec, fwd=False):
    """LCP 'solver' that replays a recorded solution (same IFT gradients,
    zero pivot iterations). Only valid for single-solve scenes (all
    restitution zero — the gated second solve would need its own record).
    fwd=True uses the custom-JVP twin for `jacfwd` linearization."""

    given = solve_lcp_given_fwd if fwd else solve_lcp_given

    def solver(M, q, mask, z0, skip=None):
        return given(M, q, mask, z_rec), jnp.array(True)

    return solver


def replay_ok(scene: sc.Scene) -> bool:
    """True when a dstep performs exactly one LCP solve (the eps_all_zero
    fast path of resolve_impacts), so record/replay linearization is exact."""
    import numpy as np

    K = scene.n_contacts
    eps0 = K == 0 or float(np.max(np.asarray(scene.slot_eps))) == 0.0
    lim0 = scene.n_limits == 0 or float(
        np.max(np.asarray(scene.lim_eps))
    ) == 0.0
    return eps0 and lim0


def dstep_pre(scene: sc.Scene, st: sc.State, dt, u=None) -> sc.State:
    """The smooth half of `dstep`: semi-implicit pose integration + forces
    + dissipation — everything BEFORE contact resolution. Split out so the
    block-sparse MPC linearizer (`contact_mpc`) can chain its Jacobian with
    the contact half's without re-differentiating the whole step."""
    dtype = st.pos.dtype
    dt = jnp.asarray(dt, dtype)

    # position integration (semi-implicit: old velocities)
    qdot = quat.deriv(st.quat, st.omega)
    pos = st.pos + st.vel * dt
    quat_b = quat.normalize(st.quat + qdot * dt)
    q_art = integrate_art_q(scene, st.q_art, st.qd_art, dt)
    st2 = st.replace(pos=pos, quat=quat_b, q_art=q_art)

    # forward dynamics with controls
    a_lin, a_ang = forward_dynamics_free(scene, st2.quat, st2.omega)
    if u is not None and scene.nb:
        import numpy as _np

        ub = u[: 6 * scene.nb].reshape(scene.nb, 6)
        a_lin = a_lin + scene.inv_mass[:, None] * ub[:, :3]
        # torque→α only for statically-live bodies (disabled fixtures get
        # zero columns from the control expansion anyway; trimming the dead
        # rotation chains halves the tangent fan-out under linearization)
        live = _np.asarray(scene.enabled) & (_np.asarray(scene.mass) > 0)
        il = _np.nonzero(live)[0]
        if len(il):
            R = quat.to_matrix(st2.quat[il])
            Iinv_w = R @ scene.inv_inertia[il] @ jnp.swapaxes(R, -1, -2)
            da = jnp.einsum("bij,bj->bi", Iinv_w, ub[il, 3:])
            a_ang = (
                a_ang + da if len(il) == scene.nb
                else a_ang.at[il].add(da)
            )
    vel = st2.vel + a_lin * dt
    omega = st2.omega + a_ang * dt

    if scene.nv_art:
        tau = u[6 * scene.nb :] if u is not None else None
        parts = []
        for ent in scene.arts:
            m = ent.model
            q = st2.q_art[ent.q_off : ent.q_off + m.nq]
            qd = st2.qd_art[ent.v_off : ent.v_off + m.nv]
            t = (
                tau[ent.v_off : ent.v_off + m.nv]
                if tau is not None
                else jnp.zeros(m.nv, dtype)
            )
            parts.append(art_dyn.aba(m, q, qd, t, scene.gravity))
        qd_art = st2.qd_art + jnp.concatenate(parts) * dt
    else:
        qd_art = st2.qd_art

    lam = scene.dissipation_lambda[:, None]
    return st2.replace(vel=vel * lam, omega=omega * lam, qd_art=qd_art)


def contact_dv_replay(scene: sc.Scene, st2: sc.State, z, fwd=True):
    """gc-velocity delta of the contact half of `dstep` at a pose-integrated
    pre-contact state `st2`, replaying the recorded solution z. The fwd
    (custom-JVP) replay makes this `jacfwd`-able for the block linearizer."""
    pt = kinematics.compute(scene, st2)
    _, con = nph.narrow_phase(
        scene, pt.pos, pt.quat, scene.contact_dist_thresh
    )
    res = impact.resolve_impacts(
        scene, st2, pt, con,
        jnp.zeros_like(st2.zlast), jnp.zeros_like(st2.zlast_active),
        lcp_solver=_replay_lcp(z, fwd=fwd),
    )
    return res.dv


def dstep(scene: sc.Scene, st: sc.State, dt, u=None,
          lcp_given=None, return_z=False, lcp_fwd=False):
    """One differentiable step. u: optional (ngc,) generalized force.
    lcp_given: optional recorded LCP solution (see `_replay_lcp`); callers
    must ensure `replay_ok(scene)`. return_z: also return the LCP solution
    actually applied this step (zero when gated) for record/replay.
    lcp_fwd: replay through the custom-JVP LCP for `jacfwd` callers."""
    dtype = st.pos.dtype
    dt = jnp.asarray(dt, dtype)
    st2 = dstep_pre(scene, st, dt, u)

    z_step = jnp.zeros_like(st.zlast)
    if scene.n_contacts or scene.n_limits:
        pt = kinematics.compute(scene, st2)
        _, con = nph.narrow_phase(
            scene, pt.pos, pt.quat, scene.contact_dist_thresh
        )
        res = impact.resolve_impacts(
            scene, st2, pt, con, st.zlast, st.zlast_active,
            lcp_solver=(
                _diff_lcp if lcp_given is None
                else _replay_lcp(lcp_given, fwd=lcp_fwd)
            ),
        )
        st2 = kinematics.apply_gc_velocity_delta(scene, st2, res.dv)
        st2 = st2.replace(zlast=res.zlast, zlast_active=res.zlast_active)
        z_step = res.z_step

    st2 = st2.replace(time=st.time + dt)
    if return_z:
        return st2, z_step
    return st2


def rollout(scene: sc.Scene, st: sc.State, us, dt):
    """Differentiable rollout: us (H, ngc) -> (final state, per-step states)."""

    def f(s, u):
        s2 = dstep(scene, s, dt, u)
        return s2, s2

    return jax.lax.scan(f, st, us)


def state_vector(scene: sc.Scene, st: sc.State):
    """Flatten the dynamic state (positions + velocities) for costs."""
    parts = []
    if scene.nb:
        parts += [st.pos.ravel(), st.quat.ravel(), st.vel.ravel(), st.omega.ravel()]
    if scene.nq_art:
        parts.append(st.q_art)
    if scene.nv_art:
        parts.append(st.qd_art)
    return jnp.concatenate(parts)
