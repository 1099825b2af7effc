"""Differentiable LCP: implicit-function-theorem gradients through the
contact solve (SURVEY.md hard part #5 — differentiating the impact LCP for
MPC).

Forward: a pivoting solve. Backward: at a solution (z, w = Mz + q), the
active set A = {i : z_i > 0} satisfies M_AA z_A + q_A = 0. By the IFT, for
perturbations (dM, dq):

    dz_A = -M_AA^{-1} (dM_A: z + dq_A),   dz_{A^c} = 0

so the VJP pulls cotangents back through one masked linear solve:

    gbar_A = -M_AA^{-T} zbar_A
    qbar   = gbar,    Mbar = gbar z^T      (restricted to active rows)

Degenerate contacts (z_i = 0, w_i = 0) get the subgradient with the active
side chosen by z > tol — the standard choice for contact-implicit trajectory
optimization.

Two forward variants share the same VJP:

* :func:`solve_lcp_diff` — the full production cascade (`solve_lcp`):
  regression-grade robustness for offline gradient checks.
* :func:`solve_lcp_diff_mpc` — the MPC hot path: block principal pivoting
  (a handful of lock-step iterations) with a single `lcp_fast` fallback, no
  Tikhonov sweeps and no Lemke. The QP-derived impact LCPs are monotone, so
  BPP+Murty is finite and the fallback almost never fires; dropping the
  nested regularization while_loops cuts the sequential depth that dominates
  a vmapped iLQR rollout step. Honors `skip` so gated second solves
  (restitution re-solve) cost no pivot iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import lcp as lcp_mod


def _compact_cap(n: int) -> int:
    """Static active-set cap for the compacted IFT inverse (0 = disabled).

    The solution active set of the monotone QP-KKT impact LCP is small (its
    positive components are the pushing impulse directions + binding
    multipliers, bounded in practice by ~ngc + a few), while the padded LCP
    dimension n grows with contact/friction/limit slots. The full masked
    Gauss–Jordan inverse runs n sequential rank-1 steps on (n, n) — for the
    ur10 problem (n=88) that sequential depth dominated the dispatch-bound
    MPC backward pass. Compacting to the NA deepest slots cuts the depth and
    the bandwidth quadratically. Overridable via MOBY_IFT_COMPACT_NA;
    active sets exceeding the cap poison the pullback with NaN, which the
    iLQR ok/isfinite guards treat like a failed (non-PD) backward step.
    """
    import os

    na = int(os.environ.get("MOBY_IFT_COMPACT_NA", "32"))
    if n <= max(na, 48):  # small problems: full inverse is already cheap
        return 0
    return na


def _prep_bwd(M, z, mask, transpose: bool = True):
    """Residuals for the IFT pullback: the active set and the explicit
    inverse of the masked system M_AA^T (reverse mode) or M_AA (forward
    mode, `transpose=False`).

    The pullback is linear in zbar but `jacrev` evaluates it once per output
    basis vector (nx of them per iLQR backward step); an iterative masked
    solve per cotangent would repeat the same elimination nx times. Inverting
    M_AA^T ONCE here (fused Gauss–Jordan, ~2x one solve) turns every pullback
    into a matvec. Runs only under linearization — plain rollouts never pay.

    For large problems (see `_compact_cap`) the inverse is computed on the
    NA-compacted active block: residuals are (inv_c (NA,NA), P (NA,n)) with
    the implicit identity Ainv_T = P^T inv_c P, applied as three small
    matmuls per pullback (no scatters).
    """
    eps = jnp.asarray(1e-10, M.dtype)
    active = (z > eps) & mask
    dtype = M.dtype
    n = z.shape[-1]
    MT = M.T if transpose else M
    # Tikhonov-regularize the active block before inverting: contact-LCP
    # active sets are ROUTINELY rank-deficient (e.g. ur10: >= 14 active
    # impulse directions through a rank-<=12 Delassus — redundant manifold
    # points + friction splits), so the exact M_AA^{-1} does not exist.
    # The r4 code NaN-poisoned (f32) or silently zeroed (f64) the pullback
    # there, which froze the ENTIRE articulated MPC backward pass — every
    # iLQR step carried NaN gains and was rejected, so ur10 "solves" never
    # moved the controls. The lambda*I shift selects the smoothed element
    # of the IFT subdifferential (the standard soft-IFT of differentiable
    # contact solvers; the value analog of the reference's greedy
    # full-rank row selection, src/ImpactConstraintHandler.cpp:1082-1110)
    # and perturbs well-conditioned blocks by O(lambda/sigma_min).
    lam = (jnp.asarray(np.sqrt(np.finfo(np.dtype(dtype)).eps), dtype)
           * lcp_mod._masked_norm_inf(MT, mask))
    na = _compact_cap(n) if lcp_mod._use_gj(dtype) else 0
    if na:
        # compact: gather the active rows/cols of M^T to the top-left
        # NA x NA block via a stable actives-first permutation
        idx = jnp.argsort(~active)[:na]
        cnt = jnp.sum(active)
        P = jax.nn.one_hot(idx, n, dtype=dtype)            # (NA, n)
        rowm = jnp.arange(na) < cnt
        sub = (P @ MT) @ P.T                                # (NA, NA)
        subm = jnp.where(rowm[:, None] & rowm[None, :], sub, 0.0) + jnp.diag(
            jnp.where(rowm, lam, 1.0).astype(dtype)
        )
        inv_c, ok = lcp_mod.gj_invert_masked(subm, rowm)
        # active set exceeding the cap: poison the pullback (NaN) so the
        # caller's isfinite guard rejects the step instead of silently
        # using a truncated inverse
        bad = (cnt > na) | ~ok
        inv_c = jnp.where(bad, jnp.full_like(inv_c, jnp.nan), inv_c)
        return active, (inv_c, P)
    outer = active[:, None] & active[None, :]
    A_T = jnp.where(outer, MT, 0.0) + jnp.diag(
        jnp.where(active, lam, 1.0).astype(dtype)
    )
    if lcp_mod._use_gj(dtype):
        Ainv_T, ok = lcp_mod.gj_invert_masked(A_T, active)
    else:
        Ainv_T = jnp.linalg.inv(A_T)
        ok = jnp.all(jnp.isfinite(Ainv_T))
    Ainv_T = jnp.where(ok, Ainv_T, jnp.zeros_like(Ainv_T))
    return active, Ainv_T


def _ift_bwd(active, Ainv_T, z, zbar):
    zb = jnp.where(active, zbar, jnp.zeros_like(zbar))
    if isinstance(Ainv_T, tuple):
        inv_c, P = Ainv_T
        # gbar_A = -(P^T inv_c P) zbar_A: compact matvecs, no scatter
        gbar = -(P.T @ (inv_c @ (P @ zb)))
    else:
        # gbar_A = -M_AA^{-T} zbar_A  (precomputed inverse; see _prep_bwd)
        gbar = -(Ainv_T @ zb)
    gbar = jnp.where(active, gbar, jnp.zeros_like(gbar))

    Mbar = gbar[:, None] * z[None, :]
    qbar = gbar
    return Mbar, qbar


@jax.custom_vjp
def solve_lcp_diff(M, q, mask, z0):
    z, ok = lcp_mod.solve_lcp(M, q, mask, z0=z0)
    return z


def _fwd(M, q, mask, z0):
    z = solve_lcp_diff(M, q, mask, z0)
    active, Ainv_T = _prep_bwd(M, z, mask)
    return z, (active, Ainv_T, z)


def _bwd(res, zbar):
    active, Ainv_T, z = res
    Mbar, qbar = _ift_bwd(active, Ainv_T, z, zbar)
    return Mbar, qbar, None, None


solve_lcp_diff.defvjp(_fwd, _bwd)


@jax.custom_vjp
def solve_lcp_diff_mpc(M, q, mask, z0, skip):
    z, ok = _mpc_forward(M, q, mask, z0, skip)
    return z


def _mpc_forward(M, q, mask, z0, skip):
    # deliberately NOT the full `solve_lcp` cascade: MPC impact LCPs are
    # small (single-digit active sets) and sit inside an H=50 rollout
    # scanned 4+ iLQR iterations deep, so the nested regularization sweeps
    # would dominate. BPP with fused-GJ sub-solves (the GJ route arrives via
    # solve_principal), then shallow regularized BPP rungs, is the lean path.
    dtype = M.dtype
    Mp, qp = lcp_mod.pad_lcp(M, q, mask)
    m_active = jnp.sum(mask).astype(dtype)
    near_zero = float(np.sqrt(np.finfo(np.dtype(dtype)).eps))
    check_tol = (
        m_active * lcp_mod._masked_norm_inf(Mp, mask) * near_zero
    ).astype(dtype)

    # compacted working-set BPP for large padded LCPs (see bpp_compact_cap);
    # a capped-out/failed solve falls through the cascade below
    import os

    # chosen on the arm MPC sweep before the GPU port (not yet measured on
    # the GPU): 12 beat 8 (fails too often -> deeper stages fire) and 16/24
    # (lock-step iterations waste); stage-2's regularized BPP catches what
    # 12 iterations can't
    bpp_iters = int(os.environ.get("MOBY_MPC_BPP_ITERS", "12"))
    z_bp, ok_bp = lcp_mod.lcp_bpp(
        M, q, mask, z0=z0, skip=skip, max_iters=bpp_iters,
        na_cap=lcp_mod.bpp_compact_cap(q.shape[-1]) if lcp_mod._use_gj(dtype)
        else None,
    )
    ok_bp = ok_bp & lcp_mod._verify(Mp, qp, z_bp, mask, check_tol)
    # stage 2: single-λ Tikhonov BPP. Degenerate active sets (the routine
    # failure of the rank-deficient impact LCPs) become strictly monotone
    # under M+λI, where BPP converges in a handful of iterations;
    # acceptance verifies against the REGULARIZED problem, exactly as the
    # reference's regularized wrappers do (src/LCP.cpp:239-260). This
    # stage is ~100x shallower than the full Tikhonov/lcp_fast sweep that
    # otherwise fires lock-step across the batch on every degenerate step.
    # stage-2 regularizer: 10·sqrt(eps)·|M| (MOBY_MPC_LAM_SCALE overrides
    # the 10). Chosen on the arm real-hull workload before the GPU port
    # (not yet measured on the GPU): at 1.0 the near-coplanar 4-point wrist
    # manifolds still failed the regularized BPP and the full Tikhonov
    # rescue fired lock-step every sweep; at 10 stage 2 absorbed them with
    # member costs unchanged to 0.5% and a CPU f64 oracle mean within 5%.
    # Within the reference's own expanding Tikhonov sweep range
    # (lcp_*_regularized, src/LCP.cpp:353-487).
    lam_scale = float(os.environ.get("MOBY_MPC_LAM_SCALE", "10.0"))
    lam = (
        jnp.asarray(
            lam_scale * np.sqrt(np.finfo(np.dtype(dtype)).eps), dtype)
        * lcp_mod._masked_norm_inf(Mp, mask)
    )
    n = q.shape[-1]
    if os.environ.get("MOBY_MPC_STAGE2", "1") != "0":
        Mreg = Mp + lam * jnp.eye(n, dtype=dtype) * mask.astype(dtype)
        z_rg, ok_rg = lcp_mod.lcp_bpp(Mreg, qp, mask, z0=z0,
                                      skip=skip | ok_bp, max_iters=bpp_iters)
        ok_rg = ok_rg & lcp_mod._verify(Mreg, qp, z_rg, mask, check_tol)
        ok_2 = ok_bp | ok_rg
        z = jnp.where(ok_bp, z_bp, z_rg)
    else:
        ok_2 = ok_bp
        z = z_bp
    # stages 3..: shallow Tikhonov LADDER of regularized BPPs, shaped by
    # stage accounting of the arm MPC sweep before the GPU port
    # (scripts/ur10_cascade_ab.py; not yet measured on the GPU): there the
    # full-depth `lcp_fast` stage rescued almost no member, and the
    # Tikhonov/lcp_fast sweep took most of the rollout while firing for
    # about a third of members. Each ladder rung is one λ-regularized
    # 12-iter BPP, with λ growing geometrically — the same expanding-λ
    # acceptance semantics as
    # the reference's regularized wrappers (src/LCP.cpp:353-487: accept the
    # first λ whose REGULARIZED solution verifies), but with the shallow
    # block-pivoting inner solver instead of O(n) Murty pivot chains.
    ladder = os.environ.get("MOBY_MPC_LADDER", "30,1000")
    for mult_s in [m for m in ladder.split(",") if m]:
        mult = float(mult_s)
        lam_i = lam * jnp.asarray(mult, dtype)
        Mreg_i = Mp + lam_i * jnp.eye(n, dtype=dtype) * mask.astype(dtype)
        z_i, ok_i = lcp_mod.lcp_bpp(Mreg_i, qp, mask, z0=z0,
                                    skip=skip | ok_2, max_iters=bpp_iters)
        ok_i = ok_i & lcp_mod._verify(Mreg_i, qp, z_i, mask, check_tol)
        z = jnp.where(ok_2, z, z_i)
        ok_2 = ok_2 | ok_i
    ok12 = ok_2
    # final safety net: the production Tikhonov/lcp_fast sweep. With the
    # ladder in front it fires ~never (all-skip => its while_loop exits at
    # the first cond check), but keeps worst-case robustness identical to
    # the reference cascade. MOBY_MPC_RESCUE=0 disables (debug).
    if os.environ.get("MOBY_MPC_RESCUE", "1") != "0":
        z3, ok3 = lcp_mod.lcp_fast_regularized(M, q, mask, z0=z0,
                                               skip=ok12 | skip)
        z = jnp.where(ok12, z, z3)
        ok = ok12 | ok3
    else:
        ok = ok12
    # every stage failed: poison instead of returning a non-solution as if
    # it converged — NaN states make the iLQR line search reject the
    # rollout (and the failure visible), where finite garbage impulses
    # would silently corrupt the optimum
    z = jnp.where(ok | skip, z, jnp.full_like(z, jnp.nan))
    return z, ok


def _fwd_mpc(M, q, mask, z0, skip):
    z = solve_lcp_diff_mpc(M, q, mask, z0, skip)
    active, Ainv_T = _prep_bwd(M, z, mask)
    return z, (active, Ainv_T, z)


def _bwd_mpc(res, zbar):
    active, Ainv_T, z = res
    Mbar, qbar = _ift_bwd(active, Ainv_T, z, zbar)
    return Mbar, qbar, None, None, None


solve_lcp_diff_mpc.defvjp(_fwd_mpc, _bwd_mpc)


@jax.custom_vjp
def solve_lcp_given(M, q, mask, z):
    """Replay a known LCP solution with the same IFT gradients as the live
    solves above.

    The iLQR backward pass linearizes the dynamics at states the accepted
    rollout ALREADY stepped through — the rollout's pivoting solve (BPP
    while-loop over n-step Gauss–Jordan eliminations) produced z there, and
    re-running it under `jacrev` was pure sequential-depth waste (the ur10
    MPC sweep is dispatch-bound at <10% device duty). The primal here just
    returns the recorded z; the VJP is the identical `_ift_bwd` pullback
    evaluated at it. z is treated as non-differentiable data (its cotangent
    is dropped), exactly as the live solvers expose gradients only through
    (M, q).
    """
    return z


def _fwd_given(M, q, mask, z):
    active, Ainv_T = _prep_bwd(M, z, mask)
    return z, (active, Ainv_T, z)


def _bwd_given(res, zbar):
    active, Ainv_T, z = res
    Mbar, qbar = _ift_bwd(active, Ainv_T, z, zbar)
    return Mbar, qbar, None, None


solve_lcp_given.defvjp(_fwd_given, _bwd_given)


@jax.custom_jvp
def solve_lcp_given_fwd(M, q, mask, z):
    """Forward-mode (`jacfwd`) twin of :func:`solve_lcp_given`.

    Same primal (return the recorded solution) and the same IFT derivative,
    expressed as a JVP: on the active set A,

        dz_A = -M_AA^{-1} (dM_A: z + dq_A),   dz_{A^c} = 0.

    Why it exists: `jacrev` through the replay step drags the whole step
    graph through JAX's transpose machinery — transposed layouts,
    data-formatting copies and `add_any` accumulation chains in the
    (tiny-op, latency-bound) MPC backward sweep.
    `jacfwd` pushes the 19 tangent basis vectors through the natural forward
    graph instead: no transposes, no cotangent accumulation. Under `jacfwd`'s
    vmap the primal operands stay unbatched, so the masked inverse here is
    still computed ONCE per step, with each tangent a matvec against it —
    identical arithmetic to the reverse pullback, minus the layout churn.

    z is data (its tangent is ignored), exactly as the VJP drops z's
    cotangent.
    """
    return z


@solve_lcp_given_fwd.defjvp
def _jvp_given(primals, tangents):
    M, q, mask, z = primals
    dM, dq, _, _ = tangents
    active, Ainv = _prep_bwd(M, z, mask, transpose=False)
    rhs = jnp.einsum("ij,j->i", dM, z) + dq
    rhs = jnp.where(active, rhs, jnp.zeros_like(rhs))
    if isinstance(Ainv, tuple):
        inv_c, P = Ainv
        dz = -(P.T @ (inv_c @ (P @ rhs)))
    else:
        dz = -(Ainv @ rhs)
    dz = jnp.where(active, dz, jnp.zeros_like(dz))
    return z, dz
