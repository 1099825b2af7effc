"""iLQR trajectory optimizer over the differentiable contact dynamics.

The contact-MPC outer loop of the north star (BASELINE.json): iterative LQR
with Jacobians obtained by reverse-mode AD through `mpc.diffstep` (contact
LCP included, via the IFT custom VJP), Riccati backward recursion with
Levenberg-style regularization, and a backtracking forward line search.

Everything is pure JAX: one `ilqr` call jits whole; batching scenarios is
`vmap`; sharding across chips is `shard_map` over the scenario axis
(see parallel.mesh).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# unroll factor for the Riccati backward scan of the batched iLQR. Its body
# is tiny-op latency-bound with no inner while loops; unrolling amortizes
# scan bookkeeping and lets XLA fuse across steps (measured +4.5% on the
# ball-push sweep at 2; the forward rollout scans contain the LCP pivot
# while-loops and measured SLOWER unrolled, so they stay at 1).
import os as _os

_SCAN_UNROLL = int(_os.environ.get("MOBY_MPC_SCAN_UNROLL", "2"))


class ILQRResult(NamedTuple):
    us: jnp.ndarray       # (H, nu) optimized controls
    xs: jnp.ndarray       # (H+1, nx) optimized trajectory
    cost: jnp.ndarray     # () final cost
    n_iters: jnp.ndarray


def _pd_inverse(M):
    """(Minv, pd_ok) for the Riccati Quu solve.

    f32 (the accelerator execution dtype) routes through the fused
    Gauss–Jordan with the signed-pivot PD check instead of the Cholesky +
    LU custom-calls XLA otherwise emits, which a profile of the MPC sweep
    found dominant before the GPU port (not yet measured on the GPU).
    f64 (CPU regression mode) keeps the LAPACK pair.
    """
    if jnp.dtype(M.dtype) == jnp.float32:
        from ..solvers.lcp import gj_invert_pd

        return gj_invert_pd(M)
    L = jnp.linalg.cholesky(M)
    ok = jnp.all(jnp.isfinite(L.reshape(M.shape[:-2] + (-1,))), axis=-1)
    return jnp.linalg.inv(M), ok


def _rollout(f, x0, us):
    def step(x, u):
        x2 = f(x, u)
        return x2, x2

    _, xs = jax.lax.scan(step, x0, us)
    return jnp.concatenate([x0[None], xs], axis=0)


def _total_cost(cost, cost_final, xs, us):
    c = jax.vmap(cost)(xs[:-1], us).sum()
    return c + cost_final(xs[-1])


def ilqr(
    f: Callable,
    cost: Callable,
    cost_final: Callable,
    x0: jnp.ndarray,
    us0: jnp.ndarray,
    n_iters: int = 10,
    mu_init: float = 1e-6,
    line_search_steps: int = 8,
    parallel_line_search: bool = True,
) -> ILQRResult:
    """Minimize sum cost(x,u) + cost_final(xT) subject to x' = f(x, u).

    f: (nx,), (nu,) -> (nx,) — differentiable dynamics.

    `parallel_line_search` evaluates all step sizes as one batched rollout
    (sequential depth H instead of steps*H) — the right default for small
    scenario batches where the chip is latency-bound. For large vmapped
    batches the alpha fan-out multiplies the working set by
    `line_search_steps`; pass False there to evaluate alphas sequentially
    (identical accept-first-improving semantics either way).
    """
    H, nu = us0.shape
    nx = x0.shape[0]
    dtype = x0.dtype

    # one jacrev over both args: a single forward trace and a single
    # nx-wide pullback sweep yields A and B together (two separate jacrev
    # calls each re-run the contact-step forward pass and its own sweep)
    fxu_fn = jax.jacrev(f, argnums=(0, 1))
    cx_fn = jax.grad(cost, argnums=0)
    cu_fn = jax.grad(cost, argnums=1)
    cxx_fn = jax.hessian(cost, argnums=0)
    cuu_fn = jax.hessian(cost, argnums=1)
    cux_fn = jax.jacrev(jax.grad(cost, argnums=1), argnums=0)
    vx_fn = jax.grad(cost_final)
    vxx_fn = jax.hessian(cost_final)

    def backward(xs, us, mu):
        Vx = vx_fn(xs[-1])
        Vxx = vxx_fn(xs[-1])

        def bstep(carry, inp):
            # Jacobians are computed inside the scan step (never materialized
            # as (H, nx, nx) stacks — the on-chip memory blow-up that made
            # vmapped iLQR regress at large B)
            Vx, Vxx, ok, dv1, dv2 = carry
            x_k, u_k = inp
            A_k, B_k = fxu_fn(x_k, u_k)
            Qx = cx_fn(x_k, u_k) + A_k.T @ Vx
            Qu = cu_fn(x_k, u_k) + B_k.T @ Vx
            Qxx = cxx_fn(x_k, u_k) + A_k.T @ Vxx @ A_k
            Quu = cuu_fn(x_k, u_k) + B_k.T @ Vxx @ B_k
            Qux = cux_fn(x_k, u_k) + B_k.T @ Vxx @ A_k
            Quu_reg = Quu + mu * jnp.eye(nu, dtype=dtype)
            # PD check + inverse in one fused elimination; a failed step
            # poisons `ok` and the iteration retries at higher mu
            Quu_inv, ok_k = _pd_inverse(Quu_reg)
            k = -Quu_inv @ Qu
            K = -Quu_inv @ Qux
            Vx2 = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
            Vxx2 = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx2 = 0.5 * (Vxx2 + Vxx2.T)
            ok_k = ok_k & jnp.all(jnp.isfinite(k)) & jnp.all(jnp.isfinite(K))
            # expected cost change at alpha=1 (iLQG model decrease), used by
            # `iteration` to detect convergence — same rule as ilqr_batched
            dv1_k = k @ Qu
            dv2_k = k @ Quu @ k
            return (Vx2, Vxx2, ok & ok_k, dv1 + dv1_k, dv2 + dv2_k), (k, K)

        (_, _, ok, dv1, dv2), (ks, Ks) = jax.lax.scan(
            bstep,
            (Vx, Vxx, jnp.array(True), jnp.zeros((), dtype), jnp.zeros((), dtype)),
            (xs[:-1], us),
            reverse=True,
        )
        expected = -(dv1 + 0.5 * dv2)
        return ks, Ks, ok, expected

    def forward(xs, us, ks, Ks, alpha):
        def fstep(x, inp):
            x_ref, u_ref, k, K = inp
            u = u_ref + alpha * k + K @ (x - x_ref)
            x2 = f(x, u)
            return x2, (x2, u)

        _, (xs2, us2) = jax.lax.scan(fstep, xs[0], (xs[:-1], us, ks, Ks))
        xs2 = jnp.concatenate([xs[0][None], xs2], axis=0)
        return xs2, us2

    # cost sums H stage terms -> rounding scale ~sqrt(H)·eps·(1+|cost|);
    # the mu-floor gate stops a mu-inflated (shrunken) model decrease from
    # masquerading as convergence — same rule as ilqr_batched
    conv_tol = float(8.0 * np.sqrt(H) * np.finfo(np.dtype(dtype)).eps)

    def iteration(carry, _):
        xs, us, cost_prev, mu = carry
        ks, Ks, ok, expected = backward(xs, us, mu)
        # converged: the model-predicted decrease at alpha=1 is at rounding
        # scale — keep the trajectory, count the iteration as accepted
        # (identical rule to ilqr_batched, where it stops converged members
        # from forcing the batch vote through every alpha)
        converged = ok & (expected >= 0) & (
            expected <= conv_tol * (1.0 + jnp.abs(cost_prev))
        ) & (mu <= 10 * mu_init)

        # evaluate every line-search step size in parallel (a batched rollout
        # over the alpha axis) instead of sequentially: the forward rollout is
        # the sequential-depth bottleneck of an iLQR iteration, and the
        # backtracking scan evaluated all alphas unconditionally anyway.
        # Accept the first (largest) alpha that improves the cost — identical
        # to the backtracking rule.
        alphas = 1.1 ** (-jnp.arange(line_search_steps, dtype=dtype) ** 2)
        if parallel_line_search:
            xs_all, us_all = jax.vmap(
                lambda a: forward(xs, us, ks, Ks, a)
            )(alphas)
            c_all = jax.vmap(
                lambda x, u: _total_cost(cost, cost_final, x, u)
            )(xs_all, us_all)
            # a failed backward pass (non-PD Quu at the current mu) rejects
            # the whole update: mu escalates below and the iteration retries
            better = (c_all < cost_prev) & ok & jnp.isfinite(c_all) & ~converged
            first = jnp.argmax(better)  # first improving alpha (largest step)
            has_alpha = jnp.any(better)
            sel = jnp.where(has_alpha, first, 0)
            c_new = jnp.where(has_alpha, c_all[sel], cost_prev)
            xs_new = jnp.where(has_alpha, xs_all[sel], xs)
            us_new = jnp.where(has_alpha, us_all[sel], us)
            improved = has_alpha | converged
        else:
            def try_alpha(carry2, alpha):
                best_cost, best_xs, best_us, found = carry2
                xs2, us2 = forward(xs, us, ks, Ks, alpha)
                c2 = _total_cost(cost, cost_final, xs2, us2)
                better = (c2 < best_cost) & ~found & ok & jnp.isfinite(c2)
                return (
                    jnp.where(better, c2, best_cost),
                    jnp.where(better, xs2, best_xs),
                    jnp.where(better, us2, best_us),
                    found | better,
                ), None

            (c_new, xs_new, us_new, improved), _ = jax.lax.scan(
                try_alpha, (cost_prev, xs, us, converged), alphas
            )
        mu_new = jnp.where(improved, jnp.maximum(mu / 2, 1e-8), mu * 10)
        return (xs_new, us_new, c_new, mu_new), c_new

    xs0 = _rollout(f, x0, us0)
    c0 = _total_cost(cost, cost_final, xs0, us0)
    (xs, us, c, _), _ = jax.lax.scan(
        iteration, (xs0, us0, c0, jnp.asarray(mu_init, dtype)), None,
        length=n_iters,
    )
    return ILQRResult(us=us, xs=xs, cost=c, n_iters=jnp.array(n_iters))


def ilqr_batched(
    f: Callable,
    cost: Callable,
    cost_final: Callable,
    x0s: jnp.ndarray,
    us0: jnp.ndarray,
    n_iters: int = 10,
    mu_init: float = 1e-6,
    line_search_steps: int = 8,
    f_record: Callable | None = None,
    f_replay: Callable | None = None,
    hoist_linearization: bool = False,
    riccati_bf16: bool = False,
    linearize_fwd: bool = False,
) -> ILQRResult:
    """Batch-level iLQR: like vmap(ilqr) but with a batch-voted early-exit
    backtracking line search.

    Under `vmap(ilqr)` the 8-alpha backtracking scan evaluates EVERY alpha
    for every member (lock-step); near convergence almost every member
    accepts alpha = 1, so ~7/8 of the line-search rollouts are waste — and
    the line search is most of an iteration's rollout work. Here the batch
    axis is explicit: a `lax.while_loop` walks alphas largest-first and
    exits as soon as every member has found an improving step (identical
    accept-first-improving semantics per member; members that already
    accepted stop updating).

    f/cost/cost_final are per-scenario functions (vmapped internally);
    x0s (B, nx); us0 (B, H, nu) or (H, nu) broadcast.

    Record/replay (optional): f_record(x, u, aux) -> (x', z, aux') runs
    the same step warm-started by the scan-carried aux (the previous
    step's (zlast, zlast_active) — the reference's own warm-start
    machinery) and returns the contact-solve solution z actually applied;
    f_record.aux_init() gives the cold aux for step 0. f_replay(x, u, z)
    -> x' replays z with identical primal and IFT gradients but no pivot
    loops. The backward pass then linearizes through f_replay at the
    rollout's own solutions — removing the LCP while-loops from the
    (dispatch-bound) backward sweep.

    hoist_linearization: compute all H step Jacobians in ONE (B·H)-batched
    jacrev before the Riccati scan instead of inside it. Turns ~H
    sequential small pullback graphs into a handful of large batched ops —
    a large win when the per-step graph is dispatch-bound (articulated
    scenes); measured slower for the tiny ball-push step, so off by
    default.

    riccati_bf16: run the quadratic-form einsums of the Riccati recursion
    (AᵀVA, BᵀVB, BᵀVA, gain applications) in bfloat16 with f32
    accumulation. The recursion feeds a line-searched descent direction,
    so reduced precision costs at most extra line-search/µ retries, never
    wrong physics; halves the HBM traffic of the backward sweep.

    linearize_fwd (requires record/replay): compute the step Jacobians with
    `jacfwd` through the custom-JVP replay step instead of `jacrev`. The
    step has nx+nu≈nx inputs and nx outputs, so the tangent fan-out costs
    the same flops — but forward mode keeps the natural op layouts where
    reverse mode drags every op through transpose machinery (5-D transposed
    tensors, data-formatting copies, `add_any` chains: measured ~45% of
    ball-push backward-sweep device time).
    """
    B, nx = x0s.shape
    if us0.ndim == 2:
        us0 = jnp.broadcast_to(us0[None], (B,) + us0.shape)
    H, nu = us0.shape[1:]
    dtype = x0s.dtype

    rr = f_record is not None and f_replay is not None
    if linearize_fwd and not (rr and getattr(f_replay, "fwd", None)):
        raise ValueError(
            "linearize_fwd needs record/replay with a custom-JVP replay "
            "step (f_replay.fwd); the live pivoting solve is custom_vjp "
            "and cannot be forward-differentiated")

    fB = jax.vmap(f)
    fB_rec = jax.vmap(f_record) if rr else None
    costB = jax.vmap(cost)
    cost_finalB = jax.vmap(cost_final)

    if rr and linearize_fwd and getattr(f_replay, "jac", None) is not None:
        # block-sparse analytic-chain Jacobian (see contact_mpc.f_jac):
        # pose-only tangents through the geometry graph, velocity tangents
        # through the LCP-rhs path, chained with small matmuls
        fxu_fn = jax.vmap(f_replay.jac)
    elif rr and linearize_fwd:
        fxu_fn = jax.vmap(jax.jacfwd(f_replay.fwd, argnums=(0, 1)))
    elif rr:
        fxu_fn = jax.vmap(jax.jacrev(f_replay, argnums=(0, 1)))
    else:
        fxu_fn = jax.vmap(jax.jacrev(f, argnums=(0, 1)))
    cx_fn = jax.vmap(jax.grad(cost, argnums=0))
    cu_fn = jax.vmap(jax.grad(cost, argnums=1))
    cxx_fn = jax.vmap(jax.hessian(cost, argnums=0))
    cuu_fn = jax.vmap(jax.hessian(cost, argnums=1))
    cux_fn = jax.vmap(jax.jacrev(jax.grad(cost, argnums=1), argnums=0))
    vx_fn = jax.vmap(jax.grad(cost_final))
    vxx_fn = jax.vmap(jax.hessian(cost_final))

    def aux0():
        return jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape),
            f_record.aux_init(),
        )

    def rollout(x0s_, uss):
        """-> (xss (B,H+1,nx), zss (B,H,nz) or None)"""
        if rr:
            def step(carry, u):
                x, aux = carry
                x2, z, aux2 = fB_rec(x, u, aux)
                return (x2, aux2), (x2, z)

            _, (xs, zs) = jax.lax.scan(
                step, (x0s_, aux0()), jnp.swapaxes(uss, 0, 1))
            xss = jnp.concatenate(
                [x0s_[:, None], jnp.swapaxes(xs, 0, 1)], axis=1)
            return xss, jnp.swapaxes(zs, 0, 1)

        def step(x, u):
            x2 = fB(x, u)
            return x2, x2

        _, xs = jax.lax.scan(step, x0s_, jnp.swapaxes(uss, 0, 1))
        return (
            jnp.concatenate([x0s_[:, None], jnp.swapaxes(xs, 0, 1)], axis=1),
            None,
        )

    def total_cost(xss, uss):
        cs = jax.vmap(
            lambda xs, us: jax.vmap(cost)(xs[:-1], us).sum() + cost_final(xs[-1])
        )(xss, uss)
        return cs  # (B,)

    def backward(xss, uss, zss, mus):
        Vx = vx_fn(xss[:, -1])
        Vxx = vxx_fn(xss[:, -1])
        eye = jnp.eye(nu, dtype=dtype)

        hoisted = None
        if hoist_linearization:
            # one (B·H)-batched jacrev for every step Jacobian at once:
            # the Riccati scan below then runs only the tiny recursions
            xf = xss[:, :-1].reshape(B * H, nx)
            uf = uss.reshape(B * H, nu)
            if rr:
                zf = zss.reshape(B * H, zss.shape[-1])
                if linearize_fwd and getattr(f_replay, "jac", None):
                    jac = f_replay.jac
                elif linearize_fwd:
                    jac = jax.jacfwd(f_replay.fwd, argnums=(0, 1))
                else:
                    jac = jax.jacrev(f_replay, argnums=(0, 1))
                A_f, B_f = jax.vmap(jac)(xf, uf, zf)
            else:
                A_f, B_f = jax.vmap(jax.jacrev(f, argnums=(0, 1)))(xf, uf)
            hoisted = (
                jnp.swapaxes(A_f.reshape(B, H, nx, nx), 0, 1),
                jnp.swapaxes(B_f.reshape(B, H, nx, nu), 0, 1),
            )

        def bstep(carry, inp):
            Vx, Vxx, ok, dv1, dv2 = carry
            if hoist_linearization:
                x_k, u_k, A_k, B_k = inp
            elif rr:
                x_k, u_k, z_k = inp
                A_k, B_k = fxu_fn(x_k, u_k, z_k)
            else:
                x_k, u_k = inp          # (B, nx), (B, nu)
                A_k, B_k = fxu_fn(x_k, u_k)
            # fused quadratic expansion: with F = [A B] (B, nx, nx+nu) the
            # three Q-blocks come from ONE congruence FᵀVF and both gradient
            # rows from ONE FᵀVx — the MPC sweep is tiny-op latency-bound,
            # so 18 small einsums collapsed to 7 is wall-clock, not style
            F = jnp.concatenate([A_k, B_k], axis=2)        # (B, nx, nx+nu)
            if riccati_bf16:
                bf = jnp.bfloat16
                F_q, V_q = F.astype(bf), Vxx.astype(bf)
                qf = dict(preferred_element_type=dtype)
            else:
                F_q, V_q = F, Vxx
                qf = {}
            FtV = jnp.einsum("bji,bj->bi", F, Vx)          # [AᵀVx; BᵀVx]
            G = jnp.einsum("bji,bjk,bkl->bil", F_q, V_q, F_q, **qf)
            Qx = cx_fn(x_k, u_k) + FtV[:, :nx]
            Qu = cu_fn(x_k, u_k) + FtV[:, nx:]
            Qxx = cxx_fn(x_k, u_k) + G[:, :nx, :nx]
            Quu = cuu_fn(x_k, u_k) + G[:, nx:, nx:]
            Qux = cux_fn(x_k, u_k) + G[:, nx:, :nx]
            Quu = 0.5 * (Quu + jnp.swapaxes(Quu, -1, -2))
            Quu_reg = Quu + mus[:, None, None] * eye[None]
            Quu_inv, ok_k = _pd_inverse(Quu_reg)
            # gains + value recursion through stacked [k K] = -Quu⁻¹ [Qu Qux]
            W = jnp.concatenate([Qu[:, :, None], Qux], axis=2)  # (B,nu,1+nx)
            kK = -jnp.einsum("bij,bjk->bik", Quu_inv, W)
            k = kK[:, :, 0]
            K = kK[:, :, 1:]
            T1 = jnp.einsum("bji,bjk->bik", kK, W)          # kKᵀ[Qu Qux]
            T2 = jnp.einsum("bji,bjk->bik", kK,
                            jnp.einsum("bij,bjk->bik", Quu, kK))
            Vx2 = Qx + T2[:, 1:, 0] + T1[:, 1:, 0] + T1[:, 0, 1:]
            Vxx2 = Qxx + T2[:, 1:, 1:] + T1[:, 1:, 1:] + jnp.swapaxes(
                T1[:, 1:, 1:], -1, -2)
            Vxx2 = 0.5 * (Vxx2 + jnp.swapaxes(Vxx2, -1, -2))
            # expected cost change at alpha=1: sum_k k.Qu + 1/2 k.Quu.k
            # (the standard iLQG model decrease — used to detect converged
            # members so they don't drive the batch line-search vote).
            # Direct small einsums: slicing T1/T2[0,0] made XLA re-read the
            # whole (1+nx,1+nx) products for two scalars.
            dv1_k = jnp.einsum("bi,bi->b", k, Qu)
            dv2_k = jnp.einsum("bi,bij,bj->b", k, Quu, k)
            # finite-ness is checked on (B,) scalars instead of an
            # elementwise reduce over k/K (the explicit (B, nu, nx)
            # jnp.all(isfinite(K)) was 4% of sweep device time). dv1/dv2
            # only touch k, so a NaN confined to K (e.g. NaN Qux with
            # finite Qu/Quu) would pass them — the kK einsum-sum folds K
            # into one scalar per member so that case poisons ok_k too
            # (ADVICE r4: at the earliest timestep there is no later
            # Vx2 step to catch it).
            kK_sum = jnp.einsum("bij->b", kK)
            ok_k = (ok_k & jnp.isfinite(dv1_k) & jnp.isfinite(dv2_k)
                    & jnp.isfinite(kK_sum))
            return (Vx2, Vxx2, ok & ok_k, dv1 + dv1_k, dv2 + dv2_k), (k, K)

        inputs = [
            jnp.swapaxes(xss[:, :-1], 0, 1), jnp.swapaxes(uss, 0, 1)]
        if hoist_linearization:
            inputs += list(hoisted)
        elif rr:
            inputs.append(jnp.swapaxes(zss, 0, 1))
        (_, _, ok, dv1, dv2), (ks, Ks) = jax.lax.scan(
            bstep,
            (Vx, Vxx, jnp.ones(B, bool), jnp.zeros(B, dtype), jnp.zeros(B, dtype)),
            tuple(inputs),
            reverse=True,
            unroll=_SCAN_UNROLL,
        )
        expected = -(dv1 + 0.5 * dv2)  # positive when alpha=1 should improve
        # ks: (H, B, nu) -> (B, H, nu)
        return jnp.swapaxes(ks, 0, 1), jnp.swapaxes(Ks, 0, 1), ok, expected

    def forward(xss, uss, ks, Ks, alpha):
        """-> (xs2, us2, zs2 or None): controller rollout, recording the
        contact solutions when record/replay is active."""
        def fstep(carry, inp):
            x, aux = carry
            x_ref, u_ref, k, K = inp
            u = u_ref + alpha * k + jnp.einsum("bij,bj->bi", K, x - x_ref)
            if rr:
                x2, z, aux2 = fB_rec(x, u, aux)
                return (x2, aux2), (x2, u, z)
            x2 = fB(x, u)
            return (x2, aux), (x2, u, jnp.zeros((B, 0), dtype))

        _, (xs2, us2, zs2) = jax.lax.scan(
            fstep,
            (xss[:, 0], aux0() if rr else jnp.zeros((B, 0), dtype)),
            (
                jnp.swapaxes(xss[:, :-1], 0, 1),
                jnp.swapaxes(uss, 0, 1),
                jnp.swapaxes(ks, 0, 1),
                jnp.swapaxes(Ks, 0, 1),
            ),
        )
        xs2 = jnp.concatenate(
            [xss[:, :1], jnp.swapaxes(xs2, 0, 1)], axis=1)
        return (
            xs2,
            jnp.swapaxes(us2, 0, 1),
            jnp.swapaxes(zs2, 0, 1) if rr else None,
        )

    alphas = 1.1 ** (-jnp.arange(line_search_steps, dtype=dtype) ** 2)

    # cost is a sum over H stage terms, so its rounding scale is
    # ~sqrt(H)·eps·(1+|cost|); 8x headroom keeps the gate robust to the
    # model-decrease estimate itself being noisy at that scale
    conv_tol = float(8.0 * np.sqrt(H) * np.finfo(np.dtype(dtype)).eps)

    def iteration(carry, _):
        xss, uss, zss, cost_prev, mus = carry
        ks, Ks, ok, expected = backward(xss, uss, zss, mus)

        # a member whose model-predicted decrease at alpha=1 is at rounding
        # scale is converged: no alpha can STRICTLY improve its cost, so
        # without this it would force the batch vote through every alpha
        # (the whole-batch lock-step worst case) while changing nothing.
        # Guard against a mu-inflated `expected` masquerading as converged:
        # only members whose regularizer sits at/near its floor qualify
        # (a large mu shrinks k and hence the predicted decrease).
        converged = ok & (expected >= 0) & (
            expected <= conv_tol * (1.0 + jnp.abs(cost_prev))
        ) & (mus <= 10 * mu_init)

        def ls_cond(c):
            k_i, found, _, _, _, _ = c
            return (k_i < line_search_steps) & ~jnp.all(found)

        def ls_body(c):
            k_i, found, bx, bu, bz, bc = c
            xs2, us2, zs2 = forward(xss, uss, ks, Ks, alphas[k_i])
            c2 = total_cost(xs2, us2)
            better = (c2 < cost_prev) & ok & jnp.isfinite(c2) & ~found
            bx = jnp.where(better[:, None, None], xs2, bx)
            bu = jnp.where(better[:, None, None], us2, bu)
            if rr:
                bz = jnp.where(better[:, None, None], zs2, bz)
            bc = jnp.where(better, c2, bc)
            return k_i + 1, found | better, bx, bu, bz, bc

        _, found, xs_new, us_new, zs_new, c_new = jax.lax.while_loop(
            ls_cond, ls_body,
            (jnp.int32(0), converged, xss, uss, zss, cost_prev),
        )
        mus_new = jnp.where(found, jnp.maximum(mus / 2, 1e-8), mus * 10)
        return (xs_new, us_new, zs_new, c_new, mus_new), None

    xss0, zss0 = rollout(x0s, us0)
    if not rr:
        zss0 = jnp.zeros((B, H, 0), dtype)
    c0 = total_cost(xss0, us0)
    (xss, uss, _, cs, _), _ = jax.lax.scan(
        iteration,
        (xss0, us0, zss0, c0, jnp.full(B, mu_init, dtype)),
        None,
        length=n_iters,
    )
    return ILQRResult(us=uss, xs=xss, cost=cs, n_iters=jnp.array(n_iters))
