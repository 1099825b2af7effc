"""Batched, fixed-shape LCP solvers.

Finds z >= 0 with w = M z + q >= 0 and z'w = 0.

Two algorithms mirroring the reference's numerical core (`src/LCP.cpp`):

* :func:`lcp_fast` — principal pivoting method ("PPM I", reference
  src/LCP.cpp:41-196) for monotone LCPs; supports warm starting from a
  previous solution (basis seeded from nonzero entries).
* :func:`lcp_lemke` — Lemke's algorithm with covering vector on the negative
  components (reference src/LCP.cpp:545-1003); the robust fallback.
* :func:`lcp_fast_regularized` / :func:`lcp_lemke_regularized` — Tikhonov
  sweeps λ = 10^k over an exponent range with solution verification
  (reference src/LCP.cpp:212-353, 353-487).

Accelerator design: everything is fixed-shape and mask-padded so it `vmap`s
over thousands of independent contact problems and `jit`s whole. A problem of
true size m lives in an n-slot padded system; padded slots carry M_ii = 1,
q_i = +1 which keeps them inert in every pivot rule (their w stays positive,
their z stays zero). Dynamic pivoting is a `lax.while_loop` with the same
iteration caps as the reference (2m for PPM, min(1000, 50m) for Lemke).
Each pivot re-solves the basis system densely (LU), exactly like the
reference's `solve_fast`; basis bookkeeping is done with masks instead of
index vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _masked_norm_inf(M, mask):
    """inf-norm (max abs row sum) over the active submatrix."""
    outer = mask[:, None] & mask[None, :]
    rows = jnp.sum(jnp.abs(jnp.where(outer, M, 0.0)), axis=1)
    return jnp.max(jnp.where(mask, rows, 0.0))


def pad_lcp(M, q, mask):
    """Make padded slots inert: M_ii = 1 on the diagonal, q_i = +1."""
    n = q.shape[0]
    outer = mask[:, None] & mask[None, :]
    Mp = jnp.where(outer, M, 0.0) + jnp.diag(jnp.where(mask, 0.0, 1.0).astype(M.dtype))
    qp = jnp.where(mask, q, 1.0)
    return Mp, qp


def gj_solve_masked(A, b, active):
    """Solve the `active`-masked system A x = b by unpivoted Gauss–Jordan.

    A must already be the masked system (identity rows/cols on inactive
    slots). The masked systems of the principal-pivoting sub-solves are
    principal submatrices of the QP KKT-LCP matrix, whose symmetric part is
    PSD — elimination without pivoting is then Cholesky-grade stable, and a
    (near-)singular submatrix surfaces as a vanishing pivot, which we report
    via `ok` exactly like the `isfinite` guard on the LAPACK path.

    Why not `jnp.linalg.solve`: this fixed-trip `fori_loop` of rank-1
    updates keeps every step a single fused elementwise+outer-product op that
    batches over vmap for free, where a small LU factorization lowers to a
    sequential pivoting loop, and the impact cascade's pivot chains stack
    dozens of them back-to-back. The choice predates the GPU port and is
    not yet measured on the GPU.

    Returns (x, ok).
    """
    n = b.shape[-1]
    dtype = A.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)

    def step(k, carry):
        A, b, minpiv = carry
        prow = A[..., k, :]
        pb = b[..., k]
        piv = prow[..., k]
        apiv = jnp.abs(piv)
        minpiv = jnp.minimum(minpiv, apiv)
        inv = jnp.where(apiv > tiny, 1.0 / jnp.where(apiv > tiny, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        pb = pb * inv
        col = A[..., :, k]
        factor = col * (1.0 - jax.nn.one_hot(k, n, dtype=dtype))
        A = A - factor[..., None] * prow[..., None, :]
        b = b - factor * pb[..., None]
        A = A.at[..., k, :].set(prow)
        b = b.at[..., k].set(pb)
        return A, b, minpiv

    minpiv0 = jnp.full(b.shape[:-1], jnp.inf, dtype)
    A, b, minpiv = jax.lax.fori_loop(0, n, step, (A, b, minpiv0))
    # inactive slots have unit pivots; a tiny pivot on an active row means the
    # masked system was singular
    ok = (minpiv > tiny) & jnp.all(jnp.isfinite(b), axis=-1)
    return b, ok


def _gj_invert_small(D):
    """(E, minpiv) for a small (…, bs, bs) block: unpivoted Gauss–Jordan
    with the same vanishing-pivot skip as `gj_solve_masked` (skipped rows of
    E are zero), carrying the identity. bs is static and tiny (panel width),
    so the loop unrolls into fused elementwise ops."""
    bs = D.shape[-1]
    dtype = D.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)
    E = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), D.shape)
    minpiv = jnp.full(D.shape[:-2], jnp.inf, dtype)
    for k in range(bs):
        prow = D[..., k, :]
        erow = E[..., k, :]
        piv = prow[..., k]
        apiv = jnp.abs(piv)
        minpiv = jnp.minimum(minpiv, apiv)
        inv = jnp.where(apiv > tiny,
                        1.0 / jnp.where(apiv > tiny, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        erow = erow * inv[..., None]
        col = D[..., :, k]
        factor = col * (1.0 - jax.nn.one_hot(k, bs, dtype=dtype))
        D = D - factor[..., None] * prow[..., None, :]
        E = E - factor[..., None] * erow[..., None, :]
        D = D.at[..., k, :].set(prow)
        E = E.at[..., k, :].set(erow)
    return E, minpiv


# static panel width of the blocked elimination (env-tunable for bench)
import os as _os

_GJ_BLOCK = int(_os.environ.get("MOBY_GJ_BLOCK", "8"))
# masked systems at least this large route through the blocked elimination
# (0 disables)
_GJ_BLOCK_MIN_N = int(_os.environ.get("MOBY_GJ_BLOCK_MIN_N", "32"))
# systems with more panels than this sweep them in a `fori_loop` instead of
# unrolling: the unrolled n=2560 pile LCP made an HLO module too large to
# compile within minutes
_GJ_UNROLL_PANELS = 16


def gj_solve_masked_blocked(A, b, active, bs: int = _GJ_BLOCK):
    """Blocked (panel) variant of `gj_solve_masked`: identical elimination
    order, but bs pivots are processed per sweep — the within-panel
    transform E comes from a tiny unrolled GJ and the trailing update is two
    matmuls. n sequential full-matrix rank-1 passes (memory-bandwidth-bound)
    become n/bs panel sweeps with matrix-product updates. Up to
    `_GJ_UNROLL_PANELS` panels unroll with static starts (the last panel
    may be narrower); larger systems are padded to a multiple of bs with
    identity rows and loop over the panels. (Chosen for the articulated
    impact LCPs before the GPU port; not yet measured on the GPU.)

    Equivalent to the unblocked elimination in exact arithmetic (Schur
    identity); vanishing-pivot rows are skipped inside the panel exactly as
    the unblocked route skips them, and `ok` reports the same min-pivot
    criterion. Returns (x, ok)."""
    n = b.shape[-1]
    dtype = A.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)

    def panel(carry, s, w):
        """Eliminate the w pivots starting at row s (s may be traced)."""
        A, b, minpiv = carry
        cut = lambda x, axis: jax.lax.dynamic_slice_in_dim(x, s, w, axis)
        put = lambda x, v, axis: jax.lax.dynamic_update_slice_in_dim(
            x, v, s, axis)
        rows = cut(A, -2)
        E, mp = _gj_invert_small(cut(rows, -1))
        minpiv = jnp.minimum(minpiv, mp)
        R = E @ rows                                # transformed panel rows
        bJ = jnp.einsum("...ij,...j->...i", E, cut(b, -1))
        # block rows are replaced, not updated: zero their factor
        C = put(cut(A, -1), jnp.zeros_like(E), -2)
        A = A - C @ R
        b = b - jnp.einsum("...ij,...j->...i", C, bJ)
        return put(A, R, -2), put(b, bJ, -1), minpiv

    n_panels = -(-n // bs)
    carry = (A, b, jnp.full(b.shape[:-1], jnp.inf, dtype))
    if n_panels <= _GJ_UNROLL_PANELS:
        for s in range(0, n, bs):
            carry = panel(carry, s, min(bs, n - s))
    else:
        pad = n_panels * bs - n
        if pad:
            lead = [(0, 0)] * (A.ndim - 2)
            A = jnp.pad(A, lead + [(0, pad), (0, pad)])
            A = A + jnp.diag(jnp.arange(n + pad) >= n).astype(dtype)
            carry = (A, jnp.pad(b, lead + [(0, pad)]), carry[2])
        carry = jax.lax.fori_loop(
            0, n_panels, lambda i, c: panel(c, i * bs, bs), carry)
    _, b, minpiv = carry
    b = b[..., :n]
    ok = (minpiv > tiny) & jnp.all(jnp.isfinite(b), axis=-1)
    return b, ok


def gj_invert_masked(A, active):
    """Invert the `active`-masked system (identity rows/cols on inactive
    slots) by the same unpivoted Gauss–Jordan as `gj_solve_masked`, carrying
    the identity through the row operations.

    Costs ~2x one `gj_solve_masked` and stays a fixed-trip `fori_loop` of
    fused rank-1 updates (no LU `While` lowering). Use when the same
    principal inverse is needed against many right-hand sides — e.g. the
    difflcp IFT pullback, where `jacrev`'s output-basis vmap would otherwise
    repeat the elimination once per basis vector. Returns (Ainv, ok).
    """
    n = A.shape[-1]
    dtype = A.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)
    B0 = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)

    def step(k, carry):
        A, B, minpiv = carry
        prow = A[..., k, :]
        brow = B[..., k, :]
        piv = prow[..., k]
        apiv = jnp.abs(piv)
        minpiv = jnp.minimum(minpiv, apiv)
        inv = jnp.where(apiv > tiny, 1.0 / jnp.where(apiv > tiny, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        brow = brow * inv[..., None]
        col = A[..., :, k]
        factor = col * (1.0 - jax.nn.one_hot(k, n, dtype=dtype))
        A = A - factor[..., None] * prow[..., None, :]
        B = B - factor[..., None] * brow[..., None, :]
        A = A.at[..., k, :].set(prow)
        B = B.at[..., k, :].set(brow)
        return A, B, minpiv

    minpiv0 = jnp.full(A.shape[:-2], jnp.inf, dtype)
    _, B, minpiv = jax.lax.fori_loop(0, n, step, (A, B0, minpiv0))
    ok = (minpiv > tiny) & jnp.all(
        jnp.isfinite(B), axis=(-2, -1)
    )
    return B, ok


_GJ_OVERRIDE = None  # set True/False to force the sub-solve route (benchmarks)


def _use_gj(dtype):
    """Route masked sub-solves through the fused Gauss–Jordan on f32 (the
    accelerator execution dtype); keep LAPACK LU on f64 (CPU regression
    mode)."""
    if _GJ_OVERRIDE is not None:
        return _GJ_OVERRIDE
    return jnp.dtype(dtype) == jnp.float32


def gj_invert_pd(A):
    """Batched inverse of symmetric matrices by unpivoted Gauss–Jordan with
    a positive-definiteness check: a symmetric matrix is PD iff every
    natural-order elimination pivot is positive (the Cholesky criterion).

    Replaces `jnp.linalg.cholesky` + `jnp.linalg.inv` pairs on the MPC hot
    path: they lower to factorization custom-calls, which a profile of the
    MPC sweep taken before the GPU port found far slower than these fused
    rank-1 updates for small batched matrices. Not yet measured on the
    GPU.
    Returns (Ainv, pd_ok).
    """
    n = A.shape[-1]
    dtype = A.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)
    B0 = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)

    def step(k, carry):
        A, B, minpiv = carry
        prow = A[..., k, :]
        brow = B[..., k, :]
        piv = prow[..., k]
        minpiv = jnp.minimum(minpiv, piv)  # SIGNED: PD needs every pivot > 0
        ok = jnp.abs(piv) > tiny
        inv = jnp.where(ok, 1.0 / jnp.where(ok, piv, 1.0), 0.0)
        prow = prow * inv[..., None]
        brow = brow * inv[..., None]
        col = A[..., :, k]
        factor = col * (1.0 - jax.nn.one_hot(k, n, dtype=dtype))
        A = A - factor[..., None] * prow[..., None, :]
        B = B - factor[..., None] * brow[..., None, :]
        A = A.at[..., k, :].set(prow)
        B = B.at[..., k, :].set(brow)
        return A, B, minpiv

    minpiv0 = jnp.full(A.shape[:-2], jnp.inf, dtype)
    _, B, minpiv = jax.lax.fori_loop(0, n, step, (A, B0, minpiv0))
    ok = (minpiv > tiny) & jnp.all(jnp.isfinite(B), axis=(-2, -1))
    return B, ok


def solve_principal(M, rhs, nonbas, na_cap=None):
    """Solve the principal subsystem M[nb, nb] x_nb = rhs_nb; zero elsewhere.

    The shared sub-solve of every pivoting method (the reference's
    `solve_fast`): builds the masked system (identity on inactive slots) and
    routes it to the fused Gauss–Jordan on f32 (accelerator) or LAPACK on
    f64 (CPU regression mode). The masked systems are principal submatrices of the QP
    KKT-LCP matrix, whose symmetric part is PSD, so unpivoted elimination is
    stable. Returns (x, ok).

    na_cap (static): compact the masked system to the na_cap
    permuted-to-front nonbasic slots before eliminating — the GJ depth and
    bandwidth drop from n to na_cap (the sequential-depth bottleneck of the
    large articulated MPC LCPs, which are padded to n=88+ while their
    working sets stay small). A nonbasic set larger than the cap returns
    ok=False, which callers treat like a singular sub-solve (BPP reports
    failure and the full-size fallback path runs).
    """
    dtype = M.dtype
    n = rhs.shape[-1]
    if na_cap is not None and _use_gj(dtype) and na_cap < n:
        idx = jnp.argsort(~nonbas)[:na_cap]       # nonbasics first (stable)
        cnt = jnp.sum(nonbas)
        P = jax.nn.one_hot(idx, n, dtype=dtype)   # (NA, n)
        rowm = jnp.arange(na_cap) < cnt
        sub = (P @ M) @ P.T
        subm = jnp.where(rowm[:, None] & rowm[None, :], sub, 0.0) + jnp.diag(
            jnp.where(rowm, 0.0, 1.0).astype(dtype)
        )
        bc = jnp.where(rowm, P @ jnp.where(nonbas, rhs, 0.0), 0.0)
        xc, gj_ok = gj_solve_masked(subm, bc, rowm)
        x = P.T @ xc
        # a vanishing pivot is tolerated (the elimination skips it and the
        # dependent coordinate stays zero — same robust continuation as
        # the uncapped GJ route); only a working set EXCEEDING the cap is
        # a hard failure
        ok = (cnt <= na_cap) & jnp.all(jnp.isfinite(xc))
        return jnp.where(nonbas, x, 0.0), ok
    outer = nonbas[:, None] & nonbas[None, :]
    A = jnp.where(outer, M, 0.0) + jnp.diag(
        jnp.where(nonbas, 0.0, 1.0).astype(dtype)
    )
    b = jnp.where(nonbas, rhs, 0.0)
    if _use_gj(dtype):
        if _GJ_BLOCK_MIN_N and n >= _GJ_BLOCK_MIN_N:
            x, ok = gj_solve_masked_blocked(A, b, nonbas)
        else:
            x, ok = gj_solve_masked(A, b, nonbas)
    else:
        x = jnp.linalg.solve(A, b)
        ok = jnp.all(jnp.isfinite(x))
    return jnp.where(nonbas, x, 0.0), ok


def _first_min_index(v, valid):
    """Index of the minimum of v over `valid` slots (first on ties).

    The reference breaks ties randomly (`rand_min`, src/LCP.cpp:199); we take
    the deterministic first minimum, which coincides whenever the minimum is
    unique (the non-degenerate case).
    """
    big = jnp.full_like(v, jnp.inf)
    vm = jnp.where(valid, v, big)
    return jnp.argmin(vm)


class LCPStats(NamedTuple):
    """Per-solve effort counters (the reference's LCP pivot counters,
    include/Moby/LCP.h:30, surfaced instead of dying inside while carries)."""

    pivots: jnp.ndarray    # () int32: pivot/iteration count of the solve
    fallback: jnp.ndarray  # () bool: did the solve leave the primary stage


class _PPMState(NamedTuple):
    nonbas: jnp.ndarray   # (n,) bool: z_i currently nonbasic-in-w sense (z active)
    z: jnp.ndarray        # (n,) current z estimate on nonbasic set
    done: jnp.ndarray     # () bool
    failed: jnp.ndarray   # () bool
    pivots: jnp.ndarray   # () int32


def lcp_fast(M, q, mask, z0=None, zero_tol=-1.0, skip=None):
    """Principal pivoting (reference `LCP::lcp_fast`, src/LCP.cpp:41).

    Args:
      M, q: padded (n, n), (n,) problem.
      mask: (n,) bool, active slots.
      z0:   optional warm-start z (basis seeded from |z0| >= zero_tol).
      zero_tol: negative -> auto (m * ||M||_inf * eps), like the reference.

    Returns (z, ok).
    """
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask)

    auto_tol = m_active.astype(dtype) * _masked_norm_inf(M, mask) * _eps(dtype)
    ztol = jnp.where(zero_tol < 0.0, auto_tol, zero_tol).astype(dtype)

    # initial basis
    if z0 is None:
        minw_i = _first_min_index(q, mask)
        trivial = q[minw_i] > -ztol
        nonbas0 = (jnp.arange(n) == minw_i) & mask & ~trivial
    else:
        z0 = jnp.where(mask, z0, 0.0)
        nonbas0 = (jnp.abs(z0) >= ztol) & mask
        trivial = jnp.array(False)
        # if warm basis empty, behave like the cold start
        cold_i = _first_min_index(q, mask)
        cold_trivial = q[cold_i] > -ztol
        empty = ~jnp.any(nonbas0)
        trivial = empty & cold_trivial
        nonbas0 = jnp.where(
            empty, (jnp.arange(n) == cold_i) & mask & ~trivial, nonbas0
        )

    max_piv = 2 * m_active

    def solve_sub(nonbas):
        """Solve M[nb,nb] z_nb = -q[nb]; returns (z, w_on_basic, ok)."""
        z, ok = solve_principal(M, -q, nonbas)
        bas = mask & ~nonbas
        w = jnp.where(bas, M @ z + q, 0.0)
        return z, w, ok

    def body(s: _PPMState) -> _PPMState:
        z, w, solvable = solve_sub(s.nonbas)
        bas = mask & ~s.nonbas

        any_bas = jnp.any(bas)
        minw_i = _first_min_index(w, bas)
        minw = jnp.where(any_bas, w[minw_i], jnp.inf)

        any_nb = jnp.any(s.nonbas)
        minz_i = _first_min_index(z, s.nonbas)
        minz = jnp.where(any_nb, z[minz_i], jnp.inf)

        w_ok = ~any_bas | (minw > -ztol)
        z_neg = any_nb & (minz < -ztol)

        # case 1: w >= 0 everywhere
        #   z >= 0 too -> solved;  else move most-negative z out of nonbasic
        # case 2: some w < 0 -> move that index into nonbasic;
        #   and if some z < 0, move that index out of nonbasic
        move_out = jnp.zeros_like(s.nonbas)
        move_in = jnp.zeros_like(s.nonbas)

        move_out = move_out.at[minz_i].set(z_neg)
        move_in = move_in.at[minw_i].set(~w_ok & any_bas)

        solved = w_ok & ~z_neg
        nonbas_next = (s.nonbas | move_in) & ~move_out

        if _use_gj(dtype):
            # the fused-GJ sub-solve SKIPS vanishing pivots (dependent
            # coordinates stay zero), so a singular principal submatrix —
            # routine for the rank-deficient Delassus blocks of large
            # impact LCPs — still yields a usable iterate: keep pivoting
            # instead of aborting (the caller verifies before accepting;
            # max_piv bounds cycling). Early-abort survives on the f64
            # LAPACK route, whose singular solves return non-finite.
            return _PPMState(
                nonbas=jnp.where(solved, s.nonbas, nonbas_next),
                z=z,
                done=solved,
                failed=jnp.array(False),
                pivots=s.pivots + 1,
            )
        return _PPMState(
            nonbas=jnp.where(solved | ~solvable, s.nonbas, nonbas_next),
            z=jnp.where(solvable, z, s.z),
            done=solved & solvable,
            failed=~solvable,
            pivots=s.pivots + 1,
        )

    def cond(s: _PPMState):
        return ~s.done & ~s.failed & (s.pivots < max_piv)

    if skip is None:
        skip = jnp.array(False)
    init = _PPMState(
        nonbas=nonbas0,
        z=jnp.zeros(n, dtype),
        done=trivial | skip,
        failed=jnp.array(False),
        pivots=jnp.array(0, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    z = jnp.where(mask & ~trivial & ~skip, out.z, 0.0)
    ok = (out.done | trivial) & ~skip
    return z, ok


def _verify(M, q, z, mask, check_tol):
    """Solution verification used by the regularized wrappers
    (reference src/LCP.cpp:239-260)."""
    zm = jnp.where(mask, z, 0.0)
    w = jnp.where(mask, M @ zm + q, 0.0)
    z_ok = jnp.all(jnp.where(mask, zm, 0.0) >= -check_tol)
    w_ok = jnp.all(w >= -check_tol)
    zw = zm * w
    # <= so the empty/trivial problem (z = w = 0, and check_tol = 0 when the
    # mask is empty) verifies — otherwise every cascade stage re-runs its
    # full regularization sweep on steps with nothing to solve
    c_ok = jnp.all(zw >= -check_tol) & jnp.all(jnp.where(mask, zw, 0.0) <= check_tol)
    return z_ok & w_ok & c_ok


def lcp_fast_regularized(
    M, q, mask, z0=None, min_exp=-20, step_exp=4, max_exp=20, zero_tol=-1.0,
    skip=None,
):
    """Tikhonov-sweep wrapper around :func:`lcp_fast`
    (reference src/LCP.cpp:212-353).

    Tries λ = 0, then λ = 10^k for k = min_exp, min_exp+step_exp, ... while
    k < max_exp, accepting the first verified solution.
    """
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask).astype(dtype)
    near_zero = float(np.sqrt(_eps(dtype)))
    check_tol = jnp.where(
        zero_tol > 0.0, zero_tol, m_active * _masked_norm_inf(M, mask) * near_zero
    ).astype(dtype)

    exps = [None] + list(range(min_exp, max_exp, step_exp))  # None = λ=0
    lambdas = jnp.array([0.0 if e is None else 10.0 ** e for e in exps], dtype)
    n_attempts = len(exps)

    if skip is None:
        skip = jnp.array(False)

    def attempt(k):
        lam = lambdas[k]
        Mreg = M + lam * jnp.eye(n, dtype=dtype) * mask.astype(dtype)
        z, ok = lcp_fast(Mreg, q, mask, z0=z0, zero_tol=zero_tol, skip=skip)
        good = ok & _verify(Mreg, q, z, mask, check_tol)
        return z, good

    def cond(carry):
        k, z, good = carry
        return (~good) & (k < n_attempts) & ~skip

    def body(carry):
        k, z, good = carry
        z2, good2 = attempt(k)
        return k + 1, jnp.where(good2, z2, z), good2

    _, z, good = jax.lax.while_loop(
        cond, body, (jnp.array(0), jnp.zeros(n, dtype), jnp.array(False))
    )
    return z, good


class _LemkeState(NamedTuple):
    basvar: jnp.ndarray   # (n,) int32: variable id basic in each row slot
    Bl: jnp.ndarray       # (n, n) basis matrix
    x: jnp.ndarray        # (n,) basic values
    leaving: jnp.ndarray  # () int32: variable that just left
    done: jnp.ndarray
    failed: jnp.ndarray
    pivots: jnp.ndarray


def lcp_lemke(M, q, mask, piv_tol=-1.0, zero_tol=-1.0, skip=None):
    """Lemke's algorithm (reference src/LCP.cpp:545-1003), cold-started.

    Variable ids: 0..n-1 -> z_i, n..2n-1 -> w_i, 2n -> artificial t.
    The artificial column is a covering vector with 1s on the initially
    negative components of q (reference src/LCP.cpp:779-790).
    """
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask)
    t_var = 2 * n

    norminf = _masked_norm_inf(M, mask)
    ztol = jnp.where(
        zero_tol > 0.0, zero_tol, _eps(dtype) * norminf * m_active.astype(dtype)
    ).astype(dtype)
    ptol = jnp.where(
        piv_tol > 0.0,
        piv_tol,
        _eps(dtype) * m_active.astype(dtype) * jnp.maximum(1.0, norminf),
    ).astype(dtype)

    trivial = jnp.min(jnp.where(mask, q, jnp.inf)) > -ztol
    if skip is None:
        skip = jnp.array(False)

    maxiter = jnp.where(skip, 0, jnp.minimum(1000, 50 * m_active))

    # initial: basis = all w vars, Bl = -I, x = q
    arange = jnp.arange(n)
    basvar0 = (arange + n).astype(jnp.int32)
    Bl0 = -jnp.eye(n, dtype=dtype)
    x0 = q

    # first pivot: artificial variable enters, most-negative x leaves
    lv0 = _first_min_index(x0, mask)
    tval = -x0[lv0]
    u = jnp.where((x0 < 0.0) & mask, 1.0, 0.0).astype(dtype)
    Be0 = -(Bl0 @ u)
    x1 = x0 + u * tval
    x1 = x1.at[lv0].set(tval)
    Bl1 = Bl0.at[:, lv0].set(Be0)
    leaving0 = basvar0[lv0]
    basvar1 = basvar0.at[lv0].set(t_var)

    def body(s: _LemkeState) -> _LemkeState:
        # entering variable = complement of the leaving one
        lz = s.leaving < n  # a z var left -> w_leaving enters with column -e
        entering = jnp.where(lz, n + s.leaving, s.leaving - n).astype(jnp.int32)
        Be = jnp.where(
            lz,
            -(arange == s.leaving).astype(dtype),
            M[:, jnp.clip(s.leaving - n, 0, n - 1)],
        )
        d = jnp.linalg.solve(s.Bl, Be)
        solvable = jnp.all(jnp.isfinite(d))

        j = d > ptol
        ray = ~jnp.any(j)

        # min-ratio test with the reference's tolerance shift
        ratio_sel = jnp.where(j, (s.x + ztol) / d, jnp.inf)
        theta = jnp.min(ratio_sel)
        cand = j & (jnp.where(j, s.x / d, jnp.inf) <= theta)

        # prefer the artificial variable if it can leave
        art_cand = cand & (s.basvar == t_var)
        any_art = jnp.any(art_cand)
        lv_art = jnp.argmax(art_cand)
        lv_first = jnp.argmax(cand)  # first candidate index
        lv = jnp.where(any_art, lv_art, lv_first).astype(jnp.int32)

        ratio = s.x[lv] / d[lv]
        x_new = s.x - d * ratio
        x_new = x_new.at[lv].set(ratio)
        Bl_new = s.Bl.at[:, lv].set(Be)
        new_leaving = s.basvar[lv]
        basvar_new = s.basvar.at[lv].set(entering)

        fail = ray | ~solvable
        done = new_leaving == t_var
        return _LemkeState(
            basvar=jnp.where(fail, s.basvar, basvar_new),
            Bl=jnp.where(fail, s.Bl, Bl_new),
            x=jnp.where(fail, s.x, x_new),
            leaving=jnp.where(fail, s.leaving, new_leaving).astype(jnp.int32),
            done=done & ~fail,
            failed=fail,
            pivots=s.pivots + 1,
        )

    def cond(s: _LemkeState):
        return ~s.done & ~s.failed & (s.pivots < maxiter)

    init = _LemkeState(
        basvar=basvar1,
        Bl=Bl1,
        x=x1,
        leaving=leaving0.astype(jnp.int32),
        done=jnp.array(False),
        failed=jnp.array(False),
        pivots=jnp.array(0, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)

    # scatter basic values into z (variable ids < n are z vars)
    is_z = out.basvar < n
    z = jnp.zeros(n, dtype).at[jnp.where(is_z, out.basvar, n - 1)].add(
        jnp.where(is_z, out.x, 0.0)
    )
    z = jnp.where(mask & ~trivial & ~skip, z, 0.0)
    ok = (trivial | (out.done & ~out.failed)) & ~skip
    return z, ok


def lcp_lemke_regularized(
    M, q, mask, min_exp=-20, step_exp=1, max_exp=1, piv_tol=-1.0, zero_tol=-1.0,
    skip=None,
):
    """Tikhonov-sweep wrapper around :func:`lcp_lemke`
    (reference src/LCP.cpp:353-487)."""
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask).astype(dtype)
    near_zero = float(np.sqrt(_eps(dtype)))
    check_tol = jnp.where(
        zero_tol > 0.0, zero_tol, m_active * _masked_norm_inf(M, mask) * near_zero
    ).astype(dtype)

    exps = [None] + list(range(min_exp, max_exp, step_exp))
    lambdas = jnp.array([0.0 if e is None else 10.0 ** e for e in exps], dtype)
    n_attempts = len(exps)

    if skip is None:
        skip = jnp.array(False)

    def cond(carry):
        k, z, good = carry
        return (~good) & (k < n_attempts) & ~skip

    def body(carry):
        k, z, good = carry
        lam = lambdas[k]
        Mreg = M + lam * jnp.eye(n, dtype=dtype) * mask.astype(dtype)
        z2, ok = lcp_lemke(
            Mreg, q, mask, piv_tol=piv_tol, zero_tol=zero_tol, skip=skip
        )
        good2 = ok & _verify(Mreg, q, z2, mask, check_tol)
        return k + 1, jnp.where(good2, z2, z), good2

    _, z, good = jax.lax.while_loop(
        cond, body, (jnp.array(0), jnp.zeros(n, dtype), jnp.array(False))
    )
    return z, good


class _SMState(NamedTuple):
    nonbas: jnp.ndarray
    Binv: jnp.ndarray     # inverse of the masked basis system
    z: jnp.ndarray
    done: jnp.ndarray
    failed: jnp.ndarray
    pivots: jnp.ndarray
    since_refresh: jnp.ndarray


def lcp_fast_sm(M, q, mask, z0=None, zero_tol=-1.0, refresh_every: int = 8,
                skip=None):
    """Principal pivoting with a Sherman–Morrison-maintained basis inverse.

    Pivot-for-pivot identical to :func:`lcp_fast` (same selection rules), but
    each pivot updates the inverse of the masked system with <= 4 rank-1
    corrections (O(n²) work, O(1) sequential depth) instead of re-solving an
    LU per pivot — aimed at the latency-bound pivot chain. The
    inverse is refreshed by a full solve every `refresh_every` pivots to
    bound drift; callers verify the solution and fall back to the exact
    solver on failure.
    """
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask)
    auto_tol = m_active.astype(dtype) * _masked_norm_inf(M, mask) * _eps(dtype)
    ztol = jnp.where(zero_tol < 0.0, auto_tol, zero_tol).astype(dtype)
    eye = jnp.eye(n, dtype=dtype)

    def masked_A(nb):
        outer = nb[:, None] & nb[None, :]
        return jnp.where(outer, M, 0.0) + jnp.diag(
            jnp.where(nb, 0.0, 1.0).astype(dtype)
        )

    # initial basis (as in lcp_fast)
    if z0 is None:
        z0 = jnp.zeros(n, dtype)
    z0 = jnp.where(mask, z0, 0.0)
    warm = (jnp.abs(z0) >= ztol) & mask
    cold_i = _first_min_index(q, mask)
    cold_trivial = q[cold_i] > -ztol
    empty = ~jnp.any(warm)
    trivial = empty & cold_trivial
    nonbas0 = jnp.where(empty, (jnp.arange(n) == cold_i) & mask & ~trivial, warm)

    Binv0 = jnp.linalg.inv(masked_A(nonbas0))
    max_piv = 2 * m_active

    def sm_update(Binv, u, v):
        """Binv of (A + u v^T)."""
        Bu = Binv @ u
        vB = v @ Binv
        denom = 1.0 + v @ Bu
        ok = jnp.abs(denom) > 1e-12
        upd = Binv - jnp.outer(Bu, vB) / jnp.where(ok, denom, 1.0)
        return jnp.where(ok, upd, Binv), ok

    def add_index(Binv, nb_old, i_mask):
        """Index i joins the nonbasic set; nb_new = nb_old | i_mask."""
        nb_new = nb_old | i_mask
        ei = i_mask.astype(dtype)
        # row fix: e_i row -> M[i, nb_new]
        newrow = (i_mask.astype(dtype) @ M) * nb_new.astype(dtype)
        v1 = newrow - ei
        B1, ok1 = sm_update(Binv, ei, v1)
        # col fix: 0 -> M[nb_old, i] on the other rows
        u2 = (M @ ei) * (nb_old.astype(dtype))
        B2, ok2 = sm_update(B1, u2, ei)
        return B2, nb_new, ok1 & ok2

    def remove_index(Binv, nb_old, i_mask):
        """Index i leaves the nonbasic set (reverse of add)."""
        nb_new = nb_old & ~i_mask
        ei = i_mask.astype(dtype)
        # col unfix first
        u2 = -(M @ ei) * nb_new.astype(dtype)
        B1, ok1 = sm_update(Binv, u2, ei)
        # row unfix: M[i, nb_old] row -> e_i
        oldrow = (ei @ M) * (nb_old.astype(dtype))
        v1 = ei - oldrow
        B2, ok2 = sm_update(B1, ei, v1)
        return B2, nb_new, ok1 & ok2

    def body(s: _SMState):
        nb = s.nonbas
        z = jnp.where(nb, s.Binv @ jnp.where(nb, -q, 0.0), 0.0)
        finite = jnp.all(jnp.isfinite(z))
        bas = mask & ~nb
        w = jnp.where(bas, M @ z + q, 0.0)

        any_bas = jnp.any(bas)
        minw_i = _first_min_index(w, bas)
        minw = jnp.where(any_bas, w[minw_i], jnp.inf)
        any_nb = jnp.any(nb)
        minz_i = _first_min_index(z, nb)
        minz = jnp.where(any_nb, z[minz_i], jnp.inf)

        w_ok = ~any_bas | (minw > -ztol)
        z_neg = any_nb & (minz < -ztol)
        solved = w_ok & ~z_neg

        in_mask = (jnp.arange(n) == minw_i) & (~w_ok & any_bas)
        out_mask = (jnp.arange(n) == minz_i) & z_neg

        # apply the add then the remove through SM updates
        B1, nb1, okA = add_index(s.Binv, nb, in_mask)
        B1 = jnp.where(jnp.any(in_mask), B1, s.Binv)
        nb1 = jnp.where(jnp.any(in_mask), nb1, nb)
        okA = okA | ~jnp.any(in_mask)
        B2, nb2, okR = remove_index(B1, nb1, out_mask)
        B2 = jnp.where(jnp.any(out_mask), B2, B1)
        nb2 = jnp.where(jnp.any(out_mask), nb2, nb1)
        okR = okR | ~jnp.any(out_mask)

        # periodic refresh to bound drift
        refresh = s.since_refresh + 1 >= refresh_every
        B2 = jnp.where(refresh, jnp.linalg.inv(masked_A(nb2)), B2)

        fail = ~finite | ~(okA & okR)
        return _SMState(
            nonbas=jnp.where(solved | fail, nb, nb2),
            Binv=B2,
            z=jnp.where(finite, z, s.z),
            done=solved & finite,
            failed=fail & ~solved,
            pivots=s.pivots + 1,
            since_refresh=jnp.where(refresh, 0, s.since_refresh + 1),
        )

    def cond(s: _SMState):
        return ~s.done & ~s.failed & (s.pivots < max_piv)

    if skip is None:
        skip = jnp.array(False)
    init = _SMState(
        nonbas=nonbas0,
        Binv=Binv0,
        z=jnp.zeros(n, dtype),
        done=trivial | skip,
        failed=jnp.array(False),
        pivots=jnp.array(0, jnp.int32),
        since_refresh=jnp.array(0, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    z = jnp.where(mask & ~trivial & ~skip, out.z, 0.0)
    ok = (out.done | trivial) & ~skip
    return z, ok


class _BPPState(NamedTuple):
    nonbas: jnp.ndarray   # (n,) bool: the "F" set (z-variables basic)
    z: jnp.ndarray
    done: jnp.ndarray
    failed: jnp.ndarray
    iters: jnp.ndarray
    ninf: jnp.ndarray     # infeasibility count of the last iterate
    p: jnp.ndarray        # safeguard budget (Murty fallback when exhausted)


def bpp_compact_cap(n: int) -> int | None:
    """Static working-set cap for the compacted BPP sub-solves (None =
    full size). Mirrors difflcp._compact_cap's rationale on the forward
    side: large padded impact LCPs carry small working sets.

    OPT-IN via MOBY_BPP_COMPACT_NA (0/unset = off): on the ur10 MPC
    workload (n=88) it measured only +2% over the record/replay path while
    changing which solution of DEGENERATE contact LCPs the seed converges
    to (a different—equally valid—impulse distribution, so trajectories
    shift), and capped-out members at large batch fall back more often.
    Worth revisiting for n >> 100 problems where the depth ratio is
    bigger."""
    import os

    na = int(os.environ.get("MOBY_BPP_COMPACT_NA", "0"))
    if na <= 0 or n <= max(na, 64):
        return None
    return na


def lcp_bpp(M, q, mask, z0=None, zero_tol=-1.0, max_iters: int = 24,
            p_budget: int = 3, skip=None, with_pivots=False, na_cap=None):
    """Block principal pivoting (Júdice–Pires) for the LCP.

    Same sub-problem solve as :func:`lcp_fast` (masked dense system, as the
    reference's `solve_fast`), but every iteration swaps *all* violating
    indices between the basic and nonbasic sets at once instead of one:

        F ← (F \\ {i ∈ F : z_i < -tol}) ∪ {i ∉ F : w_i < -tol}

    For the monotone QP-derived LCPs of the impact handler this converges in
    a handful of iterations independent of problem size — the sequential
    pivot-chain depth (`lax.while_loop` iterations lock-step across the
    vmapped batch) drops from O(m) to O(~10). The classic cycling safeguard applies: when
    the infeasibility count fails to strictly decrease for `p_budget`
    consecutive iterations, fall back to switching only the first (least
    index) violator — Murty's method, finite for P-matrices.

    Callers must verify the solution (`_verify`) before accepting; the
    production cascade falls back to the exact pivoting path on failure, so
    semantics are unchanged.
    """
    n = q.shape[0]
    dtype = M.dtype
    M, q = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask)
    auto_tol = m_active.astype(dtype) * _masked_norm_inf(M, mask) * _eps(dtype)
    ztol = jnp.where(zero_tol < 0.0, auto_tol, zero_tol).astype(dtype)

    # initial F: warm-start support, else the q<0 set (one-shot for the
    # common resting-contact case where the whole active set pushes)
    if z0 is None:
        z0 = jnp.zeros(n, dtype)
    z0 = jnp.where(mask, z0, 0.0)
    warm = (jnp.abs(z0) >= ztol) & mask
    cold = (q < -ztol) & mask
    nonbas0 = jnp.where(jnp.any(warm), warm, cold)

    def _rank_in(sel, key):
        """0-based rank of each selected slot by ascending key."""
        order = jnp.argsort(jnp.where(sel, key, jnp.inf))
        return jnp.argsort(order)

    if na_cap is not None:
        # cap the initial working set at the na_cap highest-priority slots
        # (most-negative q cold / largest warm-start magnitude): the
        # compacted sub-solve below reports failure past the cap, so never
        # seed beyond it
        key0 = jnp.where(jnp.any(warm), -jnp.abs(z0), q)
        nonbas0 = nonbas0 & (_rank_in(nonbas0, key0) < na_cap)
    trivial = ~jnp.any(nonbas0)

    arange = jnp.arange(n)

    def solve_sub(nonbas):
        z, ok = solve_principal(M, -q, nonbas, na_cap=na_cap)
        bas = mask & ~nonbas
        w = jnp.where(bas, M @ z + q, 0.0)
        return z, w, ok

    def body(s: _BPPState) -> _BPPState:
        z, w, solvable = solve_sub(s.nonbas)
        bas = mask & ~s.nonbas

        H1 = s.nonbas & (z < -ztol)          # z-basic but negative -> leave
        H2 = bas & (w < -ztol)               # w negative -> enter
        ninf = (jnp.sum(H1) + jnp.sum(H2)).astype(jnp.int32)
        solved = (ninf == 0) & solvable

        improved = ninf < s.ninf
        p_next = jnp.where(improved, jnp.int32(p_budget), s.p - 1)

        # full block swap while the safeguard budget holds; otherwise swap
        # only the first violating index (Murty's least-index rule)
        viol = H1 | H2
        first_i = _first_min_index(
            jnp.where(viol, arange, n).astype(dtype), viol
        )
        single = (arange == first_i) & viol
        use_block = p_next > 0
        H1e = jnp.where(use_block, H1, single & H1)
        H2e = jnp.where(use_block, H2, single & H2)

        if na_cap is not None:
            # admit only the most-violating entering indices that fit the
            # compacted working set (the rest re-qualify next iteration)
            room = na_cap - jnp.sum(s.nonbas & ~H1e)
            H2e = H2e & (_rank_in(H2e, w) < room)

        nonbas_next = (s.nonbas & ~H1e) | H2e

        if _use_gj(dtype):
            # pivot-skipping GJ sub-solves survive singular principal
            # submatrices (see lcp_fast.body): keep iterating instead of
            # aborting — the cold q<0 seed of a rank-deficient impact LCP
            # is singular almost always, and aborting there forced the
            # whole solve to the fallback path. Violated rows of the
            # skipped coordinates re-enter via H1/H2; _verify gates
            # acceptance; max_iters bounds cycling. With a compaction cap,
            # `solvable` means "working set fits the cap" — a cap-out IS
            # a hard failure (the iterate is truncated, not pivot-skipped).
            if na_cap is None:
                solved_r = ninf == 0
                failed_r = jnp.array(False)
            else:
                solved_r = (ninf == 0) & solvable
                failed_r = ~solvable
            return _BPPState(
                nonbas=jnp.where(solved_r | failed_r, s.nonbas, nonbas_next),
                z=z,
                done=solved_r,
                failed=failed_r,
                iters=s.iters + 1,
                ninf=jnp.where(improved, ninf, s.ninf),
                p=jnp.maximum(p_next, 0),
            )
        return _BPPState(
            nonbas=jnp.where(solved | ~solvable, s.nonbas, nonbas_next),
            z=jnp.where(solvable, z, s.z),
            done=solved,
            failed=~solvable,
            iters=s.iters + 1,
            ninf=jnp.where(improved, ninf, s.ninf),
            p=jnp.maximum(p_next, 0),
        )

    def cond(s: _BPPState):
        return ~s.done & ~s.failed & (s.iters < max_iters)

    if skip is None:
        skip = jnp.array(False)
    init = _BPPState(
        nonbas=nonbas0,
        z=jnp.zeros(n, dtype),
        done=trivial | skip,
        failed=jnp.array(False),
        iters=jnp.array(0, jnp.int32),
        ninf=jnp.array(n + 1, jnp.int32),
        p=jnp.array(p_budget, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    z = jnp.where(mask & ~trivial & ~skip, out.z, 0.0)
    ok = (out.done | trivial) & ~skip
    if with_pivots:
        return z, ok, out.iters
    return z, ok


def solve_lcp_fast_lemke(M, q, mask, z0=None, skip=None, with_stats=False):
    """`lcp_fast` then `lcp_lemke_regularized` (the cascade used by the
    stabilization and no-slip paths, e.g. src/ConstraintStabilization.cpp:955),
    behind a batched BPP prepass whose verified solutions skip both stages.
    One route for every backend and dtype."""
    dtype = M.dtype
    Mp, qp = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask).astype(dtype)
    near_zero = float(np.sqrt(_eps(dtype)))
    check_tol = (m_active * _masked_norm_inf(Mp, mask) * near_zero).astype(dtype)

    if skip is None:
        skip = jnp.array(False)
    z_bp, ok_bp, piv_bp = lcp_bpp(
        M, q, mask, z0=z0, skip=skip, with_pivots=True,
        na_cap=bpp_compact_cap(q.shape[-1]) if _use_gj(dtype) else None,
    )
    ok_bp = ok_bp & _verify(Mp, qp, z_bp, mask, check_tol)

    z, ok = lcp_fast(M, q, mask, z0=z0, skip=ok_bp | skip)
    ok = ok & _verify(Mp, qp, z, mask, check_tol)
    z2, ok2 = lcp_lemke_regularized(M, q, mask, skip=ok_bp | ok | skip)
    z_out = jnp.where(ok_bp, z_bp, jnp.where(ok, z, z2))
    if with_stats:
        stats = LCPStats(pivots=piv_bp, fallback=(~ok_bp & ~skip))
        return z_out, ok_bp | ok | ok2, stats
    return z_out, ok_bp | ok | ok2


def solve_lcp(M, q, mask, z0=None, skip=None, with_stats=False):
    """Production path mirroring the impact handler's solver cascade
    (reference src/ImpactConstraintHandlerQP.cpp:219-226):
    `lcp_fast_regularized(-20, 4, -8)` then `lcp_lemke_regularized` fallback.

    A batched BPP prepass (`lcp_bpp`, a handful of lock-step iterations)
    solves the common case; the exact pivoting stages run skip-gated only
    for problems whose BPP solution fails verification, so the semantics
    are the reference cascade's (monotone problems have unique solutions).
    One route for every backend and dtype.
    """
    dtype = M.dtype
    Mp, qp = pad_lcp(M, q, mask)
    m_active = jnp.sum(mask).astype(dtype)
    near_zero = float(np.sqrt(_eps(dtype)))
    check_tol = (m_active * _masked_norm_inf(Mp, mask) * near_zero).astype(dtype)

    if skip is None:
        skip = jnp.array(False)
    z_bp, ok_bp, piv_bp = lcp_bpp(
        M, q, mask, z0=z0, skip=skip, with_pivots=True,
        na_cap=bpp_compact_cap(q.shape[-1]) if _use_gj(dtype) else None,
    )
    ok_bp = ok_bp & _verify(Mp, qp, z_bp, mask, check_tol)

    z, ok = lcp_fast_regularized(
        M, q, mask, z0=z0, min_exp=-20, step_exp=4, max_exp=-8,
        skip=ok_bp | skip,
    )
    z2, ok2 = lcp_lemke_regularized(M, q, mask, skip=ok_bp | ok | skip)
    z_exact = jnp.where(ok, z, z2)
    ok_exact = ok | ok2
    z_out = jnp.where(ok_bp, z_bp, z_exact)
    if with_stats:
        stats = LCPStats(pivots=piv_bp, fallback=(~ok_bp & ~skip))
        return z_out, ok_bp | ok_exact, stats
    return z_out, ok_bp | ok_exact
