"""Batched, fixed-shape linear programming.

Mirrors the reference's `LP::lp_seidel` surface *and convention*
(include/Moby/LP.h:20, src/LP.cpp:32-295): solve

    maximize    c'x
    subject to  A x <= b,   l <= x <= u

In the reference this is Seidel's randomized incremental algorithm — a
recursive, data-dependent CPU construction (used only from debug/dead code:
the CCD comparison block is commented out, `CP.cpp` is not built). The
fixed-shape design replaces it with the classic **LP -> LCP reduction** solved
by our fixed-shape Lemke kernel (`solvers.lcp.lcp_lemke_regularized`):

minimize (-c)'x under -A x >= -b; shift x = l + s (s >= 0), stack
G = [-A; -I], h = [-b + A l; l - u], and form the primal-dual
complementarity system over z = [s; y]:

    M = [[0, -G'],
         [G,  0 ]],    q = [-c; -h]

A solution z >= 0, w = M z + q >= 0, z'w = 0 is a primal-dual optimal pair by
complementary slackness; Lemke processes this skew-symmetric class and
terminates on a secondary ray exactly when the LP is infeasible or unbounded
— which maps to the reference's `return false`.

Everything is fixed-shape and mask-padded so it vmaps/jits; infinite bounds
are finitized like the reference's `finitize` (src/LP.cpp:297-305).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lcp as lcp_mod

_BIG = 1e12


def lp_seidel(A, b, c, l, u, con_mask=None, var_mask=None):
    """Solve max c'x s.t. A x <= b, l <= x <= u (the reference convention).

    Args:
      A: (m, n) inequality rows (may be zero rows for pure box LPs).
      b: (m,)
      c: (n,) objective.
      l, u: (n,) bounds (+-inf allowed; finitized to +-1e12).
      con_mask: (m,) bool — active constraint rows (padding support).
      var_mask: (n,) bool — active variables.

    Returns:
      (x, ok): the maximizer (zeros on inactive slots) and a success flag
      (False when the LP is infeasible/unbounded, matching the reference's
      boolean return).
    """
    A = jnp.atleast_2d(A)
    m, n = A.shape
    dtype = A.dtype
    if con_mask is None:
        con_mask = jnp.ones(m, bool)
    if var_mask is None:
        var_mask = jnp.ones(n, bool)

    lf = jnp.clip(jnp.where(var_mask, l, 0.0), -_BIG, _BIG)
    uf = jnp.clip(jnp.where(var_mask, u, 0.0), -_BIG, _BIG)

    # min-form data: minimize cm'x s.t. Am x >= bm
    Am = jnp.where(con_mask[:, None] & var_mask[None, :], -A, 0.0)
    bm = jnp.where(con_mask, -b, 0.0)
    cm = jnp.where(var_mask, -c, 0.0)

    # s-space data: G = [Am; -I], h = [bm - Am l; l - u]
    G = jnp.concatenate([Am, -jnp.eye(n, dtype=dtype)], axis=0)
    h = jnp.concatenate([bm - Am @ lf, lf - uf], axis=0)
    gmask = jnp.concatenate([con_mask, var_mask])

    nz = n + m + n
    M = jnp.zeros((nz, nz), dtype)
    M = M.at[:n, n:].set(-G.T)
    M = M.at[n:, :n].set(G)
    q = jnp.concatenate([cm, -h])
    zmask = jnp.concatenate([var_mask, gmask])

    z, ok = lcp_mod.lcp_lemke_regularized(M, q, zmask, min_exp=-16, max_exp=-3,
                                          step_exp=4)
    s = z[:n]
    x = jnp.where(var_mask, lf + s, 0.0)

    # verify primal feasibility (guards regularization-shifted accepts);
    # tolerance scales with the data of each check, not with the finitized
    # bound magnitudes
    base = jnp.asarray(1e-7, dtype)
    row_tol = base * (1.0 + jnp.abs(Am) @ jnp.abs(x) + jnp.abs(bm))
    feas = jnp.all(jnp.where(con_mask, Am @ x - bm, 0.0) >= -row_tol)
    box_tol = base * (1.0 + jnp.abs(uf - lf))
    feas &= jnp.all(jnp.where(var_mask, x - lf, 0.0) >= -box_tol)
    feas &= jnp.all(jnp.where(var_mask, uf - x, 0.0) >= -box_tol)
    return x, ok & feas
