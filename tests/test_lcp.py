import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moby_tpu.solvers import lcp


def random_monotone_lcp(n, seed, semidefinite=False):
    r = np.random.default_rng(seed)
    A = r.normal(size=(n, n))
    M = A @ A.T
    if not semidefinite:
        M += np.eye(n) * 0.5
    q = r.normal(size=n)
    return jnp.array(M), jnp.array(q)


def check_solution(M, q, z, tol=1e-7):
    z = np.asarray(z)
    w = np.asarray(M) @ z + np.asarray(q)
    assert z.min() >= -tol, f"z has negative components: {z.min()}"
    assert w.min() >= -tol, f"w has negative components: {w.min()}"
    assert abs(z @ w) <= tol * max(1.0, np.abs(w).max()) * len(q), f"z'w = {z @ w}"


class TestLcpFast:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_spd(self, seed):
        n = 8
        M, q = random_monotone_lcp(n, seed)
        mask = jnp.ones(n, bool)
        z, ok = lcp.lcp_fast(M, q, mask)
        assert bool(ok)
        check_solution(M, q, z)

    def test_trivial(self):
        n = 4
        M = jnp.eye(n)
        q = jnp.ones(n)
        z, ok = lcp.lcp_fast(M, q, jnp.ones(n, bool))
        assert bool(ok)
        np.testing.assert_allclose(z, 0.0)

    def test_padded_matches_unpadded(self):
        n, npad = 6, 10
        M, q = random_monotone_lcp(n, 42)
        z_ref, ok = lcp.lcp_fast(M, q, jnp.ones(n, bool))
        assert bool(ok)
        Mp = jnp.zeros((npad, npad)).at[:n, :n].set(M)
        qp = jnp.zeros(npad).at[:n].set(q)
        mask = jnp.arange(npad) < n
        z_pad, ok2 = lcp.lcp_fast(Mp, qp, mask)
        assert bool(ok2)
        np.testing.assert_allclose(np.asarray(z_pad)[:n], z_ref, atol=1e-10)
        np.testing.assert_allclose(np.asarray(z_pad)[n:], 0.0)

    def test_warm_start(self):
        n = 8
        M, q = random_monotone_lcp(n, 7)
        mask = jnp.ones(n, bool)
        z1, ok = lcp.lcp_fast(M, q, mask)
        assert bool(ok)
        z2, ok2 = lcp.lcp_fast(M, q, mask, z0=z1)
        assert bool(ok2)
        np.testing.assert_allclose(z1, z2, atol=1e-9)

    def test_vmap(self):
        n, b = 6, 16
        Ms, qs = [], []
        for s in range(b):
            M, q = random_monotone_lcp(n, 100 + s)
            Ms.append(M)
            qs.append(q)
        Ms = jnp.stack(Ms)
        qs = jnp.stack(qs)
        masks = jnp.ones((b, n), bool)
        zs, oks = jax.vmap(lcp.lcp_fast, in_axes=(0, 0, 0))(Ms, qs, masks)
        assert bool(jnp.all(oks))
        for i in range(b):
            check_solution(Ms[i], qs[i], zs[i])


class TestLemke:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_spd(self, seed):
        n = 8
        M, q = random_monotone_lcp(n, seed)
        mask = jnp.ones(n, bool)
        z, ok = lcp.lcp_lemke(M, q, mask)
        assert bool(ok)
        check_solution(M, q, z)

    @pytest.mark.parametrize("seed", range(4))
    def test_semidefinite(self, seed):
        # PSD (rank-deficient) problems: Lemke with regularization
        n = 8
        M, q = random_monotone_lcp(n, 50 + seed, semidefinite=True)
        mask = jnp.ones(n, bool)
        z, ok = lcp.lcp_lemke_regularized(M, q, mask)
        assert bool(ok)
        check_solution(M, q, z, tol=1e-5)

    def test_padded(self):
        n, npad = 5, 9
        M, q = random_monotone_lcp(n, 3)
        z_ref, ok = lcp.lcp_lemke(M, q, jnp.ones(n, bool))
        assert bool(ok)
        Mp = jnp.zeros((npad, npad)).at[:n, :n].set(M)
        qp = jnp.zeros(npad).at[:n].set(q)
        mask = jnp.arange(npad) < n
        z_pad, ok2 = lcp.lcp_lemke(Mp, qp, mask)
        assert bool(ok2)
        np.testing.assert_allclose(np.asarray(z_pad)[:n], z_ref, atol=1e-10)

    def test_agrees_with_fast(self):
        # strictly monotone LCP has a unique solution; both must find it
        for seed in range(6):
            n = 7
            M, q = random_monotone_lcp(n, 200 + seed)
            mask = jnp.ones(n, bool)
            z1, ok1 = lcp.lcp_fast(M, q, mask)
            z2, ok2 = lcp.lcp_lemke(M, q, mask)
            assert bool(ok1) and bool(ok2)
            np.testing.assert_allclose(z1, z2, atol=1e-7)


class TestCascade:
    def test_solve_lcp(self):
        n = 10
        M, q = random_monotone_lcp(n, 11)
        z, ok = lcp.solve_lcp(M, q, jnp.ones(n, bool))
        assert bool(ok)
        check_solution(M, q, z)

    def test_contact_like_problem(self):
        # 3-sphere stack normal-impulse LCP: tri-diagonal-ish Delassus operator
        # masses 1, unit normals, gravity impulse dt*g
        A = jnp.array(
            [
                [2.0, -1.0, 0.0],
                [-1.0, 2.0, -1.0],
                [0.0, -1.0, 2.0],
            ]
        )
        v = jnp.array([-9.81e-3, 0.0, 0.0])  # only bottom contact approaching
        z, ok = lcp.solve_lcp(A, v, jnp.ones(3, bool))
        assert bool(ok)
        check_solution(A, v, z)
        # the stack: bottom contact must push with all the weight support
        w = A @ z + v
        np.testing.assert_allclose(np.asarray(w), np.maximum(np.asarray(w), 0), atol=1e-9)


class TestBPP:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_spd(self, seed):
        n = 8
        M, q = random_monotone_lcp(n, seed)
        mask = jnp.ones(n, bool)
        z, ok = lcp.lcp_bpp(M, q, mask)
        assert bool(ok)
        check_solution(M, q, z)

    @pytest.mark.parametrize("seed", range(8))
    def test_agrees_with_fast(self, seed):
        n = 9
        M, q = random_monotone_lcp(n, 300 + seed)
        mask = jnp.ones(n, bool)
        z1, ok1 = lcp.lcp_fast(M, q, mask)
        z2, ok2 = lcp.lcp_bpp(M, q, mask)
        assert bool(ok1) and bool(ok2)
        np.testing.assert_allclose(z1, z2, atol=1e-7)

    def test_padded(self):
        n, npad = 6, 11
        M, q = random_monotone_lcp(n, 17)
        z_ref, ok = lcp.lcp_bpp(M, q, jnp.ones(n, bool))
        assert bool(ok)
        Mp = jnp.zeros((npad, npad)).at[:n, :n].set(M)
        qp = jnp.zeros(npad).at[:n].set(q)
        mask = jnp.arange(npad) < n
        z_pad, ok2 = lcp.lcp_bpp(Mp, qp, mask)
        assert bool(ok2)
        np.testing.assert_allclose(np.asarray(z_pad)[:n], z_ref, atol=1e-10)
        np.testing.assert_allclose(np.asarray(z_pad)[n:], 0.0)

    def test_trivial_and_warm(self):
        n = 5
        M = jnp.eye(n)
        q = jnp.ones(n)
        z, ok = lcp.lcp_bpp(M, q, jnp.ones(n, bool))
        assert bool(ok)
        np.testing.assert_allclose(z, 0.0)
        M, q = random_monotone_lcp(n, 23)
        mask = jnp.ones(n, bool)
        z1, ok1 = lcp.lcp_bpp(M, q, mask)
        z2, ok2 = lcp.lcp_bpp(M, q, mask, z0=z1)
        assert bool(ok1) and bool(ok2)
        np.testing.assert_allclose(z1, z2, atol=1e-9)

    def test_kkt_saddle_structure(self):
        # QP-as-LCP KKT stack [[H, -A'], [A, 0]] — the production structure
        # (setup_QP + solve_qp_work): H SPD, A inequality rows
        r = np.random.default_rng(5)
        nv, ni = 6, 4
        B = r.normal(size=(nv, nv))
        H = B @ B.T + np.eye(nv) * 0.1
        A = r.normal(size=(ni, nv))
        c = r.normal(size=nv)
        b = r.normal(size=ni)
        MM = np.zeros((nv + ni, nv + ni))
        MM[:nv, :nv] = H
        MM[:nv, nv:] = -A.T
        MM[nv:, :nv] = A
        qq = np.concatenate([c, b])
        mask = jnp.ones(nv + ni, bool)
        z, ok = lcp.lcp_bpp(jnp.array(MM), jnp.array(qq), mask)
        zc, okc = lcp.solve_lcp(jnp.array(MM), jnp.array(qq), mask)
        assert bool(okc)
        check_solution(MM, qq, np.asarray(zc))
        if bool(ok):
            check_solution(MM, qq, np.asarray(z))

    def test_vmap_mixed_sizes(self):
        n, b = 7, 12
        Ms, qs, masks = [], [], []
        for s in range(b):
            M, q = random_monotone_lcp(n, 400 + s)
            Ms.append(M)
            qs.append(q)
            masks.append(jnp.arange(n) < (3 + s % 5))
        Ms, qs, masks = jnp.stack(Ms), jnp.stack(qs), jnp.stack(masks)
        zs, oks = jax.vmap(lcp.lcp_bpp)(Ms, qs, masks)
        assert bool(jnp.all(oks))
        for i in range(b):
            m = np.asarray(masks[i])
            check_solution(
                np.asarray(Ms[i])[m][:, m], np.asarray(qs[i])[m],
                np.asarray(zs[i])[m],
            )


def _batch_problems(B, n, seed):
    r = np.random.default_rng(seed)
    A = r.normal(size=(B, n, n))
    Ms = np.einsum("bij,bkj->bik", A, A) + 0.5 * np.eye(n)
    return Ms, r.normal(size=(B, n))


class TestSingleCascade:
    """`solve_lcp` is one route for every backend and dtype: under vmap, in
    f32, with skip gating and padding."""

    def test_f32_matches_f64(self):
        B, n = 5, 16
        Ms, qs = _batch_problems(B, n, 13)
        masks = jnp.ones((B, n), bool).at[:, 13:].set(False)
        skip = jnp.zeros(B, bool)

        def solve(dtype):
            return jax.vmap(
                lambda M, q, m, s: lcp.solve_lcp(M, q, m, z0=jnp.zeros_like(q),
                                                 skip=s)
            )(jnp.asarray(Ms, dtype), jnp.asarray(qs, dtype), masks, skip)

        z, ok = solve(jnp.float32)
        assert z.dtype == jnp.float32 and bool(jnp.all(ok))
        z_ref, ok_ref = solve(jnp.float64)
        assert bool(jnp.all(ok_ref))
        np.testing.assert_allclose(np.asarray(z), np.asarray(z_ref),
                                   atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(z)[:, 13:], 0.0)

    def test_skip_yields_zero(self):
        B, n = 3, 8
        Ms, qs = _batch_problems(B, n, 17)
        z, ok = jax.vmap(
            lambda M, q: lcp.solve_lcp(M, q, jnp.ones(n, bool),
                                       skip=jnp.array(True))
        )(jnp.asarray(Ms, jnp.float32), jnp.asarray(qs, jnp.float32))
        np.testing.assert_allclose(np.asarray(z), 0.0)
        assert not bool(jnp.any(ok))


class TestF32CascadeVsNative:
    """The cascade in f32 (the GPU execution dtype) against the native C++
    oracle in f64, at the sphere stack's LCP size (n=66) and on masked,
    padded problems."""

    @pytest.mark.parametrize("n,n_active,seed", [
        (66, 66, 0), (66, 66, 1), (66, 40, 2), (96, 57, 3)])
    def test_matches_native(self, n, n_active, seed):
        from moby_tpu import native

        r = np.random.default_rng(seed)
        A = r.normal(size=(n, n))
        M = A @ A.T / n + 0.5 * np.eye(n)
        q = r.normal(size=n)
        z_nat, ok_nat = native.lcp_solve(M[:n_active, :n_active], q[:n_active])
        assert ok_nat
        mask = jnp.arange(n) < n_active
        z, ok = jax.jit(lcp.solve_lcp)(jnp.asarray(M, jnp.float32),
                                       jnp.asarray(q, jnp.float32), mask)
        assert bool(ok) and z.dtype == jnp.float32
        z = np.asarray(z, np.float64)
        np.testing.assert_allclose(z[n_active:], 0.0)
        np.testing.assert_allclose(z[:n_active], z_nat,
                                   atol=1e-4 * max(1.0, np.abs(z_nat).max()))


class TestBlockedGJ:
    """The blocked Gauss–Jordan sub-solve: unrolled panels for small
    systems, a panel loop past `_GJ_UNROLL_PANELS`, identity padding when
    n is not a multiple of the panel width, and masked (inactive) slots."""

    @pytest.mark.parametrize("n,n_active", [(40, 40), (66, 50), (200, 200),
                                            (203, 170)])
    def test_matches_unblocked_and_lapack(self, n, n_active):
        r = np.random.default_rng(n)
        G = r.normal(size=(n, n))
        act = np.arange(n) < n_active
        M = G @ G.T / n + np.eye(n)
        A = np.where(act[:, None] & act[None, :], M, 0.0) + np.diag(~act)
        b = np.where(act, r.normal(size=n), 0.0)
        args = (jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
                jnp.asarray(act))
        x_blk, ok_blk = jax.jit(lcp.gj_solve_masked_blocked)(*args)
        x_gj, ok_gj = jax.jit(lcp.gj_solve_masked)(*args)
        assert bool(ok_blk) and bool(ok_gj) and x_blk.shape == (n,)
        x_ref = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(x_blk), x_ref, atol=2e-5)
        np.testing.assert_allclose(np.asarray(x_blk), np.asarray(x_gj),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(x_blk)[~act], 0.0)

    def test_singular_pivot_reported(self):
        n = 136  # 17 panels: the looped route
        A = jnp.eye(n, dtype=jnp.float32).at[100, 100].set(0.0)
        _, ok = lcp.gj_solve_masked_blocked(A, jnp.ones(n, jnp.float32),
                                            jnp.ones(n, bool))
        assert not bool(ok)
