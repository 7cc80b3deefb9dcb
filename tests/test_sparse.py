"""Sparse containers (ELL / block-ELL / banded) and their XLA SpMVs.

Oracle pattern follows the reference's tests: sparse operators are validated
against dense equivalents, then driven through the Krylov stack
(reference: test/basictests.jl:670, test/gpu/gputests.jl:41-58).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from exponentialutilities_jl_tpu import (
    BandedOperator, BlockELLOperator, SparseELLOperator,
    blockell_from_scipy, ell_from_scipy, expv,
    laplacian_1d, poisson_2d, laplacian_3d, advection_diffusion_1d,
)


def _random_sparse(rng, n, density=0.1):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(7),
                  format="csr")
    A.setdiag(rng.standard_normal(n))
    return A.tocsr()


class TestELL:
    def test_matvec_vs_dense(self, rng):
        A = _random_sparse(rng, 50)
        op = ell_from_scipy(A)
        x = rng.standard_normal(50)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), A @ x,
                                   rtol=1e-12)

    def test_from_dense_roundtrip(self, rng):
        Ad = np.zeros((12, 12))
        Ad[2, 3] = 1.5
        Ad[5, 5] = -2.0
        Ad[11, 0] = 0.25
        op = SparseELLOperator.from_dense(Ad)
        np.testing.assert_allclose(op.to_dense(), Ad)

    def test_opnorm_hint(self, rng):
        A = _random_sparse(rng, 40)
        op = ell_from_scipy(A)
        dense = A.toarray()
        inf_norm = np.abs(dense).sum(axis=1).max()
        assert float(op.opnorm_hint()) == pytest.approx(inf_norm)


class TestBlockELL:
    def test_matvec_vs_dense(self, rng):
        n, br = 32, 4
        Ad = np.kron(np.asarray(sp.random(n // br, n // br, density=0.3,
                                          random_state=np.random.RandomState(3)
                                          ).toarray() != 0, float),
                     np.ones((br, br))) * rng.standard_normal((n, n))
        op = BlockELLOperator.from_dense(Ad, br)
        x = rng.standard_normal(n)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), Ad @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_from_scipy(self, rng):
        A = _random_sparse(rng, 48)
        op = blockell_from_scipy(A, br=4)
        x = rng.standard_normal(48)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), A @ x,
                                   rtol=1e-12, atol=1e-12)

    def test_f32_matvec(self, rng):
        n, br = 64, 8
        A = _random_sparse(rng, n).toarray()
        op = BlockELLOperator.from_dense(A.astype(np.float32), br)
        x = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
        y = op.matvec(x)
        np.testing.assert_allclose(y, A.astype(np.float32) @ np.asarray(x),
                                   rtol=1e-4, atol=1e-4)


class TestBanded:
    def test_laplacian_1d(self, rng):
        op = laplacian_1d(20)
        dense = np.asarray(op.to_dense())
        expected = (np.diag(-2 * np.ones(20)) + np.diag(np.ones(19), 1)
                    + np.diag(np.ones(19), -1))
        np.testing.assert_allclose(dense, expected)
        x = rng.standard_normal(20)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), expected @ x,
                                   rtol=1e-12)

    def test_poisson_2d_symmetric(self, rng):
        op = poisson_2d(5, 4)
        dense = np.asarray(op.to_dense())
        np.testing.assert_allclose(dense, dense.T)
        assert dense.trace() == pytest.approx(-4.0 * 20)
        x = rng.standard_normal(20)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), dense @ x,
                                   rtol=1e-12)

    def test_laplacian_3d(self, rng):
        op = laplacian_3d(3, 4, 2)
        dense = np.asarray(op.to_dense())
        np.testing.assert_allclose(dense, dense.T)
        x = rng.standard_normal(24)
        np.testing.assert_allclose(op.matvec(jnp.asarray(x)), dense @ x,
                                   rtol=1e-12)

    def test_to_ell_matches(self, rng):
        op = advection_diffusion_1d(30)
        ell = op.to_ell()
        x = jnp.asarray(rng.standard_normal(30))
        np.testing.assert_allclose(ell.matvec(x), op.matvec(x), rtol=1e-12)

    def test_from_dense_auto_offsets(self, rng):
        A = np.diag(rng.standard_normal(10)) + np.diag(rng.standard_normal(7), 3)
        op = BandedOperator.from_dense(A)
        np.testing.assert_allclose(op.to_dense(), A, atol=1e-14)


class TestSparseKrylov:
    """Sparse operators through the Krylov stack vs dense oracles."""

    def test_expv_laplacian_ell(self, rng):
        import scipy.linalg as sla
        op = laplacian_1d(64).to_ell()
        b = rng.standard_normal(64)
        w = expv(0.5, op, jnp.asarray(b), m=40, hermitian=True)
        oracle = sla.expm(0.5 * np.asarray(laplacian_1d(64).to_dense())) @ b
        np.testing.assert_allclose(w, oracle, rtol=1e-9, atol=1e-10)

    def test_expv_banded_hermitian(self, rng):
        import scipy.linalg as sla
        op = poisson_2d(8, 8)
        b = rng.standard_normal(64)
        w = expv(0.1, op, jnp.asarray(b), m=40)
        oracle = sla.expm(0.1 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(w, oracle, rtol=1e-9, atol=1e-10)

    def test_expv_advection_diffusion(self, rng):
        import scipy.linalg as sla
        op = advection_diffusion_1d(50, peclet=5.0)
        b = rng.standard_normal(50)
        w = expv(1e-3, op, jnp.asarray(b), m=45)
        oracle = sla.expm(1e-3 * np.asarray(op.to_dense())) @ b
        np.testing.assert_allclose(w, oracle, rtol=1e-8, atol=1e-9)


class TestStencil:
    """Constant-coefficient stencil operators (ops/stencil.py) vs banded."""

    def test_3d_matches_banded(self, rng):
        from exponentialutilities_jl_tpu import (laplacian_3d,
                                                 laplacian_nd_stencil)
        st = laplacian_nd_stencil(4, 5, 3)       # (nz, ny, nx)
        bd = laplacian_3d(3, 5, 4)               # (nx, ny, nz)
        x = jnp.asarray(rng.standard_normal(60))
        np.testing.assert_allclose(np.asarray(st.matvec(x)),
                                   np.asarray(bd.matvec(x)), rtol=1e-13,
                                   atol=1e-13)

    def test_to_banded_roundtrip(self, rng):
        from exponentialutilities_jl_tpu import laplacian_nd_stencil
        st = laplacian_nd_stencil(6, 4)
        bd = st.to_banded()
        x = jnp.asarray(rng.standard_normal(24))
        np.testing.assert_allclose(np.asarray(st.matvec(x)),
                                   np.asarray(bd.matvec(x)), rtol=1e-13,
                                   atol=1e-13)

    def test_advdiff_matches(self, rng):
        from exponentialutilities_jl_tpu import (
            advection_diffusion_1d, advection_diffusion_1d_stencil)
        st = advection_diffusion_1d_stencil(40, peclet=3.0)
        bd = advection_diffusion_1d(40, peclet=3.0)
        x = jnp.asarray(rng.standard_normal(40))
        np.testing.assert_allclose(np.asarray(st.matvec(x)),
                                   np.asarray(bd.matvec(x)), rtol=1e-12,
                                   atol=1e-9)

    def test_expv_through_stencil(self, rng):
        import scipy.linalg as sla
        from exponentialutilities_jl_tpu import expv, laplacian_nd_stencil
        st = laplacian_nd_stencil(8, 8)
        b = rng.standard_normal(64)
        w = expv(0.1, st, jnp.asarray(b), m=40)
        dense = np.asarray(st.to_banded().to_dense())
        np.testing.assert_allclose(np.asarray(w), sla.expm(0.1 * dense) @ b,
                                   rtol=1e-9, atol=1e-10)

    def test_banded_f32_matvec_matches_dense(self, rng):
        """f32 BandedOperator.matvec vs the to_dense oracle."""
        from exponentialutilities_jl_tpu import poisson_2d
        op = poisson_2d(16, 8, dtype=jnp.float32)
        x = jnp.asarray(rng.standard_normal(128), jnp.float32)
        dense = np.asarray(op.to_dense())
        np.testing.assert_allclose(np.asarray(op.matvec(x)),
                                   dense @ np.asarray(x), rtol=1e-5,
                                   atol=1e-4)
