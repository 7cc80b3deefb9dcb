"""AD through the action layer (expv / phiv / Chebyshev apply).

The reference tests end-to-end ForwardDiff through its generic exp
(reference: test/basictests.jl:121-134). The JAX analogue must hold
one level higher: gradients THROUGH the Krylov actions w.r.t. the time
scalar and the operator's coefficient fields (operators are pytrees, so
stencil coefficients are differentiable leaves). Every gradient here is
checked against central finite differences.

Reverse-AD contract (documented in docs/choosing.md):
  * ``expv`` / ``phiv`` default (happy_breakdown) path: scan/fori_loop
    based — forward- and reverse-differentiable.
  * ``chebyshev_apply`` with fixed coefficients: a ``lax.scan`` — reverse-
    differentiable w.r.t. b and operator fields. (The DCT coefficient
    construction is host-side numpy, so t is NOT a differentiable input
    of expv_chebyshev by design.)
  * ``expv(mode="error_estimate")``: a ``lax.while_loop`` — NOT
    reverse-differentiable (JAX limitation); must fail loudly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import exponentialutilities_jl_tpu as eu


def _fd(f, x, E, eps):
    return (f(x + eps * E) - f(x - eps * E)) / (2 * eps)


def _check_grad(f, x, rng, eps=1e-6, rtol=2e-4):
    g = jax.grad(f)(x)
    E = jnp.asarray(rng.standard_normal(np.shape(x)) if np.ndim(x) else 1.0)
    fd = _fd(f, x, E, eps)
    got = float(jnp.real(jnp.vdot(g, E)))
    want = float(fd)
    assert abs(got - want) < rtol * max(1.0, abs(want)), (got, want)


class TestExpvGrad:
    def test_grad_wrt_t(self, rng):
        n = 24
        M = rng.standard_normal((n, n))
        A = jnp.asarray(-(M @ M.T) / n - np.eye(n))
        b = jnp.asarray(rng.standard_normal(n))

        def f(t):
            w = eu.expv(t, A, b, m=n, reduced="device")
            return jnp.sum(w ** 2)

        _check_grad(f, jnp.asarray(0.7), rng)

    def test_grad_wrt_dense_operator(self, rng):
        n = 16
        M = rng.standard_normal((n, n))
        A = jnp.asarray(-(M @ M.T) / n - np.eye(n))
        b = jnp.asarray(rng.standard_normal(n))

        def f(A_):
            w = eu.expv(0.5, A_, b, m=n, hermitian=True, reduced="device")
            return jnp.sum(w ** 2)

        _check_grad(f, A, rng)

    def test_grad_wrt_stencil_coefficients(self, rng):
        # Operator fields are pytree leaves: differentiate through the
        # banded matvec inside the Krylov build.
        n = 48
        op0 = eu.laplacian_1d(n)
        b = jnp.asarray(rng.standard_normal(n))
        from exponentialutilities_jl_tpu.ops.sparse import BandedOperator

        def f(diags):
            op = BandedOperator(diags, op0.offsets, is_hermitian=True)
            w = eu.expv(0.3, op, b, m=20, reduced="device")
            return jnp.sum(w ** 2)

        _check_grad(f, op0.diags, rng)

    def test_grad_wrt_t_nonhermitian_iop(self, rng):
        n = 32
        op = eu.advection_diffusion_1d(n, peclet=5.0)
        b = jnp.asarray(rng.standard_normal(n))

        def f(t):
            w = eu.expv(t, op, b, m=24, iop=4, hermitian=False,
                        reduced="device", differentiable=True)
            return jnp.sum(w ** 2)

        _check_grad(f, jnp.asarray(0.02), rng)

    def test_error_estimate_mode_not_reverse_differentiable(self, rng):
        # while_loop-based: reverse AD must fail loudly, not silently
        # return wrong gradients.
        n = 16
        M = rng.standard_normal((n, n))
        A = jnp.asarray(-(M @ M.T) / n - np.eye(n))
        b = jnp.asarray(rng.standard_normal(n))

        def f(t):
            w = eu.expv(t, A, b, m=n, mode="error_estimate")
            return jnp.sum(w ** 2)

        with pytest.raises(ValueError):
            jax.grad(f)(jnp.asarray(0.5))


class TestPhivGrad:
    def test_grad_wrt_t(self, rng):
        n = 20
        M = rng.standard_normal((n, n))
        A = jnp.asarray(-(M @ M.T) / n - np.eye(n))
        b = jnp.asarray(rng.standard_normal(n))

        def f(t):
            W = eu.phiv(t, A, b, 2, m=n, reduced="device",
                        differentiable=True)
            return jnp.sum(W ** 2)

        _check_grad(f, jnp.asarray(0.6), rng)


class TestChebyshevGrad:
    def _setup(self, rng, t, n=64, tol=1e-12):
        from exponentialutilities_jl_tpu.models.chebyshev import (
            _full_exp_coeffs)
        op = eu.laplacian_1d(n)
        b = jnp.asarray(rng.standard_normal(n))
        lo, hi = op.spectral_bounds_hint()
        coeffs, _, _ = _full_exp_coeffs(t, lo, hi, tol, None)
        return op, b, (lo, hi), jnp.asarray(coeffs)

    def test_grad_wrt_b(self, rng):
        from exponentialutilities_jl_tpu.models.chebyshev import (
            chebyshev_apply)
        op, b, bounds, coeffs = self._setup(rng, 0.1)

        def f(b_):
            return jnp.sum(chebyshev_apply(op, b_, coeffs, bounds) ** 2)

        _check_grad(f, b, rng)

    def test_grad_wrt_stencil_coefficients(self, rng):
        from exponentialutilities_jl_tpu.models.chebyshev import (
            chebyshev_apply)
        from exponentialutilities_jl_tpu.ops.sparse import BandedOperator
        op, b, bounds, coeffs = self._setup(rng, 0.1)

        def f(diags):
            op_ = BandedOperator(diags, op.offsets, is_hermitian=True)
            return jnp.sum(chebyshev_apply(op_, b, coeffs, bounds) ** 2)

        _check_grad(f, op.diags, rng)

    def test_grad_matches_dense_oracle(self, rng):
        # d/db of exp(tA)b against the dense expm directional derivative.
        from exponentialutilities_jl_tpu.models.chebyshev import (
            chebyshev_apply)
        t = 0.2
        op, b, bounds, coeffs = self._setup(rng, t, n=32, tol=1e-13)
        v = jnp.asarray(rng.standard_normal(32))

        def f(b_):
            return jnp.vdot(v, chebyshev_apply(op, b_, coeffs, bounds))

        g = jax.grad(f)(b)
        import scipy.linalg as sla
        E = sla.expm(t * np.asarray(op.to_dense()))
        np.testing.assert_allclose(np.asarray(g), E.T @ np.asarray(v),
                                   rtol=1e-8, atol=1e-10)
