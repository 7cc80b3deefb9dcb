"""End-use demo: exponential time integrators built on this library.

The reference is the compute backend for OrdinaryDiffEq's exponential
integrators (reference README.md:13-16); this example shows the same
patterns with the device-resident drivers:

1. Heat equation  u_t = Δu           — exact step via `expv`.
2. Reaction–diffusion u_t = Δu + N(u) — exponential Euler via `phiv`
   (u⁺ = φ₀(τΔ)u + τ·φ₁(τΔ)N(u)) and the 2nd-order ETDRK2-style
   corrector via `phiv_timestep` on the linearization.
3. The same heat step distributed over every local device
   (`expv_sharded`).

Run: PYTHONPATH=. python examples/exponential_integrators.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from exponentialutilities_jl_tpu import expv, laplacian_1d, phiv


def heat_equation():
    """u_t = κ Δu on [0,1], Dirichlet. The diffusion operator is stiff
    (τ‖A‖ ≈ 2·10⁵): a single fixed-m Krylov call cannot resolve it, which
    is exactly what the Niesen–Wright adaptive substepping driver is for
    (reference: src/krylov_phiv_adaptive.jl)."""
    from exponentialutilities_jl_tpu import expv_timestep

    n, kappa, T = 512, 1.0, 0.2
    h = 1.0 / (n + 1)
    A = laplacian_1d(n, scale=kappa / h**2)
    x = jnp.linspace(h, 1 - h, n)
    u0 = jnp.exp(-100 * (x - 0.5) ** 2)

    u = expv_timestep(T, A, u0, adaptive=True, tol=1e-8, m=30)
    # Analytic check: mode k of the discrete Laplacian decays as
    # exp(λ_k T), λ_k = 2κ(cos(kπh) − 1)/h².
    s1 = jnp.sin(jnp.pi * x)
    c0 = 2 * h * jnp.vdot(s1, u0)
    c1 = 2 * h * jnp.vdot(s1, u)
    lam1 = 2.0 * (jnp.cos(jnp.pi * h) - 1.0) / h**2 * kappa
    decay_exact = jnp.exp(lam1 * T)
    rel = abs(float(c1 / c0) - float(decay_exact)) / float(decay_exact)
    print(f"heat: mode-1 decay {float(c1/c0):.6f} vs exact "
          f"{float(decay_exact):.6f} (rel err {rel:.1e})")
    assert rel < 1e-5


def reaction_diffusion():
    """u_t = Δu + u(1-u) (Fisher-KPP), exponential Euler:
    u⁺ = φ₀(τA)u + τ φ₁(τA) N(u)."""
    n, tau, nsteps = 256, 1e-3, 20
    h = 1.0 / (n + 1)
    A = laplacian_1d(n, scale=1.0 / h**2)
    x = jnp.linspace(h, 1 - h, n)
    u = 0.5 * (1 + jnp.tanh(20 * (0.3 - x)))

    def N(u):
        return u * (1 - u)

    for _ in range(nsteps):
        W = phiv(tau, A, N(u), 1, m=30)     # [φ₀(τA)N(u), φ₁(τA)N(u)]
        u = expv(tau, A, u, m=30) + tau * W[:, 1]
    assert bool(jnp.all(jnp.isfinite(u)))
    assert float(u.max()) <= 1.05 and float(u.min()) >= -0.05
    print(f"reaction-diffusion: front at x≈"
          f"{float(x[int(jnp.argmin(jnp.abs(u - 0.5)))]):.3f}, "
          f"u ∈ [{float(u.min()):.4f}, {float(u.max()):.4f}]")


def distributed_heat():
    """The heat step sharded over all local devices."""
    from exponentialutilities_jl_tpu.parallel import expv_sharded, make_mesh

    ndev = len(jax.devices())
    n = 128 * ndev
    A = laplacian_1d(n, scale=float(n + 1) ** 2)
    u = jnp.exp(-100 * (jnp.linspace(0, 1, n) - 0.5) ** 2)
    w = expv_sharded(1e-1, A, u, make_mesh(), m=40)
    print(f"distributed heat: {ndev} device(s), ‖u⁺‖ = "
          f"{float(jnp.linalg.norm(w)):.6f}")
    assert bool(jnp.all(jnp.isfinite(w)))


if __name__ == "__main__":
    heat_equation()
    reaction_diffusion()
    distributed_heat()
    print("all examples ran")
