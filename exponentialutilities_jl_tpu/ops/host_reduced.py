"""Host-evaluated reduced problems (float64 LAPACK between device programs).

The reference's Krylov design keeps the O(n) basis on the accelerator and
the O(m²) reduced Hessenberg problem on host LAPACK
(src/arnoldi.jl:293-296, src/krylov_phiv.jl:196-205). ``reduced="host"``
(expv, phiv, phiv_timestep, kiops) selects the same split here; the
default, ``reduced="device"``, keeps the reduced problem on the device.

These helpers run **between** jitted device programs — the m×m Hessenberg
is fetched to host (one tiny transfer), exponentiated with scipy in full
f64/c128, and the resulting m-vector/matrix is shipped back for the jitted
basis combination. No ``pure_callback`` is used. The cost is one
device↔host round-trip per solve.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["host_expm", "host_expm_e1", "host_phiv_e1",
           "host_phi"]


def _hdt(dt):
    return np.complex128 if jnp.issubdtype(dt, jnp.complexfloating) else np.float64


def host_expm(M, out_dtype=None):
    """exp(M) for a small (possibly device) matrix, on host in f64/c128."""
    import scipy.linalg as sla

    Mh = np.asarray(M)
    dt = out_dtype or Mh.dtype
    return sla.expm(Mh.astype(_hdt(dt))).astype(dt)


def host_expm_e1(H, t, out_dtype=None):
    """First column of exp(t·H), host f64/c128, as a jnp array."""
    import scipy.linalg as sla

    Hh = np.asarray(H)
    th = np.asarray(t)
    dt = out_dtype or np.result_type(Hh.dtype, th.dtype)
    col = sla.expm((th * Hh).astype(_hdt(dt)))[:, 0]
    return jnp.asarray(col.astype(dt))


def host_phiv_e1(H, t, k: int, out_dtype=None):
    """[φ_0(tH)e₁ … φ_k(tH)e₁] (m, k+1), host f64/c128, via the Sidje
    augmented matrix (same construction as ops/phi_dense.phiv_dense)."""
    import scipy.linalg as sla

    Hh = np.asarray(H)
    th = np.asarray(t)
    dt = out_dtype or np.result_type(Hh.dtype, th.dtype)
    hdt = _hdt(dt)
    m = Hh.shape[0]
    M = (th * Hh).astype(hdt)
    if k == 0:
        return jnp.asarray(sla.expm(M)[:, :1].astype(dt))
    Aug = np.zeros((m + k, m + k), dtype=hdt)
    Aug[:m, :m] = M
    Aug[0, m] = 1.0                       # v = e₁ column
    for i in range(k - 1):
        Aug[m + i, m + i + 1] = 1.0
    P = sla.expm(Aug)
    C = np.empty((m, k + 1), dtype=hdt)
    C[:, 0] = P[:m, 0]                    # φ_0(tH) e₁
    C[:, 1:] = P[:m, m:m + k]
    return jnp.asarray(C.astype(dt))


def host_phi(A, k: int, out_dtype=None):
    """Full dense φ stack [φ_0(A), …, φ_k(A)] (k+1, n, n) on the HOST in
    f64/c128, via the block-matrix identity (Sidje Thm 1 / Al-Mohy–Liu
    Thm 2.1; the same construction tests/test_phi.py uses as its
    independent oracle):

        exp([[A, E], [0, K]])[:n, n+(j-1)n : n+jn] = φ_j(A),
        E = [I 0 … 0],  K the k·n-sized block-nilpotent shift.

    A host-staged route to dense f64 φ and a convenient oracle; on the
    device use ``phi(..., method="pade")`` instead — this helper costs
    one expm of a (k+1)n-sized matrix on the host. Reference context: the reference
    runs its Padé LU at f64 on every backend (src/phi_almohy.jl:456-507).
    """
    import scipy.linalg as sla

    Ah = np.asarray(A)
    n = Ah.shape[0]
    dt = out_dtype or Ah.dtype
    hdt = _hdt(dt)
    Ah = Ah.astype(hdt)
    if k == 0:
        return jnp.asarray(sla.expm(Ah)[None].astype(dt))
    E = np.zeros((n, k * n), dtype=hdt)
    E[:, :n] = np.eye(n)
    K = np.zeros((k * n, k * n), dtype=hdt)
    for j in range(k - 1):
        K[j * n:(j + 1) * n, (j + 1) * n:(j + 2) * n] = np.eye(n)
    P = sla.expm(np.block([[Ah, E], [np.zeros((k * n, n), hdt), K]]))
    out = np.empty((k + 1, n, n), dtype=hdt)
    out[0] = P[:n, :n]
    for j in range(1, k + 1):
        out[j] = P[:n, n + (j - 1) * n:n + j * n]
    return jnp.asarray(out.astype(dt))
