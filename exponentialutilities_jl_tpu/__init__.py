"""exponentialutilities_jl_tpu — a matrix-exponential / φ-function / Krylov
framework in JAX (XLA, shard_map, GSPMD), run on NVIDIA GPUs.

Brand-new implementation with the capabilities of SciML/ExponentialUtilities.jl
(the reference), designed for XLA: functional jit-compiled kernels with
static shapes, masked dynamic truncation, batched (CGS2) orthogonalization,
gather-free stencil matvecs, and shard_map row-partitioned distribution over
device meshes.

Public API (reference analogue: src/ExponentialUtilities.jl:64-72 exports):

Dense exponentials      expm (higham2005 | generic | diagonalization |
                        native | taylor — the solver-free engine)
Dense φ functions       phi (auto → Al-Mohy–Liu Padé at f64), phi_pade,
                        phi_taylor, phi_scalar, phiv_dense
Krylov subspaces        arnoldi, lanczos, KrylovBasis
Krylov actions          expv, expv_from_basis, phiv, phiv_from_basis
Taylor action           expv_taylor / expv_taylor_batched (Al-Mohy–Higham)
Time-stepping drivers   expv_timestep, phiv_timestep (two_pass for O(n)
                        memory), phiv_timestep_device (device-resident
                        adaptivity), kiops
Operators               LinearOperator, DenseOperator, DiagonalOperator,
                        MatrixFreeOperator, aslinearoperator; sparse:
                        SellOperator (gather SpMV), BlockELL,
                        Banded, Stencil
Distributed             parallel/ (shard_map + GSPMD; multi-host meshes)
"""

from .ops.expm_mp import expm_mp
from .ops.expm import (expm, expm_higham2005, expm_higham2005_batched,
                       expm_generic,
                       expm_diagonalization, expm_native, expm_taylor,
                       balance_matrix, gebal, expm_gebal)
from .ops.funm import funm, funm_schur_parlett
from .ops.phi_dense import (phi, phi_scalar, phi_taylor,
                            phi_taylor_batched, phi_with_info,
                            phiv_dense)
from .ops.phi_almohy import phi_pade, phi_pade_with_info
from .ops.expm_dd import expm_dd, DD
from .ops.phi_dd import phi_dd, phiv_dense_dd, expv_dd
from .ops.krylov import KrylovBasis, arnoldi, arnoldi_extend, lanczos
from .models.expv import (expv, expv_from_basis, build_subspace, make_expv,
                          expv_batched)
from .models.phiv import phiv, phiv_from_basis, make_phiv
from .models.nw_device import (phiv_timestep_device, expv_timestep_device)
from .models.timestepping import (expv_timestep, phiv_timestep,
                                  TimestepStats, phiv_timestep_fused,
                                  expv_timestep_fused, make_phiv_timestep)
from .models.kiops import kiops, KiopsStats, AugmentedOperator
from .models.integrators import (exprb32, exprb43, etdrk4,
                                 ExpIntStats, etdrk4_device,
                                 exprb43_device, exprb32_device)
from .models.kiops_device import kiops_device
from .models.expv_taylor import expv_taylor, expv_taylor_batched
from .models.chebyshev import (expv_chebyshev, phiv_chebyshev,
                               funm_chebyshev, chebyshev_apply,
                               spectral_bounds, phiv_timestep_chebyshev)
from .models.leja import (expv_leja, phiv_leja,
                          phiv_timestep_leja, leja_points,
                          real_interval)
from .models.faber import (expv_faber, phiv_faber, phiv_timestep_faber,
                           fov_ellipse, faber_coeffs)
from .utils.linop import (LinearOperator, DenseOperator, DiagonalOperator,
                          MatrixFreeOperator, JacobianOperator,
                          aslinearoperator)
from .ops.sparse import (SparseELLOperator, BlockELLOperator, BandedOperator,
                         SellOperator, SortedSellOperator,
                         HybridOperator, ell_from_scipy,
                         blockell_from_scipy, banded_from_scipy,
                         hybrid_from_scipy)
from .utils.testmatrices import (laplacian_1d, poisson_2d, laplacian_3d,
                                 advection_diffusion_1d)
from .ops.stencil import (StencilOperator, VariableStencilOperator,
                          laplacian_nd_stencil,
                          advection_diffusion_1d_stencil,
                          advection_diffusion_3d_stencil,
                          variable_diffusion_nd_stencil)

__version__ = "0.1.0"

__all__ = [
    "expm", "expm_mp", "expm_higham2005", "expm_higham2005_batched",
    "expm_generic", "expm_diagonalization",
    "expm_native", "expm_taylor", "balance_matrix", "gebal", "expm_gebal",
    "funm", "funm_schur_parlett",
    "phi", "phi_scalar", "phi_taylor", "phi_taylor_batched",
    "phi_pade", "phi_pade_with_info",
    "phi_with_info", "phiv_dense",
    "KrylovBasis", "arnoldi", "arnoldi_extend", "lanczos", "build_subspace",
    "expv", "expv_from_basis", "phiv", "phiv_from_basis",
    "make_expv", "make_phiv", "expv_batched",
    "expv_timestep", "phiv_timestep", "TimestepStats",
    "phiv_timestep_fused", "expv_timestep_fused", "make_phiv_timestep",
    "kiops", "kiops_device", "KiopsStats", "AugmentedOperator",
    "phiv_timestep_device", "expv_timestep_device", "expv_taylor", "expv_taylor_batched",
    "expv_chebyshev", "phiv_chebyshev", "funm_chebyshev", "chebyshev_apply",
    "spectral_bounds", "phiv_timestep_chebyshev", "expm_dd", "DD",
    "phi_dd", "phiv_dense_dd", "expv_dd",
    "expv_leja", "phiv_leja", "phiv_timestep_leja", "leja_points",
    "real_interval",
    "expv_faber", "phiv_faber", "phiv_timestep_faber", "fov_ellipse",
    "faber_coeffs",
    "LinearOperator", "DenseOperator", "DiagonalOperator",
    "MatrixFreeOperator", "JacobianOperator", "aslinearoperator",
    "exprb32", "exprb43", "etdrk4", "ExpIntStats",
    "etdrk4_device", "exprb43_device", "exprb32_device",
    "SparseELLOperator", "BlockELLOperator", "BandedOperator",
    "SellOperator", "SortedSellOperator", "HybridOperator",
    "ell_from_scipy", "blockell_from_scipy", "banded_from_scipy",
    "hybrid_from_scipy",
    "laplacian_1d", "poisson_2d", "laplacian_3d", "advection_diffusion_1d",
    "StencilOperator", "VariableStencilOperator",
    "laplacian_nd_stencil", "advection_diffusion_1d_stencil",
    "advection_diffusion_3d_stencil",
    "variable_diffusion_nd_stencil",
]
