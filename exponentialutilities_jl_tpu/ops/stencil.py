"""Constant-coefficient grid stencil operators — the speed-of-light matvec.

For PDE operators with constant stencil coefficients (Laplacians,
advection–diffusion on uniform grids — every BASELINE benchmark operator),
diagonal storage is wasteful: the (k, n) diagonal array stream dominates
SpMV traffic (7n values for a 7-point stencil). Storing only the k scalar
coefficients and applying shifts on the d-D grid eliminates that stream:

    y = Σ_k c_k · shift(x, offset_k)      (Dirichlet: pad zeros)

and every shift is an axis slice of the padded grid — XLA fuses the whole
stencil into one pass over x, so SpMV traffic is just x + y.

The flat vector interface is preserved (matvec takes/returns (n,)), so the
operator drops into every Krylov API unchanged.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.linop import LinearOperator
from .sparse import BandedOperator

__all__ = ["StencilOperator", "VariableStencilOperator",
           "laplacian_nd_stencil", "advection_diffusion_1d_stencil",
           "variable_diffusion_nd_stencil"]


@jax.tree_util.register_pytree_node_class
class StencilOperator(LinearOperator):
    """Constant-coefficient stencil on a d-dimensional grid.

    grid_shape: static tuple (s_0, …, s_{d-1}); the flat index is row-major
      (last axis fastest — matches the banded constructors in
      utils/testmatrices.py with x fastest).
    offsets: tuple of d-tuples, one per stencil point.
    coeffs: (k,) array of coefficients, same order as offsets.
    Boundary: Dirichlet truncation (out-of-grid neighbors read zero).
    """

    def __init__(self, grid_shape, offsets, coeffs, is_hermitian=False):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.coeffs = jnp.asarray(coeffs)
        self.is_hermitian = bool(is_hermitian)
        d = len(self.grid_shape)
        if any(len(off) != d for off in self.offsets):
            raise ValueError("each offset must have one entry per grid axis")

    @property
    def shape(self):
        n = math.prod(self.grid_shape)
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * math.prod(self.grid_shape)

    def matvec(self, x):
        X = x.reshape(self.grid_shape)
        h = [max(abs(off[a]) for off in self.offsets)
             for a in range(len(self.grid_shape))]
        Xp = jnp.pad(X, [(hh, hh) for hh in h])
        y = None
        for k, off in enumerate(self.offsets):
            sl = tuple(slice(h[a] + off[a], h[a] + off[a] + self.grid_shape[a])
                       for a in range(len(self.grid_shape)))
            term = self.coeffs[k] * Xp[sl]
            y = term if y is None else y + term
        return y.reshape(-1).astype(jnp.result_type(self.dtype, x.dtype))

    def opnorm_hint(self):
        return jnp.sum(jnp.abs(self.coeffs))

    def _gershgorin_real(self):
        """[c₀−r, c₀+r] Gershgorin enclosure of the spectrum's real
        parts: the diagonal is the zero-offset coefficient everywhere
        and every row's off-diagonal 1-norm is ≤ Σ|c_k| (boundary rows
        are smaller). Zero matvecs; shared by ``spectral_bounds_hint``
        and ``models/leja.real_interval``."""
        c = np.asarray(self.coeffs)
        diag = 0.0
        r = 0.0
        for k, off in enumerate(self.offsets):
            if all(o == 0 for o in off):
                diag += float(np.real(c[k]))
            else:
                r += float(abs(c[k]))
        return (diag - r, diag + r)

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure — Chebyshev actions
        (models/chebyshev.py); Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_banded(self) -> BandedOperator:
        """Equivalent diagonal-storage operator (for oracles/conversion)."""
        shape = self.grid_shape
        n = math.prod(shape)
        strides = np.cumprod((1,) + shape[:0:-1])[::-1]  # row-major strides
        idx = np.arange(n)
        coords = [(idx // strides[a]) % shape[a] for a in range(len(shape))]
        lin_offsets = []
        diags = []
        cnp = np.asarray(self.coeffs)
        for k, off in enumerate(self.offsets):
            o = int(sum(off[a] * strides[a] for a in range(len(shape))))
            valid = np.ones(n, dtype=bool)
            for a in range(len(shape)):
                ca = coords[a] + off[a]
                valid &= (ca >= 0) & (ca < shape[a])
            lin_offsets.append(o)
            diags.append(np.where(valid, cnp[k], 0))
        order = np.argsort(lin_offsets)
        return BandedOperator(
            jnp.asarray(np.stack([diags[i] for i in order])),
            [lin_offsets[i] for i in order],
            is_hermitian=self.is_hermitian)

    def tree_flatten(self):
        return (self.coeffs,), (self.grid_shape, self.offsets,
                                self.is_hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], children[0], is_hermitian=aux[2])


@jax.tree_util.register_pytree_node_class
class VariableStencilOperator(LinearOperator):
    """Variable-coefficient stencil on a d-dimensional grid.

    The sparsity pattern is a fixed stencil (one column offset set per
    row) but each stencil point carries a PER-CELL coefficient field —
    the ∇·(a(x)∇u) discretization class the reference exercises through
    generic SparseMatrixCSC operators (src/arnoldi.jl:182). Storage is
    (k, n): the same footprint as diagonal (DIA) storage, but organized
    on the grid so matvec is k fused shifted elementwise multiplies
    (XLA pad+slice — no gather).

    coeff_fields[k][cell] multiplies the neighbor at ``cell + offsets[k]``
    when forming row ``cell`` (out-of-grid neighbors read zero —
    Dirichlet truncation). Hermitian iff
    ``coeff_fields[k][i] == coeff_fields[k'][i + offsets[k]]`` for the
    paired offset k' = -k; the builders guarantee it and set
    ``is_hermitian``.
    """

    def __init__(self, grid_shape, offsets, coeff_fields,
                 is_hermitian=False):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        n = math.prod(self.grid_shape)
        C = jnp.asarray(coeff_fields)
        if C.ndim != 2 or C.shape != (len(self.offsets), n):
            C = C.reshape(len(self.offsets), n)
        self.coeff_fields = C
        self.is_hermitian = bool(is_hermitian)
        d = len(self.grid_shape)
        if any(len(off) != d for off in self.offsets):
            raise ValueError("each offset must have one entry per grid axis")

    @property
    def shape(self):
        n = math.prod(self.grid_shape)
        return (n, n)

    @property
    def dtype(self):
        return self.coeff_fields.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * math.prod(self.grid_shape)

    def matvec(self, x):
        shape = self.grid_shape
        X = x.reshape(shape)
        h = [max(abs(off[a]) for off in self.offsets)
             for a in range(len(shape))]
        Xp = jnp.pad(X, [(hh, hh) for hh in h])
        y = None
        for k, off in enumerate(self.offsets):
            sl = tuple(slice(h[a] + off[a], h[a] + off[a] + shape[a])
                       for a in range(len(shape)))
            term = self.coeff_fields[k].reshape(shape) * Xp[sl]
            y = term if y is None else y + term
        return y.reshape(-1).astype(
            jnp.result_type(self.dtype, x.dtype))

    def opnorm_hint(self):
        return jnp.max(jnp.sum(jnp.abs(self.coeff_fields), axis=0))

    def _gershgorin_real(self):
        """Per-row Gershgorin enclosure min_i(d_i−r_i), max_i(d_i+r_i)
        of the spectrum's real parts over the per-cell fields (one
        device reduction, fetched once). Shared by
        ``spectral_bounds_hint`` and ``models/leja.real_interval``."""
        diag_k = [k for k, off in enumerate(self.offsets)
                  if all(o == 0 for o in off)]
        d = (jnp.sum(jnp.real(self.coeff_fields[jnp.asarray(diag_k)]),
                     axis=0)
             if diag_k else jnp.zeros(self.coeff_fields.shape[1],
                                      jnp.finfo(self.dtype).dtype))
        off_k = [k for k in range(len(self.offsets)) if k not in diag_k]
        r = (jnp.sum(jnp.abs(self.coeff_fields[jnp.asarray(off_k)]), axis=0)
             if off_k else jnp.zeros_like(d))
        return (float(jnp.min(d - r)), float(jnp.max(d + r)))

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure — Chebyshev actions
        (models/chebyshev.py); Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_banded(self) -> BandedOperator:
        """Equivalent diagonal-storage operator (for oracles/conversion)."""
        shape = self.grid_shape
        n = math.prod(shape)
        strides = np.cumprod((1,) + shape[:0:-1])[::-1]
        idx = np.arange(n)
        coords = [(idx // strides[a]) % shape[a] for a in range(len(shape))]
        lin_offsets = []
        diags = []
        cnp = np.asarray(self.coeff_fields)
        for k, off in enumerate(self.offsets):
            o = int(sum(off[a] * strides[a] for a in range(len(shape))))
            valid = np.ones(n, dtype=bool)
            for a in range(len(shape)):
                ca = coords[a] + off[a]
                valid &= (ca >= 0) & (ca < shape[a])
            lin_offsets.append(o)
            diags.append(np.where(valid, cnp[k], 0))
        order = np.argsort(lin_offsets)
        return BandedOperator(
            jnp.asarray(np.stack([diags[i] for i in order])),
            [lin_offsets[i] for i in order],
            is_hermitian=self.is_hermitian)

    def tree_flatten(self):
        return (self.coeff_fields,), (self.grid_shape, self.offsets,
                                      self.is_hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], children[0], is_hermitian=aux[2])


def variable_diffusion_nd_stencil(a, dtype=None) -> VariableStencilOperator:
    """Cell-centered finite-volume ∇·(a∇u) on a d-D grid (Dirichlet).

    ``a`` is the (s_0, …, s_{d-1}) per-cell diffusivity field. Face
    coefficients are arithmetic means of the adjacent cells, so the
    off-diagonal field at cell i toward +e_a equals the field at cell
    i+e_a toward −e_a — the operator is symmetric by construction
    (``is_hermitian=True``). Boundary faces use the cell's own value
    (a Dirichlet ghost with matching diffusivity).
    """
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    shape = a.shape
    d = a.ndim
    offsets = [tuple([0] * d)]
    fields = [np.zeros_like(a)]
    diag = np.zeros_like(a)
    for ax in range(d):
        pad = [(0, 0)] * d
        pad[ax] = (1, 1)
        ap = np.pad(a, pad, mode="edge")
        lo = tuple(slice(0, shape[x]) if x != ax else slice(0, shape[ax])
                   for x in range(d))
        hi = tuple(slice(0, shape[x]) if x != ax else slice(2, shape[ax] + 2)
                   for x in range(d))
        w_minus = 0.5 * (a + ap[lo])     # face toward -e_ax
        w_plus = 0.5 * (a + ap[hi])      # face toward +e_ax
        diag -= w_minus + w_plus
        for s, w in ((-1, w_minus), (1, w_plus)):
            off = [0] * d
            off[ax] = s
            offsets.append(tuple(off))
            fields.append(w)
    fields[0] = diag
    C = np.stack([f.reshape(-1) for f in fields])
    return VariableStencilOperator(shape, offsets, jnp.asarray(C),
                                   is_hermitian=True)


def laplacian_nd_stencil(*shape, dtype=jnp.float64,
                         scale: float = 1.0) -> StencilOperator:
    """d-dimensional (2d+1)-point Laplacian stencil on ``shape`` (Dirichlet).

    ``laplacian_nd_stencil(nz, ny, nx)`` matches
    ``utils.testmatrices.laplacian_3d(nx, ny, nz)`` (x fastest)."""
    d = len(shape)
    offsets = [tuple([0] * d)]
    coeffs = [-2.0 * d * scale]
    for a in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[a] = s
            offsets.append(tuple(off))
            coeffs.append(scale)
    return StencilOperator(shape, offsets, jnp.asarray(coeffs, dtype=dtype),
                           is_hermitian=True)


def advection_diffusion_3d_stencil(nz: int, ny: int, nx: int,
                                   peclet: float = 10.0,
                                   dtype=jnp.float64) -> StencilOperator:
    """3-D diffusion + upwind x-advection, ∇²u + Pe·u_x, Dirichlet —
    the ASYMMETRIC constant 7-point operator of the non-Hermitian
    Leja/Faber drivers at scale. h = 1/(nx+1) along every axis."""
    h = 1.0 / (nx + 1)
    dcoef = 1.0 / h ** 2
    acoef = peclet / h
    offsets = [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
               (1, 0, 0), (-1, 0, 0)]
    coeffs = [-6.0 * dcoef - acoef, dcoef, dcoef + acoef,
              dcoef, dcoef, dcoef, dcoef]
    return StencilOperator((nz, ny, nx), offsets,
                           jnp.asarray(coeffs, dtype=dtype),
                           is_hermitian=False)


def advection_diffusion_1d_stencil(n: int, peclet: float = 10.0,
                                   dtype=jnp.float64) -> StencilOperator:
    """Constant-coefficient variant of
    utils.testmatrices.advection_diffusion_1d."""
    h = 1.0 / (n + 1)
    dcoef = 1.0 / h ** 2
    acoef = peclet / h
    return StencilOperator(
        (n,), ((-1,), (0,), (1,)),
        jnp.asarray([dcoef + acoef, -2.0 * dcoef - acoef, dcoef],
                    dtype=dtype),
        is_hermitian=False)
