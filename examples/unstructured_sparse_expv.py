"""Example: exp(tA)b on an unstructured sparse matrix with SellOperator.

Pipeline: scipy matrix → RCM permutation (native C++) → SELL-window pack
→ XLA gather SpMV inside the Lanczos expv, all in the permuted
basis. Runs unchanged on the CPU and on a GPU (XLA gather SpMV).

  PYTHONPATH=. python examples/unstructured_sparse_expv.py
"""

import numpy as np
import scipy.sparse as sp

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import exponentialutilities_jl_tpu as eu


def random_local_graph(n, deg, band, rng, scrambled=True):
    """A random graph with local structure (what a mesh/kNN graph looks
    like), optionally scrambled so RCM has real work to do."""
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-band // 2, band // 2, n * deg),
                   0, n - 1)
    vals = rng.standard_normal(n * deg) / deg
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = 0.5 * (A + A.T)                      # Hermitian for Lanczos
    if scrambled:
        p = rng.permutation(n)
        A = A.tocsr()[p][:, p]
    return A.tocoo()


def main():
    rng = np.random.default_rng(0)
    n = 20_000
    A = random_local_graph(n, 8, 400, rng)

    # RCM-permute + SELL-pack in one step; the operator acts in the
    # permuted basis (op.perm maps new -> old).
    op = eu.SellOperator.from_coo(A.row, A.col, A.data, n, rcm=True,
                                  window=2048, is_hermitian=True,
                                  dtype=np.float64)
    print(f"packed: nnz={op.nnz}, tiles={op.data.vals.shape[0]}, "
          f"fill={op.nnz / op.data.vals.size:.2f}")

    b = rng.standard_normal(n)
    bp = jnp.asarray(b[op.perm])             # into permuted space
    w_p = eu.expv(0.5, op, bp, m=40)
    w = np.empty(n)
    w[op.perm] = np.asarray(w_p)             # back to original order

    # oracle via scipy expm_multiply
    from scipy.sparse.linalg import expm_multiply
    want = expm_multiply(0.5 * A.tocsr(), b)
    rel = np.linalg.norm(w - want) / np.linalg.norm(want)
    print(f"expv vs scipy expm_multiply: rel err {rel:.2e}")

    # Device-resident adaptive driver on the same operator
    U, stats = eu.expv_timestep_device(1.0, op, bp, hermitian=True,
                                       tol=1e-8, return_stats=True)
    print(f"device-resident NW: steps={stats.steps} "
          f"rejections={stats.rejections} m={stats.final_m} "
          f"info={stats.info}")


if __name__ == "__main__":
    main()
