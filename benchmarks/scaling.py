"""Per-step collective census of the sharded Krylov and Chebyshev steps.

Compiles the production sharded step on an N-device virtual CPU mesh in
both layouts (``make_global_mesh`` row-span, and ``make_host_data_mesh``
data×rows) and COUNTS the collectives in the optimized HLO (all-reduce /
collective-permute / all-gather / reduce-scatter per step). The counts
are the layout's communication signature: they do not change between
the CPU emulation and a mesh of GPUs.

Run:  python benchmarks/scaling.py
"""

from __future__ import annotations

import os
import re
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np


def collective_census(hlo_text: str) -> dict:
    """Count collective ops in optimized HLO.

    Counts are STATIC occurrences: the Krylov loop body is one called
    computation, so its collectives appear once each and execute once per
    Krylov iteration — i.e. the census is the per-iteration collective
    signature of the layout."""
    counts = {}
    for kind in ("all-reduce", "collective-permute", "all-gather",
                 "reduce-scatter", "all-to-all"):
        counts[kind] = len(re.findall(rf"\b{kind}-start|\b{kind}\(", hlo_text))
    return counts


def census_expv_step(n_per_dev: int = 64, m: int = 10, n_devices: int = 8):
    """Compile the production sharded expv step on the virtual mesh and
    return its collective census (per whole m-step solve)."""
    from exponentialutilities_jl_tpu import laplacian_1d
    from exponentialutilities_jl_tpu.parallel import (make_expv_step,
                                                      make_global_mesh,
                                                      shard_vector)

    mesh = make_global_mesh()                     # 1 host here → 1-D span
    n = n_per_dev * n_devices
    op = laplacian_1d(n, dtype=jnp.float32)
    step, diags = make_expv_step(op, mesh, m=m)
    b = shard_vector(jnp.ones((n,), jnp.float32), mesh)
    lowered = jax.jit(step).lower(jnp.float32(0.1), diags, b)
    hlo = lowered.compile().as_text()
    return collective_census(hlo)


def census_chebyshev(n_per_dev: int = 64, n_devices: int = 8):
    """Census of the sharded Chebyshev action: the recurrence has NO
    inner products, so the only collective should be the banded matvec's
    halo exchange (collective-permute) — zero all-reduces. This is the
    structurally-best-scaling action in the library (the Krylov step
    pays one all-reduce latency per iteration on top)."""
    import functools as ft

    from jax.sharding import PartitionSpec as P
    from exponentialutilities_jl_tpu import laplacian_1d
    from exponentialutilities_jl_tpu.models.chebyshev import (
        _chebyshev_apply_scan, _exp_ucoeffs)
    from exponentialutilities_jl_tpu.parallel import make_global_mesh
    from exponentialutilities_jl_tpu.parallel.krylov import _shard_op
    from exponentialutilities_jl_tpu.parallel.ops import shard_vector

    mesh = make_global_mesh()
    axis = mesh.axis_names[0]
    n = n_per_dev * n_devices
    op = laplacian_1d(n, dtype=jnp.float32)
    lo, hi = op.spectral_bounds_hint()
    c, h = 0.5 * (hi + lo), 0.5 * (hi - lo)
    cnp, sc = _exp_ucoeffs(0.5 * h, 1e-7)
    coeffs = jnp.asarray(cnp * np.exp(0.5 * c + sc), jnp.float32)
    params, make_local, pspec = _shard_op(op, mesh, axis)

    @jax.jit
    @ft.partial(jax.shard_map, mesh=mesh, in_specs=(pspec, P(axis)),
                out_specs=P(axis))
    def run(params_local, b_local):
        return _chebyshev_apply_scan(make_local(params_local), b_local,
                                     coeffs, c, 1.0 / h)

    b = shard_vector(jnp.ones((n,), jnp.float32), mesh)
    hlo = jax.jit(run).lower(params, b).compile().as_text()
    return collective_census(hlo)


def census_data_mesh(n_per_dev: int = 64, m: int = 10):
    """Census for the hosts×chips data×rows layout: the Krylov body must
    show ZERO collectives on the data (DCN) axis — data-parallel RHS."""
    from exponentialutilities_jl_tpu import (BandedOperator, expv_batched,
                                             laplacian_1d)
    from exponentialutilities_jl_tpu.parallel import make_host_data_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_host_data_mesh(n_hosts=2)         # virtual 2 "hosts" × 4
    nrows = n_per_dev * mesh.shape["shard"]
    op = laplacian_1d(nrows, dtype=jnp.float32)
    diags_s = jax.device_put(op.diags, NamedSharding(mesh, P(None, "shard")))
    op_s = BandedOperator(diags_s, op.offsets, is_hermitian=True)
    B = jax.device_put(jnp.ones((4, nrows), jnp.float32),
                       NamedSharding(mesh, P("data", "shard")))
    fn = jax.jit(lambda B: expv_batched(0.1, op_s, B, m=m))
    hlo = fn.lower(B).compile().as_text()
    return collective_census(hlo)


def main():
    print("== collective census: row-span layout (make_global_mesh) ==")
    c1 = census_expv_step()
    print(c1)
    print("== collective census: data x rows layout (make_host_data_mesh) ==")
    c2 = census_data_mesh()
    print(c2)
    print("== collective census: sharded Chebyshev action ==")
    c3 = census_chebyshev()
    print(c3, "(zero all-reduce: no inner products in the recurrence)")

if __name__ == "__main__":
    sys.exit(main())
