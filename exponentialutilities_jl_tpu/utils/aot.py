"""Ahead-of-time warmup — the JAX analogue of the reference's precompile
workload (reference: src/precompile.jl:1-55) — and the persistent
compilation cache.

The reference precompiles `exponential!`, `expv`, `phiv` for Float64 so the
first user call is fast; here the equivalent cost is XLA compilation, paid
once per (shape, dtype, static-config) signature. ``warmup`` traces and
compiles the hot entry points for the signatures you expect to serve, so
production first-call latency is data-transfer only. ``use_compile_cache``
keeps compiled programs on disk across processes.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = ["warmup", "use_compile_cache", "DEFAULT_CACHE_DIR"]

# Fixed path inside the checkout (listed in .gitignore): the cache key
# includes the directory, so a path that moved between runs never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    no other directory is configured; otherwise the cache lives in
    ``DEFAULT_CACHE_DIR``. Every compiled program is cached, however fast
    its compile."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def warmup(n: int = 64, m: int = 30, k: int = 2, dtype=jnp.float32,
           hermitian: bool = True, dense: bool = True,
           mesh=None) -> dict:
    """Compile the expm/expv/phiv pipelines for one signature.

    Returns a dict of the compiled outputs (all tiny) so callers can
    block_until_ready if they want a hard barrier. With ``mesh`` set, also
    compiles the sharded expv step for that mesh.
    """
    from .. import expm, expv, phiv
    from .testmatrices import laplacian_1d
    from ..utils.linop import DenseOperator

    out = {}
    b = jnp.ones((n,), dtype=dtype)
    if dense:
        A = jnp.eye(min(n, 128), dtype=dtype)
        out["expm"] = expm(A)
    if hermitian:
        op = laplacian_1d(n, dtype=dtype)
    else:
        op = DenseOperator(jnp.eye(n, dtype=dtype), is_hermitian=False)
    out["expv"] = expv(0.1, op, b, m=min(m, n))
    out["phiv"] = phiv(0.1, op, b, k, m=min(m, n))
    # round-2 serving surfaces: device-resident adaptive drivers
    from .. import kiops_device, phiv_timestep_device
    out["nw_device"] = phiv_timestep_device(
        0.1, op, b[:, None], m=min(m, n), hermitian=hermitian)
    out["kiops_device"], _ = kiops_device(
        [0.1], op, b[:, None], m=min(max(10, m // 2), n))
    # polynomial (reduction-free) actions — Chebyshev (Hermitian path)
    if hermitian:
        from .. import expv_chebyshev, phiv_timestep_chebyshev
        out["expv_chebyshev"] = expv_chebyshev(0.1, op, b, tol=1e-6)
        out["phiv_timestep_chebyshev"] = phiv_timestep_chebyshev(
            0.1, op, jnp.ones((n, k + 1), dtype=dtype), tol=1e-6)
    if mesh is not None:
        from ..parallel import make_expv_step, shard_vector
        step, diags = make_expv_step(op, mesh, m=min(m, n))
        out["expv_sharded"] = step(jnp.asarray(0.1, dtype=dtype), diags,
                                   shard_vector(b, mesh))
    jax.block_until_ready(out)
    return out
