"""Matmul-precision control.

On an NVIDIA GPU, XLA may run a float32 matrix product on the tensor
cores in TF32, which keeps about three decimal digits — fine for neural
nets, far too coarse for a numerics library (a degree-13 Padé exp or a
CGS2 Gram product would lose the f32 tolerances). Every compute-path
function in this package is wrapped with ``mxu_full_precision`` so its
matmuls are traced under ``jax.default_matmul_precision("highest")``:
true float32 (and float64) products, on any backend.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["mxu_full_precision"]


def mxu_full_precision(fn):
    """Decorator: trace ``fn`` with matmul precision 'highest'."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
