"""Which implementation of each product runs, chosen from what the
program can observe: the platform JAX computes on, the model's dtype and
the occupancy of its grid.  No user option makes these choices; tests
steer them by monkeypatching ``jax.default_backend``.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def compute_dtype(dtype='auto'):
    """Resolve a dtype preset.

    * ``'auto'`` (or None): float32 on an accelerator — the compacted-tile
      path of :func:`use_tiles` and a float32/complex64 uv chain — and
      float64 on the CPU, where the parity tests run.
    * ``'parity'``: always float64.

    Explicit dtypes pass through untouched.
    """
    if dtype in ('auto', None):
        return jnp.float32 if jax.default_backend() != 'cpu' \
            else jnp.float64
    if dtype == 'parity':
        return jnp.float64
    return dtype


def use_tiles(dtype, count_tiles: Callable[[], int]) -> bool:
    """Whether the per-epoch RT products (continuum epoch maps, RRL cube,
    emergent scan) run on the compacted jet-occupied tiles: a float32
    model whose grid holds any jet cell, on any platform.  float64 models
    keep the full-cube XLA forms, the parity references.
    ``count_tiles`` is called only for float32 models (it costs a pass
    over the grid)."""
    return jnp.dtype(dtype) == jnp.float32 and count_tiles() > 0


def use_triton_rrl() -> bool:
    """Whether the RRL tile partials run through the Triton-route Pallas
    kernel (ops.rrl_tiles.rrl_tiles_pallas): on a GPU.  Elsewhere the
    same arithmetic runs as plain XLA."""
    return jax.default_backend() == 'gpu'
