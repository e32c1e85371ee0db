"""Halo exchange for spatially-sharded stencil computations.

When an image's rows are sharded over the 'space' mesh axis, stencil
ops (bad-pixel neighborhood medians, L.A.Cosmic Laplacians/medians,
demosaic convs, the separable warp's vertical pass) need each shard to
see a few rows of its neighbors.  This is the image-domain analogue of
ring/context parallelism (SURVEY.md §2.6 spatial row): neighbors
exchange boundary rows with ``jax.lax.ppermute`` inside a
``shard_map``, then the stencil runs locally, then the halos are
dropped.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def halo_exchange_rows(block: jnp.ndarray, halo: int,
                       axis_name: str = "space") -> jnp.ndarray:
    """Pad a row-sharded local block with ``halo`` rows from each
    neighbor (zero rows at the global edges).

    Must be called inside a shard_map over ``axis_name``.  Works on
    (..., H_local, W) arrays, exchanging along the second-to-last axis.
    """
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    top = block[..., :halo, :]      # rows this shard sends upward
    bot = block[..., -halo:, :]     # rows this shard sends downward
    # receive from the previous shard (its bottom rows become our top halo)
    from_prev = jax.lax.ppermute(
        bot, axis_name, [(i, (i + 1) % n) for i in range(n)])
    # receive from the next shard (its top rows become our bottom halo)
    from_next = jax.lax.ppermute(
        top, axis_name, [(i, (i - 1) % n) for i in range(n)])
    zeros = jnp.zeros_like(top)
    from_prev = jnp.where(idx == 0, zeros, from_prev)
    from_next = jnp.where(idx == n - 1, zeros, from_next)
    return jnp.concatenate([from_prev, block, from_next], axis=-2)


def sharded_map_overlap(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    mesh: Mesh,
    halo: int,
    axis_name: str = "space",
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Lift a stencil function to row-sharded inputs with halo exchange.

    ``fn`` maps an (H_local + 2*halo, W) padded block to an
    (H_local + 2*halo, W) block (same-shape stencil, e.g. a convolution
    or neighborhood median); the wrapper exchanges halos, applies fn,
    and crops the halo rows.  The result is numerically identical to
    applying fn on the unsharded image wherever fn's stencil radius is
    <= halo (guaranteed by construction for zero-padded edges).
    """

    def local(block):
        padded = halo_exchange_rows(block, halo, axis_name)
        out = fn(padded)
        return out[..., halo:-halo, :]

    return shard_map(local, mesh=mesh,
                     in_specs=P(axis_name, None),
                     out_specs=P(axis_name, None))
