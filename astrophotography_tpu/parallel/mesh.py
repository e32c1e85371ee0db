"""Mesh construction and sharding helpers.

Standard recipe (scaling-book style): build a Mesh over the available
devices, annotate array shardings with NamedSharding/PartitionSpec, jit
the pure pipeline functions, and let XLA insert the collectives.  The
two axes used throughout this framework:

* ``frame`` — the stack axis; calibration/detection/warping are
  embarrassingly parallel over it (SURVEY.md §2.6 frame parallelism);
* ``space`` — image rows; used for the cross-frame combine and for
  frames too large for one device's memory (spatial parallelism with halo
  exchange for stencils).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def frame_space_mesh(
    n_frame: Optional[int] = None,
    n_space: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D (frame, space) mesh over the given devices.

    With no arguments, uses all devices on the frame axis (the common
    stacking configuration: more frames than chips, frames cheap to
    shard, one all-to-all before the combine).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_frame is None and n_space is None:
        n_frame, n_space = n, 1
    elif n_frame is None:
        n_frame = n // n_space
    elif n_space is None:
        n_space = n // n_frame
    if n_frame * n_space != n:
        raise ValueError(
            f"mesh {n_frame}x{n_space} does not match {n} devices")
    return Mesh(np.array(devices).reshape(n_frame, n_space),
                ("frame", "space"))


def shard_frames(mesh: Mesh) -> NamedSharding:
    """(N, H, W) stack: frames over 'frame', rows over 'space'."""
    return NamedSharding(mesh, P("frame", "space", None))


def shard_spatial(mesh: Mesh) -> NamedSharding:
    """(H, W) image: rows over 'space' (replicated over 'frame')."""
    return NamedSharding(mesh, P("space", None))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_calibrate_register_stack(mesh: Mesh, config):
    """``calibrate_register_stack`` jitted over every device of ``mesh``.

    Frames shard over all mesh axes for calibrate/detect/warp (each
    device holds N/devices whole frames); the stacked output is
    constrained to row shards over all mesh axes, so XLA reshards the
    warped stack from frames to rows for the cross-frame combine.
    Masters and exposure ratios are replicated.  Returns a function of
    (frames, bias, dark, flat, exp_ratios) -> (stacked, diagnostics).
    """
    from ..models.pipeline import calibrate_register_stack

    axes = tuple(mesh.axis_names)
    rows = NamedSharding(mesh, P(axes, None))

    def step(frames, bias, dark, flat, exp_ratios):
        stacked, diag = calibrate_register_stack(
            frames, bias, dark, flat, exp_ratios, config=config)
        return jax.lax.with_sharding_constraint(stacked, rows), diag

    rep = replicate(mesh)
    return jax.jit(step, in_shardings=(
        NamedSharding(mesh, P(axes, None, None)), rep, rep, rep, rep))
