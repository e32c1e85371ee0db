"""Composable processing pipelines (the framework's "model" layer)."""

from .pipeline import (
    PipelineConfig,
    calibrate_register_stack,
    frame_noise_stats,
    register_frames,
    stack_registered,
)

__all__ = [
    "PipelineConfig",
    "calibrate_register_stack",
    "frame_noise_stats",
    "register_frames",
    "stack_registered",
]
