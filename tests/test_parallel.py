"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from astrophotography_tpu.parallel import (
    frame_space_mesh,
    halo_exchange_rows,
    replicate,
    shard_frames,
    shard_spatial,
    sharded_map_overlap,
)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return devs


def test_mesh_construction(devices):
    mesh = frame_space_mesh(devices=devices[:8])
    assert mesh.devices.shape == (8, 1)
    mesh2 = frame_space_mesh(n_frame=2, devices=devices[:8])
    assert mesh2.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        frame_space_mesh(n_frame=3, n_space=2, devices=devices[:8])


def test_sharded_stack_combine_matches_single_device(devices):
    """Sigma-clip combine over a frame-sharded stack == unsharded result;
    XLA inserts the cross-device reduction."""
    from astrophotography_tpu.ops.stack import sigma_clip_combine

    mesh = frame_space_mesh(n_frame=8, devices=devices[:8])
    rng = np.random.default_rng(0)
    stack = rng.normal(100, 5, (16, 64, 64)).astype(np.float32)
    stack[3, 10, 10] = 50000.0

    ref = np.asarray(sigma_clip_combine(jnp.asarray(stack)))

    sharded = jax.device_put(stack, shard_frames(mesh))
    with mesh:
        combined = jax.jit(
            lambda s: sigma_clip_combine(s),
            out_shardings=shard_spatial(mesh))(sharded)
    np.testing.assert_allclose(np.asarray(combined), ref, rtol=1e-5,
                               atol=1e-3)


def test_halo_exchange_stencil_identical_to_unsharded(devices):
    """A 5x5 mean stencil over row-sharded data with halo exchange must
    equal the unsharded computation."""
    mesh = frame_space_mesh(n_frame=1, n_space=8, devices=devices[:8])
    rng = np.random.default_rng(1)
    img = rng.normal(size=(128, 64)).astype(np.float32)

    def stencil(x):
        # 5x5 box mean with zero padding
        h, w = x.shape
        p = jnp.pad(x, 2)
        acc = jnp.zeros_like(x)
        for dy in range(5):
            for dx in range(5):
                acc = acc + p[dy:dy + h, dx:dx + w]
        return acc / 25.0

    ref = np.asarray(stencil(jnp.asarray(img)))
    lifted = sharded_map_overlap(stencil, mesh, halo=2)
    with mesh:
        out = lifted(jax.device_put(img, shard_spatial(mesh)))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-5)


def test_sharded_calibrate_batch(devices):
    """Frame-sharded calibration: purely local, no collectives needed."""
    from astrophotography_tpu.ops.calibrate import calibrate_batch

    mesh = frame_space_mesh(n_frame=8, devices=devices[:8])
    rng = np.random.default_rng(2)
    frames = rng.normal(1000, 10, (8, 32, 32)).astype(np.float32)
    bias = rng.normal(300, 2, (32, 32)).astype(np.float32)
    ref = np.asarray(calibrate_batch(jnp.asarray(frames), jnp.asarray(bias)))
    with mesh:
        out = jax.jit(calibrate_batch)(
            jax.device_put(frames, shard_frames(mesh)),
            jax.device_put(bias, replicate(mesh)))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6)
    # output keeps the frame sharding (no resharding inserted)
    assert len(out.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_standard_pipeline_matches_single_device(devices):
    """The full standard pipeline jitted under a (frame, space) mesh
    with frame-sharded inputs matches the unsharded result — XLA
    inserts the cross-frame collectives for the combine (SURVEY §2.6)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from astrophotography_tpu.models import (PipelineConfig,
                                             calibrate_register_stack)
    from astrophotography_tpu import synth

    rng = np.random.default_rng(17)
    img, _ = synth.make_starfield((256, 256), n_stars=10, fwhm=3.0,
                                  background=150.0, read_noise=4.0,
                                  flux_range=(20000.0, 60000.0), seed=17,
                                  min_sep=18.0)
    frames = np.stack([
        np.roll(np.roll(img, int(rng.integers(-3, 4)), 0),
                int(rng.integers(-3, 4)), 1)
        + rng.normal(0, 3, img.shape) for _ in range(8)
    ]).astype(np.float32)
    cfg = PipelineConfig(max_stars=16, match_k=8)

    ref, ref_diag = calibrate_register_stack(jnp.asarray(frames), config=cfg)
    ref = np.asarray(ref)

    mesh = frame_space_mesh(n_frame=4, n_space=2, devices=devices[:8])
    with mesh:
        sharded = jax.device_put(
            frames, NamedSharding(mesh, P("frame", None, None)))

        def step(fr):
            stacked, diag = calibrate_register_stack(fr, config=cfg)
            stacked = jax.lax.with_sharding_constraint(
                stacked, NamedSharding(mesh, P("space", None)))
            return stacked, diag["n_inliers"]

        got, inl = jax.jit(step)(sharded)
    got = np.asarray(got)
    assert len(got.shape) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2)
    assert np.asarray(inl).min() >= 6


def test_sharded_calibrate_register_stack_helper(devices):
    """parallel.mesh.sharded_calibrate_register_stack on 4 devices:
    frames in, row-sharded stack out, equal to the one-device run."""
    import jax.numpy as jnp
    from astrophotography_tpu.models import (PipelineConfig,
                                             calibrate_register_stack)
    from astrophotography_tpu.parallel.mesh import (
        sharded_calibrate_register_stack)
    from astrophotography_tpu import synth

    rng = np.random.default_rng(5)
    img, _ = synth.make_starfield((128, 128), n_stars=8, fwhm=3.0,
                                  background=150.0, read_noise=4.0,
                                  flux_range=(20000.0, 60000.0), seed=5,
                                  min_sep=18.0)
    bias = np.full(img.shape, 100.0, np.float32)
    frames = np.stack([
        np.roll(img, (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
                (0, 1)) + bias + rng.normal(0, 3, img.shape)
        for _ in range(4)]).astype(np.float32)
    dark = bias + 2.0
    flat = np.ones(img.shape, np.float32)
    ratios = np.ones(4, np.float32)
    cfg = PipelineConfig(max_stars=16, match_k=8)
    ref, _ = calibrate_register_stack(jnp.asarray(frames), jnp.asarray(bias),
                                      jnp.asarray(dark), jnp.asarray(flat),
                                      jnp.asarray(ratios), config=cfg)
    mesh = frame_space_mesh(devices=devices[:4])
    got, diag = sharded_calibrate_register_stack(mesh, cfg)(
        frames, bias, dark, flat, ratios)
    assert len(got.sharding.device_set) == 4
    assert got.sharding.spec[0] is not None       # rows are sharded
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-2)
    assert np.asarray(diag["n_inliers"]).min() >= 6
