"""chip_smoke.py: it refuses to run without a GPU, and its truth and
depth checks pass on a correct stack and fail on a perturbed one
(tiny session on the CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

import bench
import chip_smoke
from astrophotography_tpu.models import calibrate_register_stack

N, SIZE = 8, 256


@pytest.fixture(scope="module")
def session():
    host, truth = bench.session_args(N, SIZE)
    truth["size"] = SIZE
    cfg = bench.session_config(SIZE)
    stacked, diag = calibrate_register_stack(**bench.to_device(host),
                                             config=cfg)
    return np.asarray(stacked), diag, truth, cfg


def test_main_without_gpu_exits_nonzero(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_check_stack_passes_on_correct_stack(session):
    stacked, diag, truth, _ = session
    msg = chip_smoke.check_stack(stacked, diag, truth, N, "tiny")
    assert "registration RMS" in msg


def _perturbed(session, kind):
    stacked, diag, truth, _ = session
    stacked = stacked.copy()
    diag = dict(diag)
    if kind == "registration":
        diag["matrices"] = np.asarray(diag["matrices"]) + np.array(
            [[0, 0, 0.1], [0, 0, 0]], np.float32)
    elif kind == "hole":
        stacked[SIZE // 2, SIZE // 2] = 0.0
    elif kind == "sky":
        stacked = stacked + 2.0
    elif kind == "nan":
        stacked[3, 3] = np.nan
    return stacked, diag, truth


@pytest.mark.parametrize("kind", ["registration", "hole", "sky", "nan"])
def test_check_stack_fails_on_perturbed_stack(session, kind):
    stacked, diag, truth = _perturbed(session, kind)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_stack(stacked, diag, truth, N, "tiny")


def test_depth_probe_full_depth(session):
    _, diag, truth, cfg = session
    summed = chip_smoke.depth_probe(diag["matrices"], (N, SIZE, SIZE), cfg)
    assert "every interior pixel" in chip_smoke.check_depth(
        summed, truth, N, "tiny")


def test_depth_probe_detects_a_lost_frame(session):
    _, diag, truth, cfg = session
    # one frame shifted by half the field: its half of the interior
    # loses that frame
    mats = jnp.asarray(diag["matrices"]).at[3, 0, 2].add(SIZE / 2)
    summed = chip_smoke.depth_probe(mats, (N, SIZE, SIZE), cfg)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_depth(summed, truth, N, "tiny")
