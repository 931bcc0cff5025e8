"""Elastic recovery for the inverse-fit workload (SURVEY §5): kill after a
β phase + resume reproduces the uninterrupted trajectory exactly.

Mirrors tests/test_app.py's render-resume determinism test: the scene and
camera initialization is a pure function of the seed, and (scene, opt
state) round-trip bit-exactly through utils/checkpoint, so the resumed run's final
parameters must equal the uninterrupted run's."""

import numpy as np
import pytest

from kylespathtracer.diff import inverse

KW = dict(
    num_spheres=2, steps=4, width=32, height=24, views=1, seed=3,
    betas=(0.05, 0.02),
)


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    full = inverse.run_recovery(**KW)

    d = str(tmp_path / "ckpt")
    part = inverse.run_recovery(**KW, ckpt_dir=d, max_phases=1)
    assert part["completed_phases"] == 1

    resumed = inverse.run_recovery(**KW, ckpt_dir=d, resume=True)
    assert resumed["completed_phases"] == 2

    for k in ("err_position", "err_radius", "err_albedo", "loss_final"):
        np.testing.assert_allclose(resumed[k], full[k], rtol=1e-6, err_msg=k)
    assert [p["loss"] for p in resumed["phases"]] == pytest.approx(
        [p["loss"] for p in full["phases"]], rel=1e-6
    )


def test_torn_checkpoint_pair_falls_back(tmp_path):
    """A kill between the step file write and its meta sidecar must not
    poison resume: an unpaired step is ignored (falls back to the previous
    complete phase, or a fresh start)."""
    d = tmp_path / "ckpt"
    inverse.run_recovery(**KW, ckpt_dir=str(d), max_phases=1)
    # Simulate the torn window: the meta sidecar never landed.
    (d / "meta_1.json").unlink()
    resumed = inverse.run_recovery(**KW, ckpt_dir=str(d), resume=True)
    # Restarted from scratch and completed both phases.
    assert resumed["completed_phases"] == 2
    full = inverse.run_recovery(**KW)
    np.testing.assert_allclose(
        resumed["loss_final"], full["loss_final"], rtol=1e-6
    )
