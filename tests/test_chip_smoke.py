"""chip_smoke.py's phases at 64x48 on the CPU (the Triton kernel in
interpret mode where a phase compares it), and its refusal to run without a
GPU. On the card the same phases run at 1920x1080."""

import json

import pytest

import chip_smoke


@pytest.mark.parametrize(
    "phase, kwargs",
    [
        ("kernel", dict(width=64, height=48, tile_rows=16, interpret=True)),
        ("temporal", dict(width=64, height=48, frames=2)),
        # The card's limits, on a 3-sphere scene that compiles faster.
        ("inverse", dict(width=128, height=96, steps=1, num_spheres=3,
                         memory=False)),
        ("wavefront", dict(width=64, height=48, spp=1, depth=2)),
    ],
)
def test_phase_runs_small_on_cpu(phase, kwargs, capsys):
    smoke = chip_smoke.Smoke("cpu")
    details = smoke.run(phase, getattr(chip_smoke, f"phase_{phase}"), **kwargs)
    line = capsys.readouterr().out
    assert smoke.failed == [], line
    assert line.startswith(f"[{phase}] ok wall ") and "compile" in line
    json.dumps(details)  # every figure is printable


def test_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
