"""Native (C++) runtime tests: PNG encoder and the independent march oracle."""

import numpy as np
import pytest

from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.scene import default_scene
from kylespathtracer.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (no toolchain)"
)


def test_native_png(tmp_path):
    img = (np.random.default_rng(0).random((24, 32, 3)) * 255).astype(np.uint8)
    p = tmp_path / "n.png"
    native.write_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data


def test_native_march_matches_jax():
    """The C++ sphere tracer is a third independent implementation of
    common.glsl:283-295; IDs must match JAX march and hit distances agree
    (tangent rays excepted)."""
    scene = default_scene()
    rng = np.random.default_rng(3)
    n = 2000
    ro = np.stack(
        [rng.uniform(-5, 9.5, n), rng.uniform(0.2, 9.5, n), rng.uniform(-9.5, 5, n)],
        axis=-1,
    ).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t_c, id_c = native.march(scene, ro, rd, -1, 255)
    t_j, id_j = sdf_mod.march(scene, ro, rd, -1, 255)
    t_j = np.asarray(t_j)
    id_j = np.asarray(id_j)

    assert (id_c == id_j).mean() > 0.995
    m = id_c == id_j
    diffs = np.abs(t_c[m] - t_j[m])
    assert np.quantile(diffs, 0.99) < 5e-3
