"""core/ math+sampler+color vs the NumPy CPU re-execution of the GLSL math."""

import numpy as np
import jax.numpy as jnp
import pytest

from kylespathtracer.core import color, gmath, sampler
from kylespathtracer.cpu_reference import glslref as ref

RNG = np.random.default_rng(0)


def rand_vec(n=256, scale=5.0):
    return (RNG.standard_normal((n, 3)) * scale).astype(np.float32)


def rand_unit(n=256):
    v = RNG.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestSampler:
    def test_gen_seed_bit_exact(self):
        px = RNG.integers(0, 1280, 512).astype(np.int32)
        py = RNG.integers(0, 720, 512).astype(np.int32)
        for frame in (0, 1, 7, 123456, 2**20):
            ours = sampler.gen_seed(frame, jnp.asarray(px), jnp.asarray(py), 1280, 720)
            theirs = ref.gen_seed(frame, px, py, 1280, 720)
            np.testing.assert_array_equal(np.asarray(ours), theirs)

    def test_weyl3_bit_exact(self):
        seeds = RNG.integers(-(2**31), 2**31 - 1, 4096).astype(np.int32)
        ours = np.asarray(sampler.weyl3(jnp.asarray(seeds)))
        theirs = ref.weyl3(seeds)
        np.testing.assert_array_equal(ours, theirs)
        assert (ours >= 0).all() and (ours < 1).all()

    def test_logit3_matches(self):
        v = RNG.random((1024, 3)).astype(np.float32)
        # XLA's and NumPy's float32 log differ in the last ulp; the logit
        # amplifies that near the interval edges.
        np.testing.assert_allclose(
            np.asarray(sampler.logit3(jnp.asarray(v))), ref.logit3(v), atol=5e-5
        )

    def test_uniform_dir_unit(self):
        seeds = jnp.arange(1, 2049, dtype=jnp.int32)
        d = np.asarray(sampler.uniform_dir(seeds))
        np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)

    def test_cos_hemi_dir_in_hemisphere_and_cosine_weighted(self):
        n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4096, 1))
        seeds = jnp.arange(3, 3 + 4096, dtype=jnp.int32)
        d = np.asarray(sampler.cos_hemi_dir(jnp.asarray(n), seeds))
        cos = d[:, 1]
        assert (cos > -1e-6).all()
        # E[cos] = 2/3 for a cosine-weighted hemisphere; the Weyl+logit
        # sampler is approximate, so allow a loose band.
        assert 0.5 < cos.mean() < 0.8

    def test_uniform_cone_dir_matches_ref_and_stays_in_cone(self):
        lv = rand_vec(512, 8.0) + np.array([10.0, 0, 0], np.float32)
        lr = f = np.float32(1.0)
        seeds = np.arange(17, 17 + 512, dtype=np.int32)
        ours = np.asarray(
            sampler.uniform_cone_dir(jnp.asarray(lv), lr, jnp.asarray(seeds))
        )
        theirs = ref.uniform_cone_dir(lv, lr, seeds)
        np.testing.assert_allclose(ours, theirs, atol=2e-5)
        nlv = lv / np.linalg.norm(lv, axis=-1, keepdims=True)
        cos_to_axis = np.sum(ours * nlv, axis=-1)
        d = np.linalg.norm(lv, axis=-1)
        half_angle = np.arcsin(np.clip(lr / d, 1e-3, 0.999))
        # tan-weighted cone construction can exceed the geometric half-angle
        # slightly through normalization; bound loosely.
        assert (cos_to_axis > np.cos(half_angle * 1.5) - 1e-3).all()


class TestMath:
    def test_basis_matches_and_orthonormal(self):
        n = rand_unit(512)
        f_j, r_j = gmath.basis(jnp.asarray(n))
        f_r, r_r = ref.basis(n)
        np.testing.assert_allclose(np.asarray(f_j), f_r, atol=1e-6)
        np.testing.assert_allclose(np.asarray(r_j), r_r, atol=1e-6)
        for a, b in [(f_r, r_r), (f_r, n), (r_r, n)]:
            np.testing.assert_allclose(np.sum(a * b, -1), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(f_r, axis=-1), 1.0, atol=1e-5)

    def test_rotate_xy_matches(self):
        p = rand_vec(512)
        ang = (RNG.standard_normal((512, 2)) * 2).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(gmath.rotate_xy(jnp.asarray(p), jnp.asarray(ang))),
            ref.rotate_xy(p, ang),
            atol=1e-5,
        )

    def test_rotate_xy_identity_and_yaw(self):
        p = jnp.asarray([0.0, 0.0, 1.0])
        out = gmath.rotate_xy(p, jnp.asarray([0.0, 0.0]))
        np.testing.assert_allclose(np.asarray(out), [0, 0, 1], atol=1e-7)
        # yaw=pi/2 sends +z to +x (x' = x cos + z sin).
        out = gmath.rotate_xy(p, jnp.asarray([0.0, np.pi / 2]))
        np.testing.assert_allclose(np.asarray(out), [1, 0, 0], atol=1e-6)

    def test_solid_linear_angle_schlick(self):
        d = np.abs(RNG.standard_normal(256).astype(np.float32)) * 10 + 1.1
        np.testing.assert_allclose(
            np.asarray(gmath.linear_angle(jnp.asarray(d), 1.0)),
            ref.linear_angle(d, np.float32(1.0)),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(gmath.solid_angle(jnp.asarray(d * d), 1.0)),
            ref.solid_angle(d * d, np.float32(1.0)),
            atol=1e-6,
        )
        vn = RNG.random(256).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(gmath.schlick(1.0, 3.0, jnp.asarray(vn))),
            ref.schlick(np.float32(1.0), np.float32(3.0), vn),
            rtol=1e-5, atol=1e-6,
        )

    def test_lambertian_phong(self):
        hn = rand_unit()
        lv = rand_unit()
        rd = rand_unit()
        np.testing.assert_allclose(
            np.asarray(gmath.lambertian(jnp.asarray(hn), jnp.asarray(lv))),
            ref.lambertian(hn, lv),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(gmath.phong(jnp.asarray(rd), jnp.asarray(hn), jnp.asarray(lv), 5.0)),
            ref.phong(rd, hn, lv, 5.0),
            rtol=1e-4, atol=1e-6,
        )


class TestColor:
    def test_srgb_roundtrip_and_match(self):
        x = RNG.random((512, 3)).astype(np.float32)
        ours = np.asarray(color.linear_srgb(jnp.asarray(x)))
        np.testing.assert_allclose(ours, ref.linear_srgb(x), atol=1e-5)
        back = np.asarray(color.srgb_linear(jnp.asarray(ours)))
        np.testing.assert_allclose(back, x, atol=1e-4)

    def test_aces_matches(self):
        x = (RNG.random((512, 3)) * 4).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(color.aces_fitted(jnp.asarray(x))),
            ref.aces_fitted(x),
            atol=2e-5,
        )

    def test_aces_range(self):
        x = (RNG.random((512, 3)) * 100).astype(np.float32)
        out = np.asarray(color.aces_fitted(jnp.asarray(x)))
        assert (out >= 0).all() and (out <= 1).all()


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])


def test_fold_seed_decorrelate():
    import jax.numpy as jnp

    from kylespathtracer.core import sampler

    seed = jnp.arange(16, dtype=jnp.int32)
    # Default/parity: plain offset; sample 0 identical in both modes.
    assert (sampler.fold_seed(seed, 3) == seed + 3).all()
    assert (sampler.fold_seed(seed, 0, True) == seed).all()
    d1 = sampler.fold_seed(seed, 1, True)
    assert not (d1 == seed + 1).all()
    # Deterministic and distinct per sample index.
    assert (d1 == sampler.fold_seed(seed, 1, True)).all()
    assert not (d1 == sampler.fold_seed(seed, 2, True)).all()


def test_weyl_lattice_beats_hashed_streams():
    """The reference's `seed+i` sample streams stride the Weyl lattice — a
    short low-discrepancy progression — and measurably BEAT independent
    PCG-hashed streams at SMP_*=4 (QMC stratification vs plain MC). This
    guards the parity default: if fold_seed's default ever changes, or the
    Weyl sampler loses its lattice structure, this fails."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kylespathtracer.render.camera import Camera
    from kylespathtracer.render.pipeline import init_history, render_frame
    from kylespathtracer.scene import default_scene
    from kylespathtracer.utils.config import RenderConfig

    scene = default_scene()
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    base = RenderConfig(width=48, height=32, no_history=True)
    fn = jax.jit(render_frame, static_argnames=("config",))

    def one(cfg, frame):
        img, _ = fn(scene, cam, init_history(cfg, cam), jnp.asarray(frame), cfg)
        return np.asarray(img)

    # Reference: average of 32 independent 1-sample frames.
    ref = np.mean([one(base, f) for f in range(32)], axis=0)

    smp = dict(
        smp_direct_lambert=4, smp_lambert_surface_lambert=4,
        smp_lambert_surface_phong=4, smp_direct_phong=4,
        smp_phong_surface_lambert=4, smp_phong_surface_phong=4,
    )
    corr = one(dataclasses.replace(base, **smp), 0)
    deco = one(dataclasses.replace(base, **smp, decorrelate_samples=True), 0)
    mse_corr = float(np.mean((corr - ref) ** 2))
    mse_deco = float(np.mean((deco - ref) ** 2))
    # Both modes must beat a single sample; the lattice must beat hashing.
    one_smp = float(np.mean((one(base, 0) - ref) ** 2))
    assert mse_corr < one_smp, (mse_corr, one_smp)
    assert mse_corr < mse_deco, (mse_corr, mse_deco)
