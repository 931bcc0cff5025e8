"""scene/ SDF, march, norcurv, materials vs the CPU GLSL re-execution."""

import numpy as np
import jax
import jax.numpy as jnp

from kylespathtracer.cpu_reference import glslref as ref
from kylespathtracer.scene import default_scene, OBJ
from kylespathtracer.scene import materials as mat
from kylespathtracer.scene import sdf as sdf_mod
from kylespathtracer.scene.scene import sphere_scene

RNG = np.random.default_rng(1)
SCENE = default_scene()


def room_points(n=512):
    """Points inside the reference room x∈(-10,10) y∈(0,10) z∈(-10,10)."""
    p = RNG.random((n, 3)).astype(np.float32)
    return (p * np.array([19, 9.5, 19]) + np.array([-9.5, 0.25, -19 + 9.5])).astype(
        np.float32
    )


class TestSdf:
    def test_sdf_matches_reference(self):
        p = room_points(2048)
        d_j, id_j = sdf_mod.sdf(SCENE, jnp.asarray(p))
        d_r, id_r = ref.sdf(p)
        np.testing.assert_allclose(np.asarray(d_j), d_r, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(id_j), id_r)

    def test_sdf_exclusion(self):
        p = room_points(512)
        for excl in (OBJ.LIGHT, OBJ.FLOOR, OBJ.BOX):
            d_j, id_j = sdf_mod.sdf(SCENE, jnp.asarray(p), excl)
            d_r, id_r = ref.sdf(p, excl)
            np.testing.assert_allclose(np.asarray(d_j), d_r, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(id_j), id_r)
            assert not (np.asarray(id_j) == excl).any()

    def test_norcurv_matches(self):
        p = room_points(512)
        n_j, c_j = sdf_mod.norcurv(SCENE, jnp.asarray(p))
        n_r, c_r = ref.norcurv(p)
        # The tetrahedron stencil cancels catastrophically in float32, so
        # XLA-vs-NumPy summation order shows up at the 1e-3 level.
        np.testing.assert_allclose(np.asarray(n_j), n_r, atol=5e-3)
        np.testing.assert_allclose(np.asarray(c_j), c_r, atol=5e-2)


class TestMarch:
    def test_march_matches_reference(self):
        n = 256
        ro = np.tile(np.array([3.0, 2.0, -3.0], np.float32), (n, 1))
        rd = RNG.standard_normal((n, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        t_j, id_j = sdf_mod.march(SCENE, jnp.asarray(ro), jnp.asarray(rd))
        t_r, id_r = ref.march(ro, rd)
        np.testing.assert_array_equal(np.asarray(id_j), id_r)
        np.testing.assert_allclose(np.asarray(t_j), t_r, atol=1e-4)

    def test_march_known_hits(self):
        # Straight down from inside the room → floor.
        ro = jnp.asarray([[3.0, 5.0, -3.0]])
        rd = jnp.asarray([[0.0, -1.0, 0.0]])
        t, oid = sdf_mod.march(SCENE, ro, rd)
        assert int(oid[0]) == OBJ.FLOOR
        np.testing.assert_allclose(float(t[0]), 5.0, atol=5e-3)
        # Toward the light center → light at distance |lv| - r.
        lv = np.array([6.0, 5.0, -4.0]) - np.array([3.0, 2.0, -3.0])
        d = np.linalg.norm(lv)
        ro = jnp.asarray([[3.0, 2.0, -3.0]])
        rd = jnp.asarray([lv / d])
        t, oid = sdf_mod.march(SCENE, ro, rd.astype(jnp.float32))
        assert int(oid[0]) == OBJ.LIGHT
        np.testing.assert_allclose(float(t[0]), d - 1.0, atol=5e-3)

    def test_march_exclusion_skips_object(self):
        lv = np.array([6.0, 5.0, -4.0]) - np.array([3.0, 2.0, -3.0])
        rd = (lv / np.linalg.norm(lv)).astype(np.float32)
        ro = jnp.asarray([[3.0, 2.0, -3.0]])
        t, oid = sdf_mod.march(SCENE, ro, jnp.asarray([rd]), exclude=OBJ.LIGHT)
        assert int(oid[0]) != OBJ.LIGHT

    def test_march_gradient_sphere_translation(self):
        """IFT gradient of hit distance w.r.t. sphere center ≈ finite diff."""
        scn = sphere_scene(
            centers=[[0.0, 1.0, 5.0]], radii=[1.0], albedos=[[0.5, 0.5, 0.5]],
            with_floor=False,
        )
        ro = jnp.asarray([[0.0, 1.0, 0.0]])
        rd = jnp.asarray([[0.0, 0.0, 1.0]])

        def hit_t(dz):
            s2 = scn.replace(spheres=scn.spheres.at[1, 2].add(dz))
            t, _ = sdf_mod.march(s2, ro, rd)
            return t[0]

        g = jax.grad(hit_t)(0.0)
        fd = (hit_t(1e-3) - hit_t(-1e-3)) / 2e-3
        # Moving the sphere +z by dz moves the hit +z by dz → dt/dz = 1.
        np.testing.assert_allclose(float(g), 1.0, atol=5e-2)
        np.testing.assert_allclose(float(g), float(fd), atol=5e-2)

    def test_march_gradient_radius(self):
        scn = sphere_scene(
            centers=[[0.0, 1.0, 5.0]], radii=[1.0], albedos=[[0.5, 0.5, 0.5]],
            with_floor=False,
        )
        ro = jnp.asarray([[0.0, 1.0, 0.0]])
        rd = jnp.asarray([[0.0, 0.0, 1.0]])

        def hit_t(dr):
            s2 = scn.replace(spheres=scn.spheres.at[1, 3].add(dr))
            t, _ = sdf_mod.march(s2, ro, rd)
            return t[0]

        g = jax.grad(hit_t)(0.0)
        # Growing the radius pulls the front hit closer → dt/dr = -1.
        np.testing.assert_allclose(float(g), -1.0, atol=5e-2)


class TestMaterials:
    def test_surface_matches_reference(self):
        p = room_points(512)
        for oid in (OBJ.LIGHT, OBJ.FLOOR, OBJ.WALL1, OBJ.BOX, OBJ.WALL2, OBJ.CEIL, 0):
            ho = jnp.full((p.shape[0],), oid, jnp.int32)
            alb_j, emi_j, ene_j = mat.surface(SCENE.materials, ho, jnp.asarray(p))
            alb_r = np.zeros((p.shape[0], 3), np.float32)
            emi_r = np.zeros((p.shape[0], 3), np.float32)
            ene_r = np.zeros((p.shape[0], 2), np.float32)
            for i in range(p.shape[0]):
                alb_r[i], emi_r[i], ene_r[i] = ref.get_surface(oid, p[i])
            np.testing.assert_allclose(np.asarray(alb_j), alb_r, atol=1e-5)
            np.testing.assert_allclose(np.asarray(emi_j), emi_r, atol=1e-6)
            np.testing.assert_allclose(np.asarray(ene_j), ene_r, atol=1e-5)

    def test_checker_parity_negative_coords(self):
        p = jnp.asarray([[-0.5, 0.0, 0.0], [-1.5, 0.0, 0.0], [0.5, 0.0, 0.0]])
        c = np.asarray(mat.checker(p, jnp.ones(3)))
        np.testing.assert_array_equal(c, [1.0, 0.0, 0.0])


class TestAnalyticBox:
    def test_box_hits_match_march(self):
        """The closed-form rounded-box (faces + edge cylinders + corner
        spheres) agrees with the reference sphere tracer on rays aimed at the
        box from inside the room; tangent grazers excepted."""
        from kylespathtracer.scene import intersect as isect

        rng = np.random.default_rng(0)
        n = 4000
        ro = np.stack(
            [rng.uniform(-5, 9.5, n), rng.uniform(0.2, 9.5, n), rng.uniform(-9.5, 5, n)],
            axis=-1,
        )
        inside_box = (np.abs(ro - [7.5, 0.93, -7.5]) < 1.1).all(-1)
        near_light = np.linalg.norm(ro - [6, 5, -4], axis=-1) < 1.2
        ro = ro[~inside_box & ~near_light]
        target = np.array([7.5, 0.93, -7.5]) + rng.normal(0, 1.2, (len(ro), 3))
        rd = target - ro
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        ro = jnp.asarray(ro, jnp.float32)
        rd = jnp.asarray(rd, jnp.float32)

        t_a, id_a = isect.intersect(SCENE, ro, rd, -1)
        t_m, id_m = sdf_mod.march(SCENE, ro, rd, -1, 255)
        id_a, id_m = np.asarray(id_a), np.asarray(id_m)
        t_a, t_m = np.asarray(t_a), np.asarray(t_m)

        assert (id_a == id_m).mean() > 0.995
        both = (id_a == id_m) & (id_a > 0)
        diffs = np.abs(t_a[both] - t_m[both])
        # March stops within eps of the surface; analytic is exact.
        assert np.quantile(diffs, 0.99) < 1e-2
