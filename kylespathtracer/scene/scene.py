"""Scene builders.

`default_scene` reproduces the reference's hardcoded Cornell-style room
(reference: common.glsl:220-273) exactly; `sphere_scene` builds the
parameterized N-sphere scenes used by the BASELINE configs and inverse
rendering.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from kylespathtracer.scene.types import BSDF, OBJ, Materials, Scene


def _plane_tint(obj_id: int) -> tuple[float, float, float]:
    """Per-ID cos/sin tint of the generic plane branch (common.glsl:252-254)."""
    cm = math.cos(float(obj_id)) * 0.025
    sm = math.sin(float(obj_id)) * 0.025
    return (0.05 + cm, 0.05 + sm, 0.05 - (cm + sm) * 0.25)


def default_materials(light_color=(10.0, 10.0, 10.0)) -> Materials:
    """Material table reproducing `getSurface` (common.glsl:237-262).

    Rows are indexed by object ID (0..7). The global ×0.7 energy scale
    (common.glsl:260) is folded into the energy entries.
    """
    K = 8
    s0 = np.zeros(K, np.float32)
    s1 = np.zeros(K, np.float32)
    freq = np.ones(K, np.float32)
    alb_const = np.zeros((K, 3), np.float32)
    alb_scale = np.zeros((K, 3), np.float32)
    emission = np.zeros((K, 3), np.float32)
    en_const = np.zeros((K, 2), np.float32)
    en_scale = np.zeros((K, 2), np.float32)

    # LIGHT (common.glsl:239-242): white albedo, lightColor emission, (1,1)·0.7.
    s0[OBJ.LIGHT] = 1.0
    alb_const[OBJ.LIGHT] = 1.0
    emission[OBJ.LIGHT] = light_color
    en_const[OBJ.LIGHT] = (0.7, 0.7)

    # BOX (common.glsl:243-246): albedo = 0.025 + 0.1·checker(4·hl), (1,1)·0.7.
    s0[OBJ.BOX] = 0.025
    s1[OBJ.BOX] = 0.1
    freq[OBJ.BOX] = 4.0
    alb_scale[OBJ.BOX] = 1.0
    en_const[OBJ.BOX] = (0.7, 0.7)

    # Generic planes (common.glsl:249-256): refl = 0.9+0.2·checker for
    # FLOOR/CEIL, constant 0.8 for walls; albedo = tint·refl,
    # energy = (refl, refl/2)·0.7.
    for oid in (OBJ.FLOOR, OBJ.CEIL, OBJ.WALL1, OBJ.WALL2):
        checkered = oid in (OBJ.FLOOR, OBJ.CEIL)
        s0[oid] = 0.9 if checkered else 0.8
        s1[oid] = 0.2 if checkered else 0.0
        alb_scale[oid] = _plane_tint(oid)
        en_scale[oid] = (0.7, 0.35)

    return Materials(
        s0=jnp.asarray(s0), s1=jnp.asarray(s1), freq=jnp.asarray(freq),
        alb_const=jnp.asarray(alb_const), alb_scale=jnp.asarray(alb_scale),
        emission=jnp.asarray(emission), en_const=jnp.asarray(en_const),
        en_scale=jnp.asarray(en_scale),
        bsdf=jnp.zeros(K, jnp.int32), ior=jnp.full(K, 1.5, jnp.float32),
    )


def default_scene() -> Scene:
    """The reference's room: 4 planes + sphere light + rounded box.

    (reference: common.glsl:229-235, 264-273)
    """
    planes = jnp.asarray(
        [
            [0.0, 1.0, 0.0, 0.0],    # floor
            [0.0, -1.0, 0.0, 10.0],  # ceiling
            [-1.0, 0.0, 0.0, 10.0],  # wall1
            [0.0, 0.0, 1.0, 10.0],   # wall2
        ],
        jnp.float32,
    )
    plane_ids = jnp.asarray([OBJ.FLOOR, OBJ.CEIL, OBJ.WALL1, OBJ.WALL2], jnp.int32)
    spheres = jnp.asarray([[6.0, 5.0, -4.0, 1.0]], jnp.float32)
    sphere_ids = jnp.asarray([OBJ.LIGHT], jnp.int32)
    boxes = jnp.asarray([[7.5, 0.93, -7.5, 0.8, 0.8, 0.8, 0.1]], jnp.float32)
    box_ids = jnp.asarray([OBJ.BOX], jnp.int32)
    return Scene(
        planes=planes, plane_ids=plane_ids,
        spheres=spheres, sphere_ids=sphere_ids,
        boxes=boxes, box_ids=box_ids,
        light_color=jnp.asarray([10.0, 10.0, 10.0], jnp.float32),
        materials=default_materials(),
        light_index=0,
    )


def sphere_scene(
    centers,
    radii,
    albedos,
    light=(6.0, 5.0, -4.0, 1.0),
    light_color=(10.0, 10.0, 10.0),
    with_floor: bool = True,
    diffuse_energy: float = 0.7,
    specular_energy: float = 0.35,
    kinds=None,
    iors=None,
) -> Scene:
    """N spheres (+ floor plane + sphere light): the BASELINE scenes.

    Sphere i gets object ID 3+i with constant albedo `albedos[i]`; the floor
    uses the reference's FLOOR material, the light the reference's LIGHT
    material. All geometry and albedo entries are differentiable leaves.

    kinds: optional per-sphere BSDF kinds (scene.types.BSDF.*; default all
    DIFFUSE) and iors: per-sphere refraction indices, for the multi-bounce
    wavefront integrator (BASELINE config #3).
    """
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    radii = np.asarray(radii, np.float32).reshape(-1)
    albedos = np.asarray(albedos, np.float32).reshape(-1, 3)
    n = centers.shape[0]
    K = 3 + n

    s0 = np.zeros(K, np.float32)
    s1 = np.zeros(K, np.float32)
    freq = np.ones(K, np.float32)
    alb_const = np.zeros((K, 3), np.float32)
    alb_scale = np.zeros((K, 3), np.float32)
    emission = np.zeros((K, 3), np.float32)
    en_const = np.zeros((K, 2), np.float32)
    en_scale = np.zeros((K, 2), np.float32)

    s0[OBJ.LIGHT] = 1.0
    alb_const[OBJ.LIGHT] = 1.0
    emission[OBJ.LIGHT] = light_color
    en_const[OBJ.LIGHT] = (0.7, 0.7)

    s0[OBJ.FLOOR] = 0.9
    s1[OBJ.FLOOR] = 0.2
    alb_scale[OBJ.FLOOR] = _plane_tint(OBJ.FLOOR)
    en_scale[OBJ.FLOOR] = (0.7, 0.35)

    bsdf_col = np.zeros(K, np.int32)
    ior_col = np.full(K, 1.5, np.float32)
    for i in range(n):
        oid = 3 + i
        s0[oid] = 1.0
        alb_const[oid] = albedos[i]
        en_const[oid] = (diffuse_energy, specular_energy)
        if kinds is not None:
            bsdf_col[oid] = int(kinds[i])
        if iors is not None:
            ior_col[oid] = float(iors[i])

    materials = Materials(
        s0=jnp.asarray(s0), s1=jnp.asarray(s1), freq=jnp.asarray(freq),
        alb_const=jnp.asarray(alb_const), alb_scale=jnp.asarray(alb_scale),
        emission=jnp.asarray(emission), en_const=jnp.asarray(en_const),
        en_scale=jnp.asarray(en_scale),
        bsdf=jnp.asarray(bsdf_col), ior=jnp.asarray(ior_col),
    )

    if with_floor:
        planes = jnp.asarray([[0.0, 1.0, 0.0, 0.0]], jnp.float32)
        plane_ids = jnp.asarray([OBJ.FLOOR], jnp.int32)
    else:
        planes = jnp.zeros((0, 4), jnp.float32)
        plane_ids = jnp.zeros((0,), jnp.int32)

    spheres = jnp.concatenate(
        [
            jnp.asarray(light, jnp.float32)[None, :],
            jnp.concatenate([jnp.asarray(centers), jnp.asarray(radii)[:, None]], axis=1),
        ],
        axis=0,
    )
    sphere_ids = jnp.concatenate(
        [jnp.asarray([OBJ.LIGHT], jnp.int32), 3 + jnp.arange(n, dtype=jnp.int32)]
    )

    return Scene(
        planes=planes, plane_ids=plane_ids,
        spheres=spheres, sphere_ids=sphere_ids,
        boxes=jnp.zeros((0, 7), jnp.float32),
        box_ids=jnp.zeros((0,), jnp.int32),
        light_color=jnp.asarray(light_color, jnp.float32),
        materials=materials,
        light_index=0,
    )
