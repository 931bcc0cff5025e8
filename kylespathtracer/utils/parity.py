"""How closely two renders of the same frame must agree.

The fused frame and its references (the `pass` pipeline, `frame_forward_jnp`
under XLA, the same math on another backend) compute the same per-pixel
math in a different order and with other transcendental implementations.
Almost every pixel then agrees to float rounding. A few pixels sit on or
near a decision boundary — an object edge, a checker-cell edge, an MIS
roulette threshold, a near-tangent ray, a history count on a knife edge —
where a last-bit difference flips the branch taken (an O(1) difference) or
moves a steep but continuous response by anything up to O(1).

A `Tolerance` bounds both kinds:

* `oid` is identical on at least `oid_min_equal` of the pixels;
* an *outlier* is a pixel outside `rtol` relative plus `atol` absolute in
  any float plane; at most `max_outlier_frac` of the pixels are outliers;
* a *flip* is an outlier that differs by more than `flip_abs`; at most
  `max_flip_frac` of the pixels flip;
* with a boundary mask (`boundary_mask`), at least `min_flips_on_boundary`
  of the flips lie on it and at most `max_interior_flip_frac` of the pixels
  off it flip.

SINGLE holds one frame without history: at most 0.1% outliers, all the
rest within 1e-4 relative plus 1e-5 absolute. One H100 run compared the
kernel's tile with the host CPU's and found one pixel in 122,880 (8e-6)
outside that band without flipping (9.3e-4 over it), which is why the 0.1%
covers every outlier and not only the flips.

TEMPORAL holds a frame after several frames of accumulation (fused against
pass along the pose spline). A flip in one frame lives on in the history:
the 2x2 reprojection spreads it to neighbours and later samples dilute it
to below FLIP_ABS. One H100 run after 8 frames at 1080p measured 0.35% of
the pixels flipped (99.4% of them on the boundary mask) and 0.54% more
outside the rounding band; the bounds below leave about 3x room and keep
the interior check of the classification.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tolerance:
    oid_min_equal: float = 0.9999
    rtol: float = 1e-4
    atol: float = 1e-5
    flip_abs: float = 1e-3
    max_outlier_frac: float = 1e-3
    max_flip_frac: float = 1e-3
    min_flips_on_boundary: float | None = None
    max_interior_flip_frac: float | None = None


SINGLE = Tolerance()
TEMPORAL = Tolerance(
    max_outlier_frac=3e-2,
    max_flip_frac=1e-2,
    min_flips_on_boundary=0.95,
    max_interior_flip_frac=2e-4,
)


def _channels(a) -> np.ndarray:
    """(H, W) or (H, W, C) → (H, W, C) float64."""
    a = np.asarray(a, np.float64)
    return a[..., None] if a.ndim == 2 else a


def compare(got: dict, ref: dict, tol: Tolerance = SINGLE,
            mask: np.ndarray | None = None) -> dict:
    """Compare two dicts of per-pixel planes with the same keys (`oid`, if
    present, is compared for equality). Returns the figures and `ok`."""
    outlier = flip = None
    for k in sorted(k for k in ref if k != "oid"):
        g, r = _channels(got[k]), _channels(ref[k])
        d = np.abs(g - r)
        bad = ~np.isfinite(g)
        o = (bad | ~(d <= tol.atol + tol.rtol * np.abs(r))).any(-1)
        f = (bad | (d > tol.flip_abs)).any(-1)
        outlier = o if outlier is None else outlier | o
        flip = f if flip is None else flip | f
    out = {"pixels": int(flip.size)}
    ok = True
    if "oid" in ref:
        oid_diff = np.asarray(got["oid"]) != np.asarray(ref["oid"])
        outlier, flip = outlier | oid_diff, flip | oid_diff
        out["oid_equal"] = float(1.0 - oid_diff.mean())
        ok &= out["oid_equal"] >= tol.oid_min_equal
    out["outlier_frac"] = float(outlier.mean())
    out["flip_frac"] = float(flip.mean())
    ok &= out["outlier_frac"] <= tol.max_outlier_frac
    ok &= out["flip_frac"] <= tol.max_flip_frac
    if mask is not None:
        mask = np.asarray(mask, bool)
        on = float((flip & mask).sum() / flip.sum()) if flip.any() else 1.0
        interior = ~mask
        inside = (
            float((flip & interior).sum() / interior.sum())
            if interior.any() else 0.0
        )
        out.update(boundary_frac=float(mask.mean()),
                   flips_on_boundary=on, interior_flip_frac=inside)
        if tol.min_flips_on_boundary is not None:
            ok &= on >= tol.min_flips_on_boundary
        if tol.max_interior_flip_frac is not None:
            ok &= inside <= tol.max_interior_flip_frac
    out["tolerance"] = dataclasses.asdict(tol)
    out["ok"] = bool(ok)
    return out


def _dilate(mask: np.ndarray, n: int) -> np.ndarray:
    for _ in range(n):
        mask = (
            mask | np.roll(mask, 1, 0) | np.roll(mask, -1, 0)
            | np.roll(mask, 1, 1) | np.roll(mask, -1, 1)
        )
    return mask


def id_edges(oid, dilate: int = 0) -> np.ndarray:
    """Pixels whose object ID differs from a 4-neighbour's (silhouettes),
    dilated by `dilate` pixels."""
    oid = np.asarray(oid)
    m = np.zeros(oid.shape, bool)
    for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        m |= np.roll(oid, s, axis=ax) != oid
    return _dilate(m, dilate)


def boundary_mask(oids, hit_points, counts=(), dilate: int = 2) -> np.ndarray:
    """Geometric decision boundaries of one or more frames: object-ID
    edges and material checker-cell edges (4³ cells on the box, unit cells
    on floor and ceiling; common.glsl:244,250), plus — for temporal
    frames — pixels whose history count differs from a 4-neighbour
    (`counts`, one (H, W) array per frame and channel), dilated by
    `dilate` pixels for the reprojection drift of flips carried in the
    history."""
    mask = None
    for oid, hl in zip(oids, hit_points):
        oid = np.asarray(oid)
        hl = np.asarray(hl)
        cell = np.zeros(oid.shape + (3,), np.int64)
        box = oid == 4
        flr = (oid == 2) | (oid == 7)
        cell[box] = np.floor(4 * hl[box]).astype(np.int64)
        cell[flr] = np.floor(hl[flr]).astype(np.int64)
        m = np.zeros(oid.shape, bool)
        for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
            m |= np.roll(oid, s, axis=ax) != oid
            m |= (np.roll(cell, s, axis=ax) != cell).any(axis=-1)
        mask = m if mask is None else mask | m
    for c in counts:
        c = np.asarray(c)
        for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
            mask |= np.roll(c, s, axis=ax) != c
    return _dilate(mask, dilate)
