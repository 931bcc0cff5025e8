"""The shade core of the fused frame, in component-plane form.

Computes what `mis.dual_mis` computes — direct light + 2×2 plane-strategy
roulettes for the diffuse and specular estimators (reference:
common.glsl:430-616) — as per-pixel math for ops/frame_kernel.frame_block:

* Vectors are tuples of component planes `(rows, cols)`; no trailing size-3
  axis anywhere, so the same code runs one pixel per thread in the Triton
  kernel and as whole-image arrays under XLA.
* Scene tables are read as scalars with static indices (`sc["planes"][p,
  0]`): refs inside the kernel, arrays under XLA.
* Primitive counts (P planes, S spheres, B boxes) are static Python loops —
  the scene *parameters* stay traced.

The math mirrors render/mis.py term for term.

Gradient safety: this module is also the body the backward differentiates
(ops/frame_grad.py, `jax.vjp` of frame_block). Every `sqrt`/`rsqrt` whose argument
can reach exactly 0 on a *masked* lane is therefore clamped away from 0:
`where(valid, f(sqrt(x)), 0)` back-propagates `0 · sqrt'(0) = 0 · inf = NaN`
without the clamp. The clamps (1e-12 / 1e-20) only move values on lanes the
validity masks already reject.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kylespathtracer.core import gmath

_INF = 1e9


# ----------------------------------------------------------- vec3 helpers
# A "vec" is a tuple (x, y, z) of (bh, W) arrays.

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _normalize(a, eps=1e-20):
    inv = jax.lax.rsqrt(jnp.maximum(_dot(a, a), eps))
    return _scale(a, inv)


def _reflect(i, n):
    d = 2.0 * _dot(n, i)
    return (i[0] - d * n[0], i[1] - d * n[1], i[2] - d * n[2])


def _where_v(m, a, b):
    return (
        jnp.where(m, a[0], b[0]),
        jnp.where(m, a[1], b[1]),
        jnp.where(m, a[2], b[2]),
    )


def _weyl3(seed):
    """Bit-faithful int32 Weyl draws (common.glsl:43-45) in component form."""
    out = []
    for k in (13743434, 11258243, 9222443):
        prod = (seed * jnp.int32(k)).astype(jnp.float32) / jnp.float32(16777216.0)
        out.append(prod - jnp.floor(prod))
    return out


def _basis(n):
    """Branchless ONB (common.glsl:53-59)."""
    nx, ny, nz = n
    s = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = 1.0 / (s + nz)
    b = -nx * ny * a
    f = (1.0 - nx * nx * a * s, b * s, -nx * s)
    r = (b, s - ny * ny * a, -ny)
    return f, r


def _cone_pre(seed):
    """Per-pixel cone-sampling draws, hoisted: every cone sample in a pixel
    uses the same seed (the reference calls weyl3(seed) identically in every
    strategy, common.glsl:437,459,492…), so sqrt(u1), cos/sin(2π·u2) and u3
    are computed once and reused by all ~10 cone samples."""
    u1, u2, u3 = _weyl3(seed)
    su1 = jnp.sqrt(u1)
    tha = u2 * gmath.TWOPI
    return su1, jnp.cos(tha), jnp.sin(tha), u3


def _cone_dir(lv, lr, pre):
    """Cone sample toward a sphere (common.glsl:188-196) from hoisted draws;
    degenerate-safe."""
    su1, ct, st, _ = pre
    d2 = _dot(lv, lv)
    d = jnp.sqrt(jnp.maximum(d2, 1e-20))
    x = jnp.clip(lr / jnp.maximum(d, 1e-12), gmath.EPS, gmath.IEPS)
    rad = su1 * x * jax.lax.rsqrt(1.0 - x * x)
    nlv = _normalize(lv)
    f, r = _basis(nlv)
    o = (
        nlv[0] + rad * (f[0] * ct + r[0] * st),
        nlv[1] + rad * (f[1] * ct + r[1] * st),
        nlv[2] + rad * (f[2] * ct + r[2] * st),
    )
    return _normalize(o)


def _solid_angle(d2, r2):
    inner = 1.0 - jnp.clip(r2 / jnp.maximum(d2, 1e-24), 0.0, 1.0)
    return (1.0 - jnp.sqrt(jnp.maximum(inner, 1e-12))) * gmath.TWOPI


def _schlick(r1, r2, vn):
    r0 = (r1 - r2) / (r1 + r2)
    r0 = r0 * r0
    u = 1.0 - vn
    u2 = u * u
    return r0 + (1.0 - r0) * u2 * u2 * u


def _powi(x, n: int):
    acc = None
    base = x
    n = int(n)
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if n:
            base = base * base
    return acc


# ----------------------------------------------------------- intersection

def _trace(sc, ro, rd, excl, nP, nS, nB, inside_hits=False):
    """Nearest hit → (t, oid): analytic planes/spheres + closed-form rounded
    boxes, component form of scene/intersect.py. `sc` is a dict of small
    scene refs; nP/nS/nB static counts. `inside_hits` (static): rays that
    start inside a sphere hit its far surface instead of missing — the
    path kernel's dielectric continuation rays
    (scene/intersect._sphere_hits)."""
    best_t = jnp.full_like(ro[0], _INF)
    best_id = jnp.zeros_like(excl)

    def consider(t, oid_scalar, valid):
        nonlocal best_t, best_id
        valid = valid & (t > 0) & (oid_scalar != excl) & (t < best_t)
        best_t = jnp.where(valid, t, best_t)
        best_id = jnp.where(valid, oid_scalar, best_id)

    for p in range(nP):
        n0 = sc["planes"][p, 0]
        n1 = sc["planes"][p, 1]
        n2 = sc["planes"][p, 2]
        w = sc["planes"][p, 3]
        denom = rd[0] * n0 + rd[1] * n1 + rd[2] * n2
        sd0 = ro[0] * n0 + ro[1] * n1 + ro[2] * n2 + w
        t = -sd0 / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        consider(t, sc["plane_ids"][p, 0], denom < -1e-7)

    for s in range(nS):
        cx = sc["spheres"][s, 0]
        cy = sc["spheres"][s, 1]
        cz = sc["spheres"][s, 2]
        r = sc["spheres"][s, 3]
        oc = (ro[0] - cx, ro[1] - cy, ro[2] - cz)
        b = _dot(oc, rd)
        c2 = _dot(oc, oc) - r * r
        disc = b * b - c2
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t = -b - sq
        if inside_hits:
            t = jnp.where(t > 0, t, -b + sq)
        consider(t, sc["sphere_ids"][s, 0], disc > 0)

    for bx in range(nB):
        c = (sc["boxes"][bx, 0], sc["boxes"][bx, 1], sc["boxes"][bx, 2])
        half = (sc["boxes"][bx, 3], sc["boxes"][bx, 4], sc["boxes"][bx, 5])
        rnd = sc["boxes"][bx, 6]
        oid = sc["box_ids"][bx, 0]
        o = _sub(ro, c)
        d = rd
        # 6 faces.
        for k in range(3):
            j1, j2 = (k + 1) % 3, (k + 2) % 3
            dk = jnp.where(jnp.abs(d[k]) < 1e-12, 1e-12, d[k])
            for sgn in (1.0, -1.0):
                t = (sgn * (half[k] + rnd) - o[k]) / dk
                p1 = o[j1] + d[j1] * t
                p2 = o[j2] + d[j2] * t
                consider(
                    t, oid,
                    (jnp.abs(p1) <= half[j1]) & (jnp.abs(p2) <= half[j2]),
                )
        # 12 edge cylinders.
        for k in range(3):
            i, j = (k + 1) % 3, (k + 2) % 3
            a = jnp.maximum(d[i] * d[i] + d[j] * d[j], 1e-12)
            for si in (1.0, -1.0):
                for sj in (1.0, -1.0):
                    oi = o[i] - si * half[i]
                    oj = o[j] - sj * half[j]
                    b = oi * d[i] + oj * d[j]
                    cq = oi * oi + oj * oj - rnd * rnd
                    disc = b * b - a * cq
                    t = (-b - jnp.sqrt(jnp.maximum(disc, 1e-12))) / a
                    pk = o[k] + d[k] * t
                    consider(
                        t, oid,
                        (disc > 0)
                        & (jnp.abs(pk) <= half[k])
                        & ((oi + d[i] * t) * si > 0)
                        & ((oj + d[j] * t) * sj > 0),
                    )
        # 8 corner spheres.
        for sx in (1.0, -1.0):
            for sy in (1.0, -1.0):
                for sz in (1.0, -1.0):
                    oc = (
                        o[0] - sx * half[0],
                        o[1] - sy * half[1],
                        o[2] - sz * half[2],
                    )
                    b = _dot(oc, d)
                    cq = _dot(oc, oc) - rnd * rnd
                    disc = b * b - cq
                    t = -b - jnp.sqrt(jnp.maximum(disc, 1e-12))
                    consider(
                        t, oid,
                        (disc > 0)
                        & ((oc[0] + d[0] * t) * sx > 0)
                        & ((oc[1] + d[1] * t) * sy > 0)
                        & ((oc[2] + d[2] * t) * sz > 0),
                    )

    # Pull back by eps; clamp misses (common.glsl:289-294).
    t = best_t - gmath.EPS
    miss = (t > gmath.ZFAR) | (best_id == 0)
    return jnp.where(miss, gmath.ZFAR, t), jnp.where(miss, 0, best_id)


# ------------------------------------------------- occlusion-only tests
#
# The nine secondary traces per pixel (direct-light visibility, 4 roulette
# plane-verify marches, 4 light re-sample marches) never need the nearest
# (t, id) pair `_trace` computes — only a boolean: "is the analytic target
# the nearest hit?", i.e. "does anything else hit strictly before t_target?"
# Dropping the 26-candidate nearest-hit box sweep + select chains for these
# cut the fused frame kernel ~40% (BENCH_r04). Semantics match `_trace`
# exactly up to measure-zero f32 ties (processing-order tie-breaks).

def _plane_hit_t(sc, p, o, d):
    """Raw candidate t and validity of plane p (the plane branch of
    `_trace`, without the nearest bookkeeping)."""
    n0 = sc["planes"][p, 0]
    n1 = sc["planes"][p, 1]
    n2 = sc["planes"][p, 2]
    w = sc["planes"][p, 3]
    denom = d[0] * n0 + d[1] * n1 + d[2] * n2
    sd0 = o[0] * n0 + o[1] * n1 + o[2] * n2 + w
    t = -sd0 / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    return t, (denom < -1e-7) & (t > 0)


def _sphere_hit_t(sc, s, o, d):
    """Raw near-root t and validity of sphere s (the sphere branch of
    `_trace`; rays starting inside miss, near-root-only semantics)."""
    oc = (
        o[0] - sc["spheres"][s, 0],
        o[1] - sc["spheres"][s, 1],
        o[2] - sc["spheres"][s, 2],
    )
    r = sc["spheres"][s, 3]
    b = _dot(oc, d)
    c2 = _dot(oc, oc) - r * r
    disc = b * b - c2
    t = -b - jnp.sqrt(jnp.maximum(disc, 1e-12))
    return t, (disc > 0) & (t > 0)


def _box_occludes(sc, bx, o, d, tmax):
    """Does rounded box bx intersect the open segment (0, tmax)?

    The rounded box is convex (Minkowski sum of box and sphere), so it
    intersects the segment iff  min_{t∈[0,tmax]} g(t) < rnd²  where
    g(t) = Σ_i max(|oᵢ+dᵢt| − halfᵢ, 0)²  is the squared distance from the
    ray point to the inner box. g is convex piecewise-quadratic with ≤6
    breakpoints (slab crossings); g'(t)/2 = Σ dᵢ(xᵢ − clamp(xᵢ, ±halfᵢ))
    is monotone piecewise-linear, so the minimizer is bracketed by the
    largest candidate point with g'≤0 and the smallest with g'≥0, and one
    linear interpolation lands on it exactly.

    This matches the 26-candidate near-root semantics of `_trace` for all
    origins outside the box shell (every secondary-ray origin in practice;
    near-root `_trace` quirks for origins *inside* the shell differ only
    there). ~170 VPU ops vs ~580 for the full candidate sweep.
    """
    c = (sc["boxes"][bx, 0], sc["boxes"][bx, 1], sc["boxes"][bx, 2])
    half = (sc["boxes"][bx, 3], sc["boxes"][bx, 4], sc["boxes"][bx, 5])
    rnd = sc["boxes"][bx, 6]
    op = _sub(o, c)

    inv_d = tuple(
        1.0 / jnp.where(jnp.abs(d[k]) < 1e-12, 1e-12, d[k]) for k in range(3)
    )
    zeros = jnp.zeros_like(tmax)
    cands = [zeros, tmax]
    for k in range(3):
        for sgn in (1.0, -1.0):
            cands.append(
                jnp.clip((sgn * half[k] - op[k]) * inv_d[k], 0.0, tmax)
            )

    def gprime(t):
        acc = zeros
        for k in range(3):
            x = op[k] + d[k] * t
            acc = acc + d[k] * (x - jnp.clip(x, -half[k], half[k]))
        return acc

    t_lo = zeros
    t_hi = tmax
    gp_lo = gprime(zeros)
    gp_hi = gprime(tmax)
    for t_c in cands:
        gp = gprime(t_c)
        neg = gp <= 0.0
        better_lo = neg & (t_c >= t_lo)
        t_lo = jnp.where(better_lo, t_c, t_lo)
        gp_lo = jnp.where(better_lo, gp, gp_lo)
        pos = gp >= 0.0
        better_hi = pos & (t_c <= t_hi)
        t_hi = jnp.where(better_hi, t_c, t_hi)
        gp_hi = jnp.where(better_hi, gp, gp_hi)

    den = gp_hi - gp_lo
    frac = jnp.where(jnp.abs(den) < 1e-20, 0.0, gp_lo / jnp.where(
        jnp.abs(den) < 1e-20, 1.0, den))
    t_star = jnp.clip(t_lo - frac * (t_hi - t_lo), 0.0, tmax)

    g = zeros
    for k in range(3):
        x = op[k] + d[k] * t_star
        e = x - jnp.clip(x, -half[k], half[k])
        g = g + e * e
    # <=, not <: a sharp box (rnd == 0) has g exactly 0 along any interior
    # crossing — strict < would make it transparent to occlusion tests
    # while `_trace` still hits its faces. For rnd > 0 the boundary case is
    # exact tangency (measure-zero, inside `_trace`'s own disc fuzz).
    return g <= rnd * rnd


def _nearest_is_target(sc, counts, o, d, excl, t_target, target_valid,
                       skip_sphere_id=None):
    """True where the analytic target hit (t_target, target_valid) is the
    nearest scene hit from o along d — the occlusion-style replacement for
    `tid == target` after a full `_trace`. Candidate validity mirrors
    `consider` (raw-t comparison, strict <, per-candidate excl skip) plus
    the final zfar clamp. `skip_sphere_id`: plane scalar id whose sphere is
    the target itself (not an occluder)."""
    nP, nS, nB = counts
    occ = jnp.zeros_like(target_valid)
    for p in range(nP):
        t, v = _plane_hit_t(sc, p, o, d)
        occ = occ | (v & (sc["plane_ids"][p, 0] != excl) & (t < t_target))
    for s in range(nS):
        sid = sc["sphere_ids"][s, 0]
        t, v = _sphere_hit_t(sc, s, o, d)
        v = v & (sid != excl) & (t < t_target)
        if skip_sphere_id is not None:
            v = v & (sid != skip_sphere_id)
        occ = occ | v
    for bx in range(nB):
        occ = occ | (
            (sc["box_ids"][bx, 0] != excl) & _box_occludes(sc, bx, o, d, t_target)
        )
    return target_valid & jnp.logical_not(occ) & (t_target - gmath.EPS <= gmath.ZFAR)


def _light_visible(sc, counts, o, d, excl):
    """Occlusion-style `nearest hit == light` (common.glsl:348-353)."""
    lx, ly, lz, lr = _light_vec(sc)
    oc = (o[0] - lx, o[1] - ly, o[2] - lz)
    b = _dot(oc, d)
    c2 = _dot(oc, oc) - lr * lr
    disc = b * b - c2
    t_l = -b - jnp.sqrt(jnp.maximum(disc, 1e-12))
    light_id = sc["light_id_arr"][0, 0]
    valid = (disc > 0) & (t_l > 0) & (light_id != excl)
    return _nearest_is_target(
        sc, counts, o, d, excl, t_l, valid, skip_sphere_id=light_id
    )


# ----------------------------------------------------------- materials

def _surface(sc, ho, hl, nK):
    """Component form of materials.surface: per-ID table rows selected with
    a where-chain (K is small and static)."""
    alb = [jnp.zeros_like(hl[0]) for _ in range(3)]
    emi = [jnp.zeros_like(hl[0]) for _ in range(3)]
    ene = [jnp.zeros_like(hl[0]) for _ in range(2)]
    for k in range(nK):
        sel = ho == k
        freq = sc["mat_freq"][k, 0]
        s = jnp.floor(hl[0] * freq) + jnp.floor(hl[1] * freq) + jnp.floor(hl[2] * freq)
        checker = jnp.abs(jnp.mod(s, 2.0))
        sval = sc["mat_s0"][k, 0] + sc["mat_s1"][k, 0] * checker
        for c in range(3):
            alb[c] = jnp.where(
                sel, sc["mat_alb_const"][k, c] + sc["mat_alb_scale"][k, c] * sval, alb[c]
            )
            emi[c] = jnp.where(sel, sc["mat_emission"][k, c], emi[c])
        for c in range(2):
            ene[c] = jnp.where(
                sel, sc["mat_en_const"][k, c] + sc["mat_en_scale"][k, c] * sval, ene[c]
            )
    return tuple(alb), tuple(emi), tuple(ene)


# ----------------------------------------------------------- MIS pieces

def _light_vec(sc):
    return (
        sc["light"][0, 0], sc["light"][0, 1], sc["light"][0, 2], sc["light"][0, 3]
    )


def _plane_pdf_lambert(sc, p, hl, pre):
    """lambert_plane_pdf for plane p (common.glsl:308-322), component form."""
    lx, ly, lz, lr = _light_vec(sc)
    n = (sc["planes"][p, 0], sc["planes"][p, 1], sc["planes"][p, 2])
    w = sc["planes"][p, 3]
    ldn = lx * n[0] + ly * n[1] + lz * n[2] + w
    d = (lx - n[0] * ldn, ly - n[1] * ldn, lz - n[2] * ldn)
    dv = (d[0] - hl[0], d[1] - hl[1], d[2] - hl[2])
    ld = (lx - d[0], ly - d[1], lz - d[2])
    dv2 = _dot(dv, dv)
    frad = jnp.minimum(
        jnp.sqrt(jnp.maximum(dv2, 1e-20)),
        jnp.sqrt(jnp.maximum(_dot(ld, ld), 1e-20)),
    ) * 0.9
    dir_ = _cone_dir(dv, frad, pre)
    lpdf = _solid_angle(dv2, frad * frad) / gmath.PI
    g2 = jnp.maximum(gmath.EPS, -(dir_[0] * n[0] + dir_[1] * n[1] + dir_[2] * n[2]))
    ok = dv2 > 1e-12
    return dir_, jnp.where(ok, lpdf * g2, 0.0)


def _plane_pdf_phong(sc, p, hl, pre):
    """phong_plane_pdf for plane p (common.glsl:325-343), component form."""
    lx, ly, lz, lr = _light_vec(sc)
    n = (sc["planes"][p, 0], sc["planes"][p, 1], sc["planes"][p, 2])
    w = sc["planes"][p, 3]
    a = _dot(hl, n) + w
    b = lx * n[0] + ly * n[1] + lz * n[2] + w
    ab = a + b
    ab = jnp.where(jnp.abs(ab) < 1e-6, 1e-6, ab)
    fac = a / ab
    s = (
        (hl[0] - a * n[0]) + ((lx - b * n[0]) - (hl[0] - a * n[0])) * fac,
        (hl[1] - a * n[1]) + ((ly - b * n[1]) - (hl[1] - a * n[1])) * fac,
        (hl[2] - a * n[2]) + ((lz - b * n[2]) - (hl[2] - a * n[2])) * fac,
    )
    sv = _sub(s, hl)
    sv2 = _dot(sv, sv)
    lsv = jnp.sqrt(jnp.maximum(sv2, 1e-20)) * lr
    ls = (lx - s[0], ly - s[1], lz - s[2])
    lsn = jnp.sqrt(jnp.maximum(_dot(ls, ls), 1e-20))
    ts = _scale(sv, lsn)
    dir_ = _cone_dir(ts, lsv, pre)
    lpdf = _solid_angle(_dot(ts, ts), lsv * lsv) / gmath.PI
    nsv = _normalize(sv)
    spdf = _schlick(1.0, 3.0, _dot(nsv, n))
    ok = sv2 > 1e-12
    return dir_, jnp.where(ok, lpdf * spdf, 0.0)


def _roulette(sc, counts, dirs, ws, hl, ho, pre, energy_channel, nP):
    """CDF roulette over the P plane strategies + contribution march
    (common.glsl:453-519; render/mis._roulette_from in component form).

    The plane-verify march is occlusion-style: the selected plane's hit t
    is analytic (one ray-plane solve on the gathered plane), `ok` checks
    nothing else hits strictly before it, and the light re-sample from the
    plane point is `_light_visible` — no nearest-hit sweeps."""
    cdf = []
    acc = jnp.zeros_like(ws[0])
    for p in range(nP):
        acc = acc + ws[p]
        cdf.append(acc)
    total = acc
    rnd = pre[3] * total

    # Select the first p with rnd <= cdf_p (last plane unconditional).
    idx = jnp.zeros_like(ho)
    for p in range(nP - 1):
        idx = idx + (rnd > cdf[p]).astype(idx.dtype)

    dir_sel = dirs[0]
    w_sel = ws[0]
    n_sel = (
        jnp.full_like(hl[0], 0.0),
        jnp.full_like(hl[0], 0.0),
        jnp.full_like(hl[0], 0.0),
    )
    pw_sel = jnp.zeros_like(hl[0])
    po_sel = jnp.zeros_like(ho)
    for p in range(nP):
        m = idx == p
        dir_sel = _where_v(m, dirs[p], dir_sel)
        w_sel = jnp.where(m, ws[p], w_sel)
        n_sel = _where_v(
            m,
            (
                jnp.broadcast_to(sc["planes"][p, 0], hl[0].shape),
                jnp.broadcast_to(sc["planes"][p, 1], hl[0].shape),
                jnp.broadcast_to(sc["planes"][p, 2], hl[0].shape),
            ),
            n_sel,
        )
        pw_sel = jnp.where(m, sc["planes"][p, 3], pw_sel)
        po_sel = jnp.where(m, sc["plane_ids"][p, 0], po_sel)

    # Analytic hit on the selected plane + occlusion verify
    # (common.glsl:356-371). The selected plane is among the occluder
    # candidates in `_nearest_is_target`, but its candidate t equals tp
    # bitwise (same formula, same inputs), so strict < never self-occludes.
    denom = _dot(dir_sel, n_sel)
    sd0 = _dot(hl, n_sel) + pw_sel
    tp = -sd0 / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    valid_p = (denom < -1e-7) & (tp > 0) & (po_sel != ho)
    ok = _nearest_is_target(sc, counts, hl, dir_sel, ho, tp, valid_p)

    t = tp - gmath.EPS
    hl2 = (
        hl[0] + dir_sel[0] * t + n_sel[0] * gmath.EPS,
        hl[1] + dir_sel[1] * t + n_sel[1] * gmath.EPS,
        hl[2] + dir_sel[2] * t + n_sel[2] * gmath.EPS,
    )
    lx, ly, lz, lr = _light_vec(sc)
    lv2 = (lx - hl2[0], ly - hl2[1], lz - hl2[2])
    sample_dir = _cone_dir(lv2, lr, pre)
    lhit = _light_visible(sc, counts, hl2, sample_dir, po_sel)
    lc = [
        jnp.where(lhit, sc["light_color"][0, c] * w_sel, 0.0) for c in range(3)
    ]
    alb, emi, ene = _surface(sc, po_sel, hl2, sc["nK"])
    e = ene[energy_channel]
    contrib = [emi[c] + e * alb[c] * lc[c] for c in range(3)]
    boost = total / jnp.maximum(gmath.EPS, w_sel)
    return [jnp.where(ok, contrib[c] * boost, 0.0) for c in range(3)]


# ------------------------------------------ unbiased ground-truth (G11)

def _logit3(v):
    """common.glsl:48-51, component form: logit-warp ≈ gaussian."""
    out = []
    for c in v:
        t = 0.988 * (c + 0.006)
        out.append(jnp.log(t / (1.0 - t)) * 0.221 + 0.5)
    return out


def _cos_hemi_dir(hn, seed):
    """cosHemiDir (common.glsl:182-185): normalize(n + uniformDir·ieps)."""
    u = _weyl3(seed)
    g = _logit3(u)
    s = (g[0] * 2.0 - 1.0, g[1] * 2.0 - 1.0, g[2] * 2.0 - 1.0)
    d = _normalize(s)
    return _normalize(
        (hn[0] + d[0] * gmath.IEPS, hn[1] + d[1] * gmath.IEPS,
         hn[2] + d[2] * gmath.IEPS)
    )


def _shade_core_unbiased(sc, counts, gloss, hn, rd, ho, hl, seed, smp,
                         decorrelate):
    """UnbiasedLambertian / UnbiasedPhong (common.glsl:394-415): cosine-
    hemisphere and mirror-reflect brute force, light hit weighted by pdf=π
    (lambert) / 1 (phong). The phong direction is seed-independent, so its
    smp-loop is a single evaluation (the reference's loop adds the same
    contribution smp times then divides)."""
    from kylespathtracer.ops.frame_kernel import _fold_seed

    est_d = [jnp.zeros_like(hl[0]) for _ in range(3)]
    for i in range(smp):
        si = _fold_seed(seed, i, decorrelate)
        d = _cos_hemi_dir(hn, si)
        vis = _light_visible(sc, counts, hl, d, ho)
        for c in range(3):
            est_d[c] = est_d[c] + jnp.where(
                vis, sc["light_color"][0, c] * gmath.PI, 0.0
            )
    if smp > 1:
        est_d = [e * (1.0 / float(smp)) for e in est_d]

    # Plain reflect, not re-normalized (mis.unbiased_phong parity).
    refl = _reflect(rd, hn)
    vis_s = _light_visible(sc, counts, hl, refl, ho)
    est_s = [
        jnp.where(vis_s, sc["light_color"][0, c], 0.0) for c in range(3)
    ]
    return est_d, est_s


# ----------------------------------------------------------- shade core

def _soft_transmittance(sc, nS, hl, dl_dir, t_surf, ho, beta: float):
    """Component form of diff/softvis.sphere_soft_transmittance: smooth
    visibility Π_spheres σ(sd_i/(β·t_i)) along the shadow ray, skipping the
    light and the shaded object itself."""
    trans = jnp.ones_like(hl[0])
    light_id = sc["light_id_arr"][0, 0]
    for s in range(nS):
        c = (sc["spheres"][s, 0], sc["spheres"][s, 1], sc["spheres"][s, 2])
        r = sc["spheres"][s, 3]
        oc = _sub(c, hl)
        tc = jnp.clip(_dot(oc, dl_dir), gmath.EPS, t_surf)
        closest = (
            hl[0] + dl_dir[0] * tc - c[0],
            hl[1] + dl_dir[1] * tc - c[1],
            hl[2] + dl_dir[2] * tc - c[2],
        )
        sd = jnp.sqrt(jnp.maximum(_dot(closest, closest), 1e-20)) - r
        v = jax.nn.sigmoid(sd / (beta * tc))
        skip = (sc["sphere_ids"][s, 0] == light_id) | (sc["sphere_ids"][s, 0] == ho)
        trans = trans * jnp.where(skip, 1.0, v)
    return trans


def _shade_core(sc, counts, nK, gloss, hn, rd, ho, hl, seed, soft_beta=0.0):
    """Direct light + the four plane-strategy roulettes for both estimators
    (common.glsl:430-616) → (est_d, est_s) as 3-component lists, unmasked.

    Used by the fused full frame (ops/frame_kernel.frame_block).
    `soft_beta > 0` (static) smooths the direct-light
    sphere occlusion into a differentiable transmittance exactly like
    render/mis.dual_mis with config.soft_shadows: the hard trace still gates
    plane/box occlusion, only sphere silhouettes are softened."""
    lx, ly, lz, lr = _light_vec(sc)
    pre = _cone_pre(seed)
    lv = (lx - hl[0], ly - hl[1], lz - hl[2])
    dl_dir = _cone_dir(lv, lr, pre)
    dl_pdf = _solid_angle(_dot(lv, lv), lr * lr)
    lam_w = jnp.maximum(gmath.EPS, _dot(dl_dir, hn))
    refl = _reflect(rd, hn)
    pho_w = _powi(jnp.maximum(gmath.EPS, _dot(dl_dir, refl)), int(gloss))

    if soft_beta > 0.0:
        # The soft path needs the nearest-hit *identity* (is the nearest a
        # sphere?), not just a boolean — keep the full trace here; it only
        # runs in the inverse-rendering configs.
        _, vis_id = _trace(sc, hl, dl_dir, ho, *counts)
        nS = counts[1]
        dist = jnp.sqrt(jnp.maximum(_dot(lv, lv), 1e-20))
        t_surf = jnp.maximum(dist - lr, gmath.EPS)
        trans = _soft_transmittance(sc, nS, hl, dl_dir, t_surf, ho, soft_beta)
        # Nearest shadow-ray hit must be a sphere (incl. the light) for the
        # smooth transmittance to apply; plane/box occlusion stays hard
        # (render/mis.py dual_mis soft branch).
        sol = jnp.zeros_like(ho, dtype=jnp.bool_)
        for s in range(nS):
            sol = sol | (vis_id == sc["sphere_ids"][s, 0])
        vis = jnp.where(sol, trans, 0.0)
    else:
        vis = _light_visible(sc, counts, hl, dl_dir, ho).astype(hl[0].dtype)

    est_d = [sc["light_color"][0, c] * (vis * dl_pdf * lam_w) for c in range(3)]
    est_s = [sc["light_color"][0, c] * (vis * dl_pdf * pho_w) for c in range(3)]

    nP = counts[0]
    dirs_l, wpdf_l, dirs_p, wpdf_p = [], [], [], []
    for p in range(nP):
        dl, pl_ = _plane_pdf_lambert(sc, p, hl, pre)
        dp_, pp_ = _plane_pdf_phong(sc, p, hl, pre)
        dirs_l.append(dl)
        wpdf_l.append(pl_)
        dirs_p.append(dp_)
        wpdf_p.append(pp_)

    def lam(d):
        return jnp.maximum(gmath.EPS, _dot(d, hn))

    def pho(d):
        return _powi(jnp.maximum(gmath.EPS, _dot(d, refl)), int(gloss))

    wl_lam = [wpdf_l[p] * lam(dirs_l[p]) for p in range(nP)]
    wp_lam = [wpdf_p[p] * lam(dirs_p[p]) for p in range(nP)]
    wl_pho = [wpdf_l[p] * pho(dirs_l[p]) for p in range(nP)]
    wp_pho = [wpdf_p[p] * pho(dirs_p[p]) for p in range(nP)]

    for ws, dirs, ch, est in (
        (wl_lam, dirs_l, 0, est_d),
        (wp_lam, dirs_p, 1, est_d),
        (wl_pho, dirs_l, 0, est_s),
        (wp_pho, dirs_p, 1, est_s),
    ):
        r = _roulette(sc, counts, dirs, ws, hl, ho, pre, ch, nP)
        for c in range(3):
            est[c] = est[c] + r[c]
    return est_d, est_s
