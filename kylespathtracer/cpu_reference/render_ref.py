"""CPU (NumPy) re-execution of the full reference frame pipeline.

Ports the four fragment shaders (geometry.frag, diffuse.frag, specular.frag,
passthrough.frag) on top of the `glslref` math twin, following the GLSL
control flow directly. State handling follows the JAX build's sane-ified
conventions, which the SURVEY mandates instead of the reference's GL hacks:

- camera is passed as state, not smuggled through top-row pixels
  (geometry.frag:58-64 → plain arguments);
- history is (rgb, count, id) SoA instead of alpha-packing
  (common.glsl:629-635);
- miss pixels are masked out of shading instead of NaN normals
  (common.glsl:625);
- out-of-image reprojection taps are zero-weighted.

Used by tests/test_pipeline_vs_ref.py for image-level allclose.
"""

from __future__ import annotations

import numpy as np

from kylespathtracer.cpu_reference import glslref as g

f32 = np.float32

TEMPORAL = 16
GLOSS = f32(5.0)
BRIGHTNESS = f32(10.0)

PLANE_LIST = [  # DMIS strategy order (common.glsl:459-462)
    (g.PLANES[g.FLOOR], g.FLOOR),
    (g.PLANES[g.CEIL], g.CEIL),
    (g.PLANES[g.WALL1], g.WALL1),
    (g.PLANES[g.WALL2], g.WALL2),
]


def ray_dirs(cam_orient, W, H):
    asp = f32(W / H)
    x = (2.0 * (np.arange(W, dtype=f32) + 0.5) / W - 1.0) * asp
    y = 2.0 * (np.arange(H, dtype=f32) + 0.5) / H - 1.0
    ndca = np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1)
    v = np.concatenate([ndca, np.full((H, W, 1), g.FOV, f32)], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return g.rotate_xy(v, np.asarray(cam_orient, f32))


def render_gbuffer(cam_loc, cam_orient, W, H):
    """geometry.frag:66-72."""
    rd = ray_dirs(cam_orient, W, H)
    ro = np.broadcast_to(np.asarray(cam_loc, f32), rd.shape)
    t, oid = g.march(ro, rd)
    hl = ro + rd * t[..., None]
    n, _ = g.norcurv(hl)
    n = np.where((oid > 0)[..., None], n, 0.0)
    return n.astype(f32), oid, (t - g.EPS).astype(f32), rd


def sphere_light_pdf(hl, seed):
    """common.glsl:300-305."""
    lv = g.LIGHT_SPHERE[:3] - hl
    d = g.uniform_cone_dir(lv, g.LIGHT_SPHERE[3], seed)
    pdf = g.solid_angle(np.sum(lv * lv, -1), g.LIGHT_SPHERE[3] ** 2)
    return d, pdf


def lambert_plane_pdf(hl, pl, seed):
    """common.glsl:308-322."""
    n, w = pl[:3], pl[3]
    li = g.LIGHT_SPHERE[:3]
    d = li - n * (np.dot(li, n) + w)
    dv = d - hl
    ld = li - d
    frad = np.minimum(np.linalg.norm(dv, axis=-1), np.linalg.norm(ld)) * f32(0.9)
    dir_ = g.uniform_cone_dir(dv, frad, seed)
    lpdf = g.solid_angle(np.sum(dv * dv, -1), frad * frad) / g.PI
    g2 = g.lambertian(np.broadcast_to(n, dir_.shape), -dir_)
    return dir_, lpdf * g2


def phong_plane_pdf(hl, pl, seed):
    """common.glsl:325-343."""
    n, w = pl[:3], pl[3]
    li = g.LIGHT_SPHERE[:3]
    a = np.sum(hl * n, -1) + w
    b = np.dot(li, n) + w
    ab = a + b
    ab = np.where(np.abs(ab) < 1e-6, f32(1e-6), ab)
    s = (hl - a[..., None] * n) * (1 - (a / ab))[..., None] + (
        li - b * n
    ) * (a / ab)[..., None]
    sv = s - hl
    lsv = np.sqrt(np.sum(sv * sv, -1)) * g.LIGHT_SPHERE[3]
    ls = li - s
    ts = sv * np.sqrt(np.sum(ls * ls, -1))[..., None]
    dir_ = g.uniform_cone_dir(ts, lsv, seed)
    lpdf = g.solid_angle(np.sum(ts * ts, -1), lsv * lsv) / g.PI
    nsv = sv / np.maximum(np.linalg.norm(sv, axis=-1, keepdims=True), 1e-20)
    spdf = g.schlick(f32(1.0), f32(3.0), np.sum(nsv * n, -1))
    return dir_, lpdf * spdf


def light_contribution(hl, ho, dir_, pdfw):
    """common.glsl:348-353."""
    _, mid = march_excl(hl, dir_, ho)
    hit = mid == g.LIGHT
    return np.where(hit[..., None], g.LIGHT_COLOR * pdfw[..., None], f32(0.0))


def march_excl(ro, rd, excl):
    """march with per-pixel exclusion ids (vector form of common.glsl:283)."""
    t = np.zeros(ro.shape[:-1], f32)
    hid = np.zeros(ro.shape[:-1], np.int32)
    done = np.zeros(ro.shape[:-1], bool)
    missed = np.zeros(ro.shape[:-1], bool)
    for _ in range(255):
        if done.all():
            break
        p = ro + rd * t[..., None]
        d, oid = sdf_excl(p, excl)
        hit_now = d < g.EPS
        t_new = np.where(done, t, t + d)
        miss_now = (t_new > g.ZFAR) & ~hit_now
        hid = np.where(done, hid, np.where(miss_now, 0, oid))
        missed = np.where(done, missed, miss_now)
        done = done | hit_now | miss_now
        t = t_new
    return np.where(missed, g.ZFAR, np.minimum(t, g.ZFAR)), hid


def sdf_excl(p, excl):
    """common.glsl:264-273 with per-pixel exclusion array."""
    d = np.full(p.shape[:-1], g.ZFAR, f32)
    oid = np.zeros(p.shape[:-1], np.int32)

    def consider(dist, this_id):
        nonlocal d, oid
        take = (dist <= d) & (excl != this_id)
        d = np.where(take, dist, d)
        oid = np.where(take, np.int32(this_id), oid)

    for pid, pl in g.PLANES.items():
        consider(np.sum(p * pl[:3], -1) + pl[3], pid)
    consider(
        np.linalg.norm(p - g.LIGHT_SPHERE[:3], axis=-1) - g.LIGHT_SPHERE[3], g.LIGHT
    )
    consider(g.sd_box(p - g.BOX_CENTER, g.BOX_HALF) - g.BOX_ROUND, g.BOX)
    return d, oid


def get_surface_v(ho, hl):
    """Vectorized getSurface over the pixel grid."""
    alb = np.zeros(hl.shape, f32)
    emi = np.zeros(hl.shape, f32)
    ene = np.zeros(hl.shape[:-1] + (2,), f32)
    for oid in (g.LIGHT, g.FLOOR, g.WALL1, g.BOX, g.WALL2, g.CEIL):
        m = ho == oid
        if not m.any():
            continue
        pts = hl[m]
        for j in range(pts.shape[0]):
            a, e, en = g.get_surface(oid, pts[j])
            idx = np.argwhere(m)[j]
            alb[tuple(idx)] = a
            emi[tuple(idx)] = e
            ene[tuple(idx)] = en
    return alb, emi, ene


def plane_contrib(dir_, pdfw, hl, ho, pl, po, seed, channel):
    """common.glsl:356-389 (channel 0=lambert/diffuse energy, 1=phong)."""
    t, tid = march_excl(hl, dir_, ho)
    ok = tid == po
    n = pl[..., :3]
    hl2 = hl + dir_ * t[..., None] + n * g.EPS
    lv2 = g.LIGHT_SPHERE[:3] - hl2
    sample_dir = g.uniform_cone_dir(lv2, g.LIGHT_SPHERE[3], seed)
    lc = light_contribution(hl2, po, sample_dir, pdfw)
    alb, emi, ene = get_surface_v(po, hl2)
    contrib = emi + ene[..., channel:channel + 1] * alb * lc
    return np.where(ok[..., None], contrib, f32(0.0))


def _roulette(hl, ho, seed, pdf_fn, brdf_w, channel):
    """The 4-plane CDF roulette shared by all indirect blocks
    (common.glsl:453-519)."""
    dirs, ws = [], []
    for pl, pid in PLANE_LIST:
        d_, w_ = pdf_fn(hl, pl, seed)
        ws.append(w_ * brdf_w(d_))
        dirs.append(d_)
    ws = np.stack(ws, axis=-1)           # (...,4)
    dirs = np.stack(dirs, axis=-2)       # (...,4,3)
    cdf = np.cumsum(ws, axis=-1)
    total = cdf[..., -1]
    rnd = g.weyl3(seed)[..., 2] * total
    idx = np.sum((rnd[..., None] > cdf[..., :-1]), axis=-1).astype(np.int32)

    out = np.zeros(hl.shape, f32)
    for k in range(4):
        m = idx == k
        if not m.any():
            continue
        pl, pid = PLANE_LIST[k]
        sub = plane_contrib(
            dirs[..., k, :][m], ws[..., k][m], hl[m], ho[m],
            pl, np.full(m.sum(), pid, np.int32), seed[m], channel,
        )
        out[m] = sub * (total[m] / np.maximum(g.EPS, ws[..., k][m]))[..., None]
    return out


def dmis(hl, hn, ho, seed):
    """common.glsl:430-522 with all SMP_* = 1."""
    lam = lambda d: np.maximum(g.EPS, np.sum(d * hn, -1))
    d_dir, d_pdf = sphere_light_pdf(hl, seed)
    ret = light_contribution(hl, ho, d_dir, d_pdf * g.lambertian(hn, d_dir))
    ret += _roulette(hl, ho, seed, lambert_plane_pdf, lam, 0)
    ret += _roulette(hl, ho, seed, phong_plane_pdf, lam, 1)
    return ret


def smis(rd, hl, hn, ho, seed):
    """common.glsl:525-616."""
    pho = lambda d: np.maximum(g.EPS, np.sum(d * g.reflect(rd, hn), -1)) ** GLOSS
    d_dir, d_pdf = sphere_light_pdf(hl, seed)
    ret = light_contribution(hl, ho, d_dir, d_pdf * g.phong(rd, hn, d_dir, GLOSS))
    ret += _roulette(hl, ho, seed, lambert_plane_pdf, pho, 0)
    ret += _roulette(hl, ho, seed, phong_plane_pdf, pho, 1)
    return ret


def reproject(ll, lo, hl, ho, prev_rgb, prev_cnt, prev_id, W, H):
    """common.glsl:661-694."""
    asp = f32(W / H)
    lf = g.rotate_xy(np.array([0, 0, 1], f32), np.asarray(lo, f32))
    r = np.cross(lf, np.array([0, 1, 0], f32))
    r /= np.linalg.norm(r)
    u = np.cross(lf, r)
    u /= np.linalg.norm(u)
    nhl = ll - hl
    nhl /= np.maximum(np.linalg.norm(nhl, axis=-1, keepdims=True), 1e-20)
    denom = np.sum(nhl * lf, -1)
    denom = np.where(np.abs(denom) < 1e-6, f32(1e-6), denom)
    luv = np.stack([np.sum(nhl * r, -1), np.sum(nhl * u, -1)], -1)
    luv = luv / denom[..., None] * g.FOV / np.array([asp, 1.0], f32)
    inside = np.all((luv <= 1.0) & (luv >= -1.0), -1)
    fuv = (luv * -0.5 + 0.5) * np.array([W, H], f32) - 0.5
    iuv = np.trunc(fuv).astype(np.int32)
    duv = fuv - iuv

    def tap(dx, dy):
        x = iuv[..., 0] + dx
        y = iuv[..., 1] + dy
        inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        xc = np.clip(x, 0, W - 1)
        yc = np.clip(y, 0, H - 1)
        m = ((prev_id[yc, xc] == ho) & inb & inside).astype(f32)
        return prev_rgb[yc, xc] * m[..., None], prev_cnt[yc, xc] * m

    r00, c00 = tap(0, 0)
    r10, c10 = tap(1, 0)
    r01, c01 = tap(0, 1)
    r11, c11 = tap(1, 1)
    dx, dy = duv[..., 0], duv[..., 1]
    mx = lambda a, b, t: a + (b - a) * t
    rgb = mx(mx(r00, r10, dx[..., None]), mx(r01, r11, dx[..., None]), dy[..., None])
    cnt = mx(mx(c00, c10, dx), mx(c01, c11, dx), dy)
    return rgb, cnt


def accumulation_pass(kind, cam_loc, cam_orient, prev_loc, prev_orient,
                      gb, prev, frame, W, H, temporal=TEMPORAL):
    """diffuse.frag / specular.frag renderDiffuse/renderSpecular."""
    hn, ho, depth, rd = gb
    hl = np.asarray(cam_loc, f32) + rd * depth[..., None]
    vv = f32(np.linalg.norm(np.asarray(cam_loc, f32) - np.asarray(prev_loc, f32)))
    prev_rgb, prev_cnt, prev_id = prev

    if kind == "specular":
        _, curv = g.norcurv(hl)
        light_dist = np.linalg.norm(hl - g.LIGHT_SPHERE[:3], axis=-1)
        fac = g.EPS / np.sqrt(np.maximum(g.EPS, curv))
        anchor = hl + rd * (light_dist * fac)[..., None]
    else:
        anchor = hl

    rgb, cnt = reproject(
        np.asarray(prev_loc, f32), prev_orient, anchor, ho,
        prev_rgb, prev_cnt, prev_id, W, H,
    )
    cnt = np.floor(cnt)
    lvv = min(temporal - 1.0, float(int(temporal * 2.0 * np.sqrt(vv))))
    limit = f32(temporal - lvv)
    over = cnt > limit
    scale = np.where(over, limit / np.maximum(cnt, 1e-6), f32(1.0))
    rgb = rgb * scale[..., None]
    cnt = np.where(over, limit, cnt)

    _, emi, _ = get_surface_v(ho, hl)
    rgb = rgb + emi

    px = np.broadcast_to(np.arange(W, dtype=np.int32)[None, :], (H, W))
    py = np.broadcast_to(np.arange(H, dtype=np.int32)[:, None], (H, W))
    seed = g.gen_seed(frame, px, py, W, H)

    if kind == "specular":
        est = smis(rd, hl, hn, ho, seed)
    else:
        est = dmis(hl, hn, ho, seed)
    shade = (ho != g.LIGHT) & (ho > 0)
    rgb = rgb + np.where(shade[..., None], est, f32(0.0))
    return rgb.astype(f32), (cnt + 1.0).astype(f32), ho


def composite(cam_loc, gb, d, s, brightness=BRIGHTNESS):
    """passthrough.frag:29-47."""
    hn, ho, depth, rd = gb
    hl = np.asarray(cam_loc, f32) + rd * depth[..., None]
    alb, _, ene = get_surface_v(ho, hl)
    d_rgb, d_cnt, _ = d
    s_rgb, s_cnt, _ = s
    dc = d_rgb * alb * ene[..., 0:1]
    sc = s_rgb * np.sqrt(np.maximum(alb, 0.0)) * ene[..., 1:2]
    img = dc / np.maximum(np.floor(d_cnt), 1.0)[..., None] + sc / np.maximum(
        np.floor(s_cnt), 1.0
    )[..., None]
    return g.linear_srgb(g.aces_fitted(img * brightness))


def render_frame(cam_loc, cam_orient, prev_loc, prev_orient, history, frame, W, H):
    """Full frame; history = (diffuse(rgb,cnt,id), specular(rgb,cnt,id))."""
    gb = render_gbuffer(cam_loc, cam_orient, W, H)
    d = accumulation_pass(
        "diffuse", cam_loc, cam_orient, prev_loc, prev_orient, gb,
        history[0], frame, W, H,
    )
    s = accumulation_pass(
        "specular", cam_loc, cam_orient, prev_loc, prev_orient, gb,
        history[1], frame, W, H,
    )
    img = composite(cam_loc, gb, d, s)
    return img, (d, s)


def zero_history(W, H):
    z = lambda: (
        np.zeros((H, W, 3), f32), np.zeros((H, W), f32), np.zeros((H, W), np.int32)
    )
    return (z(), z())
