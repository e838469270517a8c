"""
GL-exact NumPy oracle renderer for PSNR parity checks.

An INDEPENDENT float32 NumPy transcription of the reference's GLSL pipeline
(/root/reference/shaderflow/resources/shaders/): the vertex-shader
coordinate set (vertex/default.glsl:4-16), the GetCamera macro +
CameraProject/CameraRay2D (include/camera.glsl:55-130), the stdlib pieces
the graded scenes touch (include/shaderflow.glsl: atan2 382-400, hsv2rgb
406-424, palette 212-226), the default fragment (fragment/default.glsl),
the Mandelbrot/Julia escape fragments (examples/fractals/shaders/*.frag),
and the final SSAA box downsample + UNSIGNED_BYTE store
(fragment/final.glsl:12-32).

This is the acceptance oracle for BASELINE.json's "PSNR >= 40 dB vs the
OpenGL reference": it consumes the SAME per-frame uniform dict the engine
captures (host state is GL-independent) and renders what the GL driver
would, up to f32 transcendental ULPs. tests/test_psnr_reference.py asserts
the engine's frames against it.

GL conventions honored:
  * fragments at pixel centers, framebuffer row 0 = BOTTOM (output flipped
    to the engine's row-0-top convention at the end)
  * all math in float32
  * u8 store = floor(clamp(c,0,1)*255 + 0.5)
"""

from __future__ import annotations

import numpy as np

F = np.float32
PI = F(np.pi)
TAU = F(2 * np.pi)


# --------------------------------------------------------------------------- #
# Coordinates (vertex/default.glsl): interpolated over the fullscreen quad,
# fragment at pixel center, row 0 = bottom (GL raster order)

def coords(width: int, height: int, aspect: float):
    x = (np.arange(width, dtype=F) + F(0.5)) / F(width)       # astuv.x
    y = (np.arange(height, dtype=F) + F(0.5)) / F(height)     # astuv.y, bottom-up
    astuv = np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1).astype(F)
    agluv = astuv * F(2) - F(1)
    gluv = agluv * np.array([aspect, 1.0], F)
    return dict(astuv=astuv, agluv=agluv, gluv=gluv)


# --------------------------------------------------------------------------- #
# Stdlib pieces (include/shaderflow.glsl)

def gl_atan2(y, x):
    """atan2 with (0, 2pi) range (shaderflow.glsl:382-388)."""
    base = np.arctan2(y.astype(F), x.astype(F)).astype(F)
    neg = np.arctan2((-y).astype(F), x.astype(F)).astype(F)
    return np.where(y < 0, TAU - neg, base).astype(F)


def hsv2rgb(h, s, v):
    """shaderflow.glsl:406-424 (switch on floor(6h/2pi))."""
    h = np.mod(h.astype(F), TAU)
    c = F(v) * F(s)
    x = c * (1 - np.abs(np.mod(h / (PI / 3), F(2)) - 1)).astype(F)
    m = F(v) - c
    sector = np.floor(6 * (h / TAU)).astype(np.int32)
    zeros = np.zeros_like(h)
    r = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4], [c, x, zeros, zeros, x], c)
    g = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4], [x, c, c, x, zeros], zeros)
    b = np.select([sector == 0, sector == 1, sector == 2,
                   sector == 3, sector == 4], [zeros, zeros, x, c, c], x)
    m = np.asarray(m, F)
    return (np.stack([r, g, b], axis=-1) + m[..., None]).astype(F)


def palette(t, a, b, c, d):
    """4-stop palette (shaderflow.glsl:212-220)."""
    t = np.asarray(t, F)[..., None]
    a, b, c, d = (np.array(v, F) for v in (a, b, c, d))
    out = np.where(t < 0.25, a + (b - a) * (t * 4),
                   np.where(t < 0.5, b + (c - b) * ((t - F(0.25)) * 4),
                            c + (d - c) * ((t - F(0.5)) * 4)))
    return out.astype(F)


MAGMA = ((0.01060815, 0.01808215, 0.10018654),
         (0.38092887, 0.12061482, 0.32506528),
         (0.79650140, 0.10506637, 0.31063031),
         (0.95922872, 0.53307513, 0.37488950))


def palette_magma(t):
    return palette(t, *MAGMA)


# --------------------------------------------------------------------------- #
# Camera (include/camera.glsl) — perspective projection + CameraRay2D

def get_camera(uniforms: dict, co: dict, name: str = "iCamera"):
    """GetCamera macro -> dict with gluv (H, W, 2) and out_of_bounds (H, W).
    Consumes the engine-captured uniform values (host camera state)."""
    u = lambda key: np.asarray(uniforms[f"{name}{key}"], F)
    gluv = co["gluv"]
    position = u("Position")
    right, up, forward = u("Right"), u("Upward"), u("Forward")
    backward = -forward
    zoom, iso = F(u("Zoom")), F(u("Isometric"))
    orbital, dolly = F(u("Orbital")), F(u("Dolly"))
    focal = F(u("FocalLength"))

    def rectangle(g, size):
        return (size * (g[..., 0:1] * right + g[..., 1:2] * up)).astype(F)

    origin = (position + rectangle(gluv, zoom * iso)
              + backward * orbital + backward * dolly).astype(F)
    target = (position + rectangle(gluv, zoom)
              + backward * orbital + forward * focal).astype(F)

    plane_point = np.array([0, 0, 1], F)
    plane_normal = np.array([0, 0, 1], F)
    num = ((plane_point - origin) * plane_normal).sum(-1).astype(F)
    den = ((target - origin) * plane_normal).sum(-1).astype(F)
    t = (num / den).astype(F)
    hit = (origin + t[..., None] * (target - origin)).astype(F)

    want_aspect = F(np.asarray(uniforms["iWantAspect"], F))
    out_of_bounds = (t < 0) | (np.abs(gluv[..., 0]) > want_aspect)
    cam_gluv = hit[..., 0:2]
    aspect = F(co["gluv"][0, 1, 0] / co["agluv"][0, 1, 0])
    return dict(gluv=cam_gluv, agluv=cam_gluv / np.array([aspect, 1], F),
                out_of_bounds=out_of_bounds,
                origin=origin, target=target)


# --------------------------------------------------------------------------- #
# Fragments

def default_fragment(uniforms: dict, width: int, height: int, aspect: float):
    """fragment/default.glsl (the welcome neon ring) -> (H, W, 3) f32,
    row 0 = bottom."""
    co = coords(width, height, aspect)
    cam = get_camera(uniforms, co)
    uv = cam["gluv"]

    angle = gl_atan2(uv[..., 1], uv[..., 0])
    tau_phase = F(np.asarray(uniforms["iTau"], F))
    color = F(0.3) + hsv2rgb(angle + (2 * TAU * tau_phase) - (PI / 4), 1.0, 1.0)

    circle = (F(1.333) * np.sqrt((uv * uv).sum(-1)).astype(F) - F(1)).astype(F)
    width_f = (2 * np.abs(1 / (circle * circle)) * F(1e-4)).astype(F)

    grid_on = np.mod(np.floor(uv[..., 0] * 4) + np.floor(uv[..., 1] * 4), 2.0) > 0.5
    grid = np.where(grid_on, F(0.22), F(0.20))
    base = np.where(circle < 0, F(0.18), grid)

    rgb = base[..., None] + width_f[..., None] * color

    away = (co["astuv"] * (1 - co["astuv"][..., ::-1])).astype(F)
    linear = (50 * away[..., 0] * away[..., 1]).astype(F)
    vig = np.clip(np.power(linear, F(0.1), dtype=F), 0, 1)
    rgb = rgb * vig[..., None]

    rgb = np.where(cam["out_of_bounds"][..., None], F(0.15), rgb)
    return rgb.astype(F)


def mandelbrot_fragment(uniforms: dict, width: int, height: int, aspect: float):
    """examples/fractals/shaders/mandelbrot.frag -> (H, W, 3) f32."""
    co = coords(width, height, aspect)
    cam = get_camera(uniforms, co)
    z = cam["gluv"] - np.array([0.5, 0.0], F)
    c = z.copy()

    quality = int(1000.0 * float(np.asarray(uniforms["iQuality"], F)))
    zx, zy = z[..., 0].copy(), z[..., 1].copy()
    cx, cy = c[..., 0], c[..., 1]
    iters = np.zeros(zx.shape, np.int32)
    active = np.ones(zx.shape, bool)
    for _ in range(quality):
        # length(z) > 3 checked BEFORE the step; escaped pixels freeze
        radius = np.sqrt(zx * zx + zy * zy).astype(F)
        active &= ~(radius > 3.0)
        if not active.any():
            break
        nzx = (zx * zx - zy * zy + cx).astype(F)
        nzy = (zx * zy * 2 + cy).astype(F)
        zx = np.where(active, nzx, zx)
        zy = np.where(active, nzy, zy)
        iters += active
    t = np.power((1 - iters.astype(F) / F(quality)).astype(F), F(20), dtype=F)
    rgb = palette_magma(t)
    rgb = np.where(cam["out_of_bounds"][..., None], palette_magma(np.zeros(t.shape, F)), rgb)
    return rgb.astype(F)


def _nearest_v(tex: np.ndarray, v: np.ndarray):
    """GL_NEAREST along the v axis of a 1-texel-wide (H, C) column texture
    sampled at u=0: texel row floor(v*H), clamped (row 0 = bottom)."""
    h = tex.shape[0]
    iy = np.clip(np.floor(v * h).astype(np.int32), 0, h - 1)
    return tex[iy]


def bars_fragment(uniforms: dict, width: int, height: int,
                  aspect: float, textures: dict):
    """examples/basic/shaders/bars.frag -> (H, W, 3) f32. The swizzled
    sample texture(iSpectrogram, astuv.yx) puts the BIN axis along screen
    x (the spectrogram is 1 texel wide at length=0); NEAREST (smooth=False).
    Channels add on black; blue ambient term scales with total intensity.

    textures: spectrogram (bins, 2) f32 row-0-bottom."""
    co = coords(width, height, aspect)
    get_camera(uniforms, co)  # GetCamera runs (unused) in the reference
    ax = co["astuv"][..., 0].astype(F)
    ay = co["astuv"][..., 1].astype(F)
    intensity = (np.sqrt(_nearest_v(textures["spectrogram"], ax)) / F(120)).astype(F)

    rgb = np.zeros(ax.shape + (3,), F)
    rgb[..., 0] += (ay < intensity[..., 0])
    rgb[..., 1] += (ay < intensity[..., 1])
    rgb[..., 2] += (ay < (intensity[..., 0] + intensity[..., 1]) / 2)
    rgb[..., 2] += (F(0.4) * (intensity[..., 0] + intensity[..., 1])
                    * (1 - ay)).astype(F)
    return rgb.astype(F)


def waveform_fragment(uniforms: dict, width: int, height: int,
                      aspect: float, textures: dict):
    """examples/basic/shaders/waveform.frag -> (H, W, 3) f32. Oscilloscope
    bars: wave = texture(iWaveform, vec2(astuv.x, 0)).rg, base 0.2, channel
    set to 1 where |gluv.y| < wave (LINEAR along the points axis — the
    waveform module's smooth=True default).

    textures: waveform (points, 2) f32."""
    co = coords(width, height, aspect)
    get_camera(uniforms, co)
    waveform = textures["waveform"]
    wp = waveform.shape[0]
    x = (co["astuv"][..., 0] * wp - F(0.5)).astype(F)
    x0 = np.clip(np.floor(x).astype(np.int32), 0, wp - 1)
    x1 = np.clip(x0 + 1, 0, wp - 1)
    fx = np.clip(x - x0, 0, 1).astype(F)
    wave = (waveform[x0] * (1 - fx[..., None]) + waveform[x1] * fx[..., None]).astype(F)

    ay = np.abs(co["gluv"][..., 1]).astype(F)
    rgb = np.full(ay.shape + (3,), F(0.2), F)
    rgb[..., 0] = np.where(ay < wave[..., 0], F(1.0), rgb[..., 0])
    rgb[..., 1] = np.where(ay < wave[..., 1], F(1.0), rgb[..., 1])
    rgb[..., 2] = np.where(ay < (wave[..., 0] + wave[..., 1]) / 2, F(1.0), rgb[..., 2])
    return rgb.astype(F)


def visualizer_fragment(uniforms: dict, width: int, height: int,
                        aspect: float, textures: dict):
    """examples/basic/shaders/visualizer.frag -> (H, W, 3) f32, transcribed
    POINTWISE (per-pixel bilinear samples, the literal 80-tap blur loop) —
    the independent check on the engine's restructured formulation
    (separable sampling, blur-sample commutation, batched bar lookup).

    textures: background (Hb, Wb, 3) f32 row-0-bottom; spectrogram
    (bins, 2) f32 row-0-bottom (NEAREST, the smooth=False scene config);
    waveform (Wp, 2) f32 (sampled at v=0 along u).
    """
    co = coords(width, height, aspect)
    cam = get_camera(uniforms, co)
    uv = cam["gluv"]
    space = np.array([1.0, 11.0, 26.0], F) / 255

    time = F(np.asarray(uniforms["iTime"], F))
    vol = F(np.asarray(uniforms["iAudioVolume"], F))
    std = F(np.asarray(uniforms["iAudioSTD"], F))
    background = textures["background"]
    tex_aspect = F(background.shape[0] / background.shape[1])

    def stexture(st_u, st_v):
        # stexture = gtexture(stuv2gluv(uv)): u scales by tex_h/tex_w
        # around center (shaderflow.glsl:165-169,202)
        g_u = (st_u * 2 - 1) * tex_aspect
        u = (g_u + 1) / 2
        return _sample_bilinear(background, u.astype(F), st_v.astype(F))

    # Background: zoom(gluv2stuv(camera.gluv), z, 0.5) + drift — the stuv
    # here comes from the CAMERA gluv (x spans ±aspect), not astuv
    z = F(0.95) + F(0.01) * np.sin(time, dtype=F) - F(0.02) * vol - F(0.03)
    st_x = ((uv[..., 0] + 1) / 2).astype(F)
    st_y = ((uv[..., 1] + 1) / 2).astype(F)
    bg_u = ((st_x - F(0.5)) * (z * z) + F(0.5)
            + F(0.005) * np.cos(time * F(3.25135), dtype=F)).astype(F)
    bg_v = ((st_y - F(0.5)) * (z * z) + F(0.5)
            + F(0.005) * np.sin(time * F(1.153469), dtype=F)).astype(F)
    rgb = stexture(bg_u, bg_v)[..., :3]

    # 8 x 10 radial blur, literal loop; color STARTS at the base sample
    intensity = F(0.01) * np.clip(np.power(vol, F(2.5), dtype=F), 0, F(0.3))
    quality, directions = 10, 8
    color = rgb.copy()
    for d in range(directions):
        angle = F(TAU) * d / directions
        for s in range(1, quality + 1):
            walk = F(s / quality)
            du = F(np.cos(angle, dtype=F)) * walk * intensity
            dv = F(np.sin(angle, dtype=F)) * walk * intensity
            color = color + stexture(bg_u + du, bg_v + dv)[..., :3]
    rgb = (color / F(quality * directions)).astype(F)

    # Blink on snare/kick
    alen = np.sqrt((co["agluv"] ** 2).sum(-1)).astype(F)
    rgb = rgb * (1 + 5 * std * np.power(
        np.clip(alen - F(0.3), 0, 1), F(6), dtype=F))[..., None]

    # Music bars. rotate2d(a) = mat2(c,-s,s,c) is COLUMN-major: M*v =
    # (c*x + s*y, -s*x + c*y) — the TRANSPOSE of the textbook rotation —
    # so rotate2d(-PI/2)*uv = (-y, x), not (y, -x).
    scale = (1 - F(0.4) * np.sqrt(np.abs(vol), dtype=F)).astype(F)
    mx = (-uv[..., 1] * scale).astype(F)
    my = (uv[..., 0] * scale).astype(F)
    radius = F(0.17)
    circle = np.abs(np.arctan2(my, mx).astype(F) / F(PI))
    spectrogram = textures["spectrogram"]
    freq = np.sqrt(_nearest_v(spectrogram, circle) / F(1000)).astype(F)

    def sstep(edge0, edge1, x):
        t = np.clip((x - edge0) / (edge1 - edge0), 0, 1).astype(F)
        return (t * t * (3 - 2 * t)).astype(F)

    freq = freq * (F(0.05) + 3 * sstep(F(0), F(2), circle))[..., None]
    bar = np.where(my < 0, freq[..., 0], freq[..., 1]).astype(F)
    r_len = np.sqrt(mx * mx + my * my).astype(F)
    ring = radius + F(0.5) * bar
    smix = sstep(F(0), F(1), F(0.5) + bar)
    with np.errstate(all="ignore"):
        fall = np.power((r_len - ring) * F(0.5), F(0.05), dtype=F)
    rgb = np.where((r_len < radius)[..., None], rgb * F(0.5),
                   np.where((r_len < ring)[..., None],
                            rgb + (1 - rgb) * smix[..., None],
                            rgb * fall[..., None])).astype(F)

    # Fade to deep space
    dmix = sstep(F(0), F(1), np.sqrt((uv ** 2).sum(-1)).astype(F) / 20)
    rgb = rgb + (space - rgb) * dmix[..., None]

    # Vignette
    vig = (co["astuv"] * (1 - co["astuv"][..., ::-1])).astype(F)
    vpow = np.power(vig[..., 0] * vig[..., 1] * 20,
                    F(0.1) + F(0.15) * vol, dtype=F)
    rgb = rgb * vpow[..., None]

    # Waveform overlay (linear sample of the (Wp, 2) row at v=0)
    waveform = textures["waveform"]
    wp = waveform.shape[0]
    x = co["astuv"][..., 0] * wp - F(0.5)
    x0 = np.clip(np.floor(x).astype(np.int32), 0, wp - 1)
    x1 = np.clip(x0 + 1, 0, wp - 1)
    fx = np.clip(x - x0, 0, 1).astype(F)
    wave = (F(0.2) * (waveform[x0] * (1 - fx[..., None])
                      + waveform[x1] * fx[..., None])).astype(F)
    gy = co["gluv"][..., 1]
    rgb = np.where((1 - gy < wave[..., 0])[..., None], rgb * F(0.8), rgb)
    rgb = np.where((1 + gy < wave[..., 1])[..., None], rgb * F(0.8), rgb)

    # Out of bounds: the reference early-returns space before everything
    rgb = np.where(cam["out_of_bounds"][..., None], space, rgb)
    return rgb.astype(F)


def tetration_fragment(uniforms: dict, width: int, height: int, aspect: float):
    """examples/fractals/shaders/tetration.frag -> (H, W, 3) f32.

    GLSL-exact semantics worth noting: Z updates BEFORE the break check (the
    escaping Z colors the pixel); `float k = it / MAX_STEPS` is INTEGER
    division — k is 1 only for orbits that never escape, else 0 (binary,
    not a ramp); theta = atan2n ([0, 1) cycles) feeds hsv2rgb's RADIAN hue
    domain, landing every pixel in hue sector 0 (red/yellow). Non-finite
    orbits (NaN compares false in GLSL, reaching k=1 with undefined hue /
    driver-UB u8 store) are treated as escaped (k=0) to match the engine's
    deliberate finite guard."""
    co = coords(width, height, aspect)
    cam = get_camera(uniforms, co)
    g = cam["gluv"]
    cx, cy = g[..., 0].astype(F), g[..., 1].astype(F)
    cr = np.sqrt(cx * cx + cy * cy).astype(F)
    ct = np.arctan2(cy, cx).astype(F)

    MAX_STEPS = 67
    zx, zy = cx.copy(), cy.copy()
    done = np.zeros(zx.shape, bool)
    with np.errstate(all="ignore"):
        log_cr = np.log(cr).astype(F)
        for _ in range(MAX_STEPS):
            nr = (np.power(cr, zx, dtype=F) * np.exp(-zy * ct, dtype=F)).astype(F)
            nt = (zy * log_cr + zx * ct).astype(F)
            nzx = (nr * np.cos(nt)).astype(F)
            nzy = (nr * np.sin(nt)).astype(F)
            zx = np.where(done, zx, nzx)
            zy = np.where(done, zy, nzy)
            done = done | (nr > 100.0) | ~np.isfinite(nr)
            if done.all():
                break
    k = np.where(done, F(0.0), F(1.0))

    # theta = atan2n(Z.y, Z.x): the (0, 2pi) atan2 variant, normalized.
    # Non-finite Z has k=0 (black regardless of hue); zero the angle so the
    # NaN does not poison the hsv switch arithmetic.
    theta = np.arctan2(zy, zx).astype(F)
    theta = np.where(zy < 0, F(TAU) + theta, theta).astype(F) / F(TAU)
    theta = np.where(np.isfinite(theta), theta, F(0.0)).astype(F)
    return hsv2rgb(theta, np.asarray(1.0, F), k).astype(F)


def raymarch_fragment(uniforms: dict, width: int, height: int, aspect: float):
    """examples/basic/shaders/raymarch.frag -> (H, W, 3) f32. Stacked-boxes
    ray march; col = 1 - sqrt(steps)*0.1. GLSL loop semantics: traveled
    accumulates EVERY walk (including the breaking one); `steps` is the
    loop counter AT break — the breaking iteration is not counted (the
    for-increment is skipped by break), and a never-breaking ray exits with
    steps == MAX_STEPS."""
    co = coords(width, height, aspect)
    cam = get_camera(uniforms, co)
    origin = cam["origin"]
    target = cam["target"]
    direction = (target - origin).astype(F)
    forward = (direction / np.sqrt((direction * direction).sum(-1, keepdims=True)).astype(F)).astype(F)

    MAX_STEPS, MAX_DIST, MIN_DIST = 100, F(100.0), F(0.001)

    def sd_scene(point):
        sdf = np.full(point.shape[:-1], 2 * MAX_DIST, F)
        for i in range(2, 8):
            d = (np.abs(point - np.array([0, 0, i], F)) - F(i - 1) / 2).astype(F)
            inner = np.minimum(d.max(-1), 0.0).astype(F)
            outer = np.sqrt((np.maximum(d, 0.0) ** 2).sum(-1)).astype(F)
            sdf = np.minimum(sdf, inner + outer).astype(F)
        return sdf

    traveled = np.zeros(origin.shape[:-1], F)
    steps = np.zeros(origin.shape[:-1], np.int32)
    done = np.zeros(origin.shape[:-1], bool)
    for _ in range(MAX_STEPS):
        point = (origin + forward * traveled[..., None]).astype(F)
        walk = sd_scene(point)
        traveled = np.where(done, traveled, (traveled + walk).astype(F))
        breaking = (walk < MIN_DIST) | (walk > MAX_DIST)
        steps = np.where(done | breaking, steps, steps + 1)
        done = done | breaking
        if done.all():
            break

    col = (1 - np.sqrt(steps.astype(F)) * F(0.1)).astype(F)
    return np.repeat(col[..., None], 3, axis=-1).astype(F)


# --------------------------------------------------------------------------- #
# Final pass (fragment/final.glsl): subsample^2 bilinear taps, u8 store

def _sample_bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray,
                     repeat: bool = False):
    """GL_LINEAR sample of (H, W, C) row-0-bottom storage at texcoords
    (u right, v up). CLAMP_TO_EDGE by default; repeat=True wraps both axes
    (GL_REPEAT — the texture default of image-backed ShaderTextures)."""
    h, w = tex.shape[0], tex.shape[1]
    if repeat:
        u = np.mod(u.astype(F), 1.0)
        v = np.mod(v.astype(F), 1.0)
    x = (u.astype(F) * w - F(0.5))
    y = (v.astype(F) * h - F(0.5))
    x0 = np.floor(x); y0 = np.floor(y)
    fx = (x - x0)[..., None].astype(F)
    fy = (y - y0)[..., None].astype(F)
    if repeat:
        x0i = np.mod(x0.astype(np.int64), w)
        x1i = np.mod(x0.astype(np.int64) + 1, w)
        y0i = np.mod(y0.astype(np.int64), h)
        y1i = np.mod(y0.astype(np.int64) + 1, h)
    else:
        x0i = np.clip(x0.astype(np.int64), 0, w - 1)
        x1i = np.clip(x0.astype(np.int64) + 1, 0, w - 1)
        y0i = np.clip(y0.astype(np.int64), 0, h - 1)
        y1i = np.clip(y0.astype(np.int64) + 1, 0, h - 1)
    c00 = tex[y0i, x0i]; c01 = tex[y0i, x1i]
    c10 = tex[y1i, x0i]; c11 = tex[y1i, x1i]
    top = c00 + (c01 - c00) * fx
    bottom = c10 + (c11 - c10) * fx
    return (top + (bottom - top) * fy).astype(F)


def final_pass(render: np.ndarray, out_width: int, out_height: int,
               subsample: int) -> np.ndarray:
    """final.glsl + u8 conversion; input and output row 0 = bottom."""
    x = (np.arange(out_width, dtype=F) + F(0.5)) / F(out_width)
    y = (np.arange(out_height, dtype=F) + F(0.5)) / F(out_height)
    astuv = np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1).astype(F)

    if subsample == 1:
        rgb = _sample_bilinear(render, astuv[..., 0], astuv[..., 1])[..., :3]
    else:
        pixel = (F(1) / np.array([out_width, out_height], F))
        corner = astuv - pixel / 2
        origin = corner + (pixel / subsample) / 2
        acc = np.zeros((out_height, out_width, 3), F)
        for sx in range(subsample):
            for sy in range(subsample):
                offset = (pixel / subsample) * np.array([sx, sy], F)
                uv = origin + offset
                acc += _sample_bilinear(render, uv[..., 0], uv[..., 1])[..., :3]
        rgb = acc / F(subsample * subsample)
    return np.floor(np.clip(rgb, 0, 1) * 255 + F(0.5)).astype(np.uint8)


def render_scene(fragment, uniforms: dict, render_width: int, render_height: int,
                 out_width: int, out_height: int, subsample: int,
                 aspect: float) -> np.ndarray:
    """Full frame: fragment at render res -> final pass -> flip to the
    engine's row-0-top orientation. Returns (out_h, out_w, 3) uint8."""
    rgb = fragment(uniforms, render_width, render_height, aspect)
    frame = final_pass(rgb, out_width, out_height, subsample)
    return frame[::-1]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64) / 255.0
    b = np.asarray(b, np.float64) / 255.0
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(1.0 / mse))
