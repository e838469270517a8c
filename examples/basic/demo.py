"""
Example scenes — the API surface tour.

Python pixel-program equivalents of the reference's example set
(/root/reference/examples/basic/demo.py + its GLSL shaders): Basic,
ShaderToy, MultiShader, Multipass, MotionBlur, Dynamics, Video, Audio,
Waveform, MusicBars, Visualizer (the flagship music visualizer), RayMarch,
and Conway's Life. Assets are procedurally generated (examples/assets.py).

Shaders are plain functions over the Frag context with the ops vocabulary —
compare each to the same-named .frag in the reference to see the 1:1 math.
"""

import math
import sys
from pathlib import Path

import numpy as np

import jax.numpy as jnp
from jax import lax

sys.path.insert(0, str(Path(__file__).parent.parent))
import assets

from shaderflow_tpu import ops
from shaderflow_tpu.dynamics import ShaderDynamics
from shaderflow_tpu.message import ShaderMessage
from shaderflow_tpu.ops import (
    PI, TAU, clamp, gluv2stuv, hsv2rgb, length, mix, rotate2d, smoothstep,
    stuv2gluv, vec2, vec3, vec4, zoom,
)
from shaderflow_tpu.scene import ShaderScene
from shaderflow_tpu.shader import ShaderProgram
from shaderflow_tpu.texture import ShaderTexture
from shaderflow_tpu.variable import Uniform

# ---------------------------------------------------------------------------- #

class Basic(ShaderScene):
    """Simplest ShaderScene (default neon-ring shader)"""


# ---------------------------------------------------------------------------- #

def shadertoy_frag(sf):
    """The ShaderToy default: cosine rainbow (shadertoy.frag)."""
    uv = sf.stuv
    phase = sf.iTime + jnp.stack([uv[..., 0], uv[..., 1], uv[..., 0]], axis=-1)
    col = 0.5 + 0.5 * jnp.cos(phase + jnp.array([0.0, 2.0, 4.0]))
    return vec4(col, 1.0)


class ShaderToy(ShaderScene):
    """ShaderToy Default Shader"""

    def build(self):
        self.shader.fragment = shadertoy_frag


# ---------------------------------------------------------------------------- #

class MultiShader(ShaderScene):
    """Basic scene with two shaders acting together"""

    def build(self):
        self.child = ShaderProgram(scene=self, name="child")
        # Left screen green fading out; composited over a red ramp
        self.child.fragment = lambda sf: vec4(0.0, 1.0 - sf.stuv[..., 0], 0.0, 1.0)

        def main_frag(sf):
            color = vec4(sf.stuv[..., 0], 0.0, 0.0, 1.0)
            color = color + ops.with_alpha(sf.texture("child", sf.astuv), 0.0)
            return ops.with_alpha(color, 1.0)
        self.shader.fragment = main_frag


# ---------------------------------------------------------------------------- #

def _blur(sf, tex, radius, directions, steps):
    """Walk in circles around the pixel and integrate weighted samples
    (multipass.frag blur()) — the constant tap pattern collapses into one
    texture-space kernel + convolution (the sample coordinate is astuv
    itself, so no resample is even needed)."""
    from shaderflow_tpu.ops.sampling import convolve2d, splat_kernel
    taps, weights = [], []
    for d in range(directions):
        direction = TAU * d / directions
        for s in range(1, steps):
            walk = s / steps
            offset_uv = (radius * walk / 2000.0)
            taps.append((math.cos(direction) * offset_uv * tex.width,
                         -math.sin(direction) * offset_uv * tex.height))
            weights.append(1.0 - offset_uv / radius)
    kernel = splat_kernel(jnp.asarray(taps, jnp.float32), size=13,
                          weights=jnp.asarray(weights, jnp.float32))
    return convolve2d(tex.data, kernel) / sum(weights)


class Multipass(ShaderScene):
    """Multi layers done on a single shader"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_numpy(assets.background_array())
        self.shader.texture.layers = 2

        def frag(sf):
            if sf.iLayer == 0:
                return sf.stexture("background", sf.stuv)
            color = sf.texture(sf.tex("iScreen", 0, 0), sf.astuv)
            inverted = ops.with_rgb(color, jnp.stack(
                [1.0 - color[..., 0], color[..., 1], color[..., 2]], axis=-1))
            blurred = _blur(sf, sf.tex("iScreen", 0, 0), 5.0, 8, 8)
            out = jnp.where(sf.gluv[..., 0:1] < 0, inverted, blurred)
            return ops.with_alpha(out, 1.0)
        self.shader.fragment = frag


# ---------------------------------------------------------------------------- #

class MotionBlur(ShaderScene):
    """Poor man's Motion Blur (temporal texture ring average)"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_numpy(assets.background_array())
        self.shader.texture.temporal = 10
        self.shader.texture.layers = 2

        def frag(sf):
            cam = sf.camera
            uv = cam.stuv
            if sf.iLayer == 0:
                return sf.stexture("background", uv)
            temporal = 10
            color = jnp.zeros(uv.shape[:-1] + (4,), jnp.float32)
            for i in range(temporal):
                # smoothstep on python constants, kept out of the trace
                t = 1.0 - i / temporal
                factor = t * t * (3.0 - 2.0 * t)
                color = color + sf.texture(sf.tex("iScreen", i, 0), sf.astuv) * factor
            return ops.with_alpha(2.0 * color / temporal, 1.0)
        self.shader.fragment = frag


# ---------------------------------------------------------------------------- #

class Dynamics(ShaderScene):
    """Second order system springing a zoom on a square wave"""

    def build(self):
        ShaderTexture(scene=self, name="background").from_numpy(assets.background_array())
        self.dynamics = ShaderDynamics(scene=self, name="iShaderDynamics", frequency=4)
        self.shader.fragment = lambda sf: sf.stexture(
            "background", zoom(sf.stuv, 0.85 + 0.1 * sf.iShaderDynamics, vec2(0.5, 0.5)))

    def update(self):
        # This is how square waves are born in the digital world
        self.dynamics.target = 0.5 * (1 + np.sign(np.sin(2 * math.pi * self.time * 0.5)))


# ---------------------------------------------------------------------------- #

class Video(ShaderScene):
    """Video as a texture demo (generated test video when none provided)"""
    path = None

    def build(self):
        from shaderflow_tpu.video import ShaderVideo
        self.video = ShaderVideo(scene=self, path=self.path or assets.video_file())

        def frag(sf):
            cam = sf.camera
            return ops.with_alpha(sf.stexture("iVideo", cam.stuv), 1.0)
        self.shader.fragment = frag


# ---------------------------------------------------------------------------- #

class Audio(ShaderScene):
    """Basic audio processing (microphone volume as brightness)"""

    def build(self):
        from shaderflow_tpu.audio import ShaderAudio
        self.audio = ShaderAudio(scene=self, name="iAudio")
        self.audio.open_recorder()
        self.shader.fragment = lambda sf: vec4(vec3(
            jnp.broadcast_to(sf.iAudioVolume, sf.astuv.shape[:-1])), 1.0)


# ---------------------------------------------------------------------------- #

def waveform_frag(sf):
    """Oscilloscope bars (waveform.frag)."""
    from shaderflow_tpu.ops.sampling import sample_separable
    row = sample_separable(sf.tex("iWaveform"), sf.astuv[0, :, 0], jnp.zeros(1))
    wave = row[0][None, :, 0:2]  # broadcast the single sampled row
    ay = jnp.abs(sf.gluv[..., 1])
    r = jnp.where(ay < wave[..., 0], 1.0, 0.2)
    g = jnp.where(ay < wave[..., 1], 1.0, 0.2)
    b = jnp.where(ay < (wave[..., 0] + wave[..., 1]) / 2, 1.0, 0.2)
    return vec4(r, g, b, 1.0)


class Waveform(ShaderScene):
    """Audio Waveform Oscilloscope demo"""
    audio_file = None

    def build(self):
        from shaderflow_tpu.audio import ShaderAudio
        from shaderflow_tpu.audio.waveform import ShaderWaveform
        self.audio = ShaderAudio(scene=self, name="iAudio",
                                 file=self.audio_file or assets.music_wav())
        self.waveform = ShaderWaveform(scene=self, audio=self.audio, smooth=False)
        self.shader.fragment = waveform_frag


# ---------------------------------------------------------------------------- #

def bars_frag(sf):
    """Two-channel frequency bars (bars.frag). The swizzled sample at
    astuv.yx hits a single-column texture (length=0), so the whole lookup
    is a 1D line over x — no per-pixel sampling, no transposes."""
    from shaderflow_tpu.ops.sampling import sample_separable
    cam = sf.camera
    line = sample_separable(sf.tex("iSpectrogram"),
                            jnp.full((1,), 0.5), sf.astuv[0, :, 0])  # (W', 1, C)
    intensity = jnp.sqrt(line[:, 0, 0:2])[None, :, :] / 120.0        # (1, W', 2)
    ax, ay = sf.astuv[..., 0], sf.astuv[..., 1]
    rgb = jnp.zeros(ax.shape + (3,), jnp.float32)
    rgb = rgb.at[..., 0].add(jnp.where(ay < intensity[..., 0], 1.0, 0.0))
    rgb = rgb.at[..., 1].add(jnp.where(ay < intensity[..., 1], 1.0, 0.0))
    rgb = rgb.at[..., 2].add(
        jnp.where(ay < (intensity[..., 0] + intensity[..., 1]) / 2, 1.0, 0.0))
    rgb = rgb.at[..., 2].add(0.4 * (intensity[..., 0] + intensity[..., 1]) * (1.0 - ay))
    return vec4(rgb, 1.0)


class MusicBars(ShaderScene):
    """Basic music bars"""
    audio_file = None

    def build(self):
        from shaderflow_tpu.audio import ShaderAudio
        from shaderflow_tpu.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu.piano import PianoNote
        self.audio = ShaderAudio(scene=self, name="iAudio",
                                 file=self.audio_file or assets.music_wav())
        self.spectrogram = ShaderSpectrogram(scene=self, audio=self.audio, length=0)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(18000.0),
            piano=True,
        )
        self.shader.fragment = bars_frag


# ---------------------------------------------------------------------------- #

def _visualizer_bar_prelude(ctx):
    """Whole-batch radial-bar field: the bar's per-pixel index map (angle ->
    spectrogram bin, half-plane -> channel) is frame-invariant, so the full
    batch is ONE gather of the per-frame tables over the static field
    (ops.sampling.lookup_nearest_1d_select_batched) instead of a per-frame
    lookup inside the render scan.

    Computes the angle field from screen gluv lines — exact for this scene's
    static default 2D camera (the per-frame fallback in visualizer_frag uses
    the camera-projected lines and remains the semantic reference)."""
    tables = ctx.rows("iSpectrogram")            # (B, bins, 1, C)
    if tables is None:
        return None
    from shaderflow_tpu.ops import tailfuse
    from shaderflow_tpu.ops.sampling import lookup_nearest_1d_select_batched
    height, width = ctx.render_size
    gx = ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
          ) * ctx.aspect
    gy = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    # music_uv = rotate2d(-pi/2)*gluv = (-y, x): GLSL's mat2 is column-major
    # so rotate2d applies the TRANSPOSE of the textbook rotation
    # (visualizer.frag:39, shaderflow.glsl:75-77)
    circle = jnp.abs(tailfuse.atan2(gx[None, :], -gy[:, None]) / PI)
    return lookup_nearest_1d_select_batched(
        tables[:, :, 0, :], circle, channel_where=(gx[None, :] < 0),
        out_dtype=jnp.bfloat16)


def _visualizer_static_prelude(ctx):
    """Batch-INVARIANT per-pixel fields the tail would otherwise recompute
    per frame per pixel inside the render scan:

      * fscale: the bar-length falloff 0.05 + 3*sstep01(circle/2) — its
        atan2 is ~15 ops/pixel/frame;
      * rad0:   |camera-plane uv| (the per-frame radius is rad0 * scale);
      * blink:  the snare-blink radial power ((clip(|agluv|-0.3))^2)^3.

    Returned with leading axis 1 -> engine static-prelude path (computed
    once per batch, read by every frame). Exact for the scene's static
    default 2D camera, same as _visualizer_bar_prelude; the per-frame
    formulation in the tail remains the fallback and the semantic reference.

    Deactivates (None) outside offline mode — signaled, like the bar
    prelude, by the spectrogram sequence's absence: in an interactive
    preview the user can pan/zoom the camera, and these screen-space fields
    must NOT freeze the camera-dependent geometry."""
    if ctx.sequence("iSpectrogram") is None:
        return None
    from shaderflow_tpu.ops import tailfuse
    height, width = ctx.render_size
    gx = ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
          ) * ctx.aspect
    gy = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    circle = jnp.abs(tailfuse.atan2(gx[None, :], -gy[:, None]) / PI)
    t = jnp.clip(circle / 2.0, 0.0, 1.0)
    fscale = 0.05 + 3.0 * (t * t * (3.0 - 2.0 * t))
    rad0 = jnp.sqrt(gx[None, :] ** 2 + gy[:, None] ** 2)
    ax = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ay = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    alen = jnp.sqrt(ax[None, :] ** 2 + ay[:, None] ** 2)
    t6 = jnp.clip(alen - 0.3, 0.0, 1.0) ** 2
    blink = t6 * t6 * t6
    # Vignette: vpow = pow(vig*20, p) with a per-frame exponent p ->
    # hoist log(max(vig*20, eps)); the tail keeps only exp(p * lvig)
    sx = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    sy = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    vig = (sx * (1.0 - sx))[None, :] * (sy * (1.0 - sy))[:, None]
    lvig = jnp.log(jnp.maximum(vig * 20.0, 1e-6))
    # fscale and rad0 gate HARD edges (bar ring thresholds): bf16's ~0.4%
    # quantization flips boundary pixels (measured ~5 dB PSNR); keep them
    # f32, like lvig (it feeds an exp whose argument spans ~[-14, 1.2]).
    # blink is a smooth multiplier — bf16 is invisible there.
    return {"iVizFscale": fscale[None],
            "iVizRad": rad0[None],
            "iVizLvig": lvig[None],
            "iVizBlink": blink.astype(jnp.bfloat16)[None]}


def _static_prelude_field(key):
    """One batch_preludes entry per field; the shared math CSEs inside the
    single jitted program."""
    def fn(ctx):
        fields = _visualizer_static_prelude(ctx)
        return None if fields is None else fields[key]
    return fn


def visualizer_frag(sf):
    """Radial bars music visualizer — the flagship scene (visualizer.frag).

    Restructuring of the reference GLSL's hot path: the background's uv
    map is an axis-aligned scale+translate (default 2D camera), so the
    per-pixel bilinear sample becomes two 1D interpolations
    (ops.sampling.sample_separable) instead of 2D gathers; the 80-tap radial
    blur — identical tap offsets at every pixel — collapses into one small
    convolution of the TEXTURE (bilinear sampling is linear, so blur and
    sample commute) followed by a single separable sample. Same math, ~80x
    fewer texture reads.
    """
    from shaderflow_tpu.ops.sampling import (
        Sampler2D, convolve2d, sample_separable, sample_separable_planes,
        sample_rows_planes_blocked, splat_kernel)

    cam = sf.camera
    uv = cam.gluv
    space = jnp.array([1.0, 11.0, 26.0]) / 255.0

    # Axis lines of the camera-projected uv (exact: static 2D camera)
    gx = uv[0, :, 0]
    gy = uv[:, 0, 1]
    z = 0.95 + 0.01 * jnp.sin(sf.iTime) - 0.02 * sf.iAudioVolume - 0.03
    qx = ((gx + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * jnp.cos(sf.iTime * 3.25135)
    qy = ((gy + 1.0) / 2.0 - 0.5) * z * z + 0.5 + 0.005 * jnp.sin(sf.iTime * 1.153469)

    # stexture = gtexture(stuv2gluv(q)): u scales by tex_h/tex_w around center
    tex = sf.tex("background")
    aspect_scale = tex.height / tex.width
    u_line = ((2.0 * qx - 1.0) * aspect_scale + 1.0) / 2.0
    v_line = qy
    # Texels-per-pixel bound for the blocked sampler: both axes work out to
    # z^2 * tex_h / render_h for this scene's axis-aligned map; z <= 0.934
    # always (z = 0.92 + 0.01 sin - 0.02 vol, vol >= small undershoot),
    # bound with z <= 0.96 for window margin. Positions stay well inside
    # [0, n-1] (no REPEAT seam), the blocked contract. Rows interpolate
    # here (banded matmuls); the column stage runs in the tail stage
    # (tailfuse.ColSampled), next to the math that reads it.
    render_h = uv.shape[0]
    base_tpp = 0.96 ** 2 * tex.height / render_h
    base_rows = sample_rows_planes_blocked(
        tex, v_line, texels_per_px=base_tpp,
        precision="bfloat16", out_dtype=jnp.bfloat16)[:3]

    # Radial blur (8 directions x 10 walks) as one texture-space kernel,
    # computed on a half-resolution pyramid level (the taps feed a blur —
    # the 2x level halves the kernel and quarters the traffic for an error
    # far below the blur's own radius)
    intensity = 0.01 * clamp(jnp.power(jnp.maximum(sf.iAudioVolume, 0.0), 2.5), 0.0, 0.3)
    quality, directions = 10, 8
    taps = []
    for d in range(directions):
        angle = TAU * d / directions
        for s in range(1, quality + 1):
            walk = s / quality
            taps.append((math.cos(angle) * walk, math.sin(angle) * walk))
    taps = jnp.asarray(taps, jnp.float32) * intensity          # (80, 2) in stuv units
    from shaderflow_tpu.ops.downsample import box_downsample
    # Pyramid level for the blur source. Level 4 costs ~1/16th of full-res
    # convolution; the box prefilter + bilinear reconstruction of the
    # downsampled level deviates from the literal 80 full-res taps by
    # ~45 dB PSNR at the graded config (oracle-measured; level 1 is
    # GLSL-exact at 56.5 dB, maxdiff 2 u8 — test_psnr_reference.py).
    # SHADERFLOW_VIZ_BLUR_LEVEL=1 trades device time for exactness.
    import os
    level = int(os.environ.get("SHADERFLOW_VIZ_BLUR_LEVEL", "4"))
    quarter_h, quarter_w = tex.height // level, tex.width // level
    quarter = (box_downsample(tex.data[:quarter_h * level,
                                       :quarter_w * level], level)
               if level > 1 else tex.data)
    # stuv offsets -> quarter-res texel units: both axes scale by the level
    # height (gtexture aspect correction), v-up flips to row-down
    offsets = taps * jnp.asarray([quarter_h, -quarter_h], jnp.float32)
    # Kernel must cover the max tap offset: intensity <= 0.003 stuv ->
    # ~3.5 texels at full res (level 1 needs size 9), <= 1 level-texel at
    # level >= 4 (size 5 leaves margin)
    kernel = splat_kernel(offsets, size=(5 if level >= 2 else 9))
    blurred = convolve2d(quarter, kernel)
    blur_tex = Sampler2D(blurred, linear=True, repeat_x=tex.repeat_x, repeat_y=tex.repeat_y)
    blur_tpp = 0.96 ** 2 * blur_tex.height / render_h
    blur_rows = sample_rows_planes_blocked(
        blur_tex, v_line, texels_per_px=blur_tpp,
        precision="bfloat16", out_dtype=jnp.bfloat16)[:3]
    color_inv = 1.0 / (quality * directions)

    # Music bar geometry the lookup needs at full field (the rest of the
    # bar math re-derives in the tail below).
    # music_uv = rotate2d(uv, -pi/2)*scale = (uv_y, -uv_x)*scale with
    # scale > 0, and atan2(k*a, k*b) == atan2(a, b): the radial angle and
    # the half-plane channel select need neither the scale nor a
    # materialized (H, W, 2) music_uv — two broadcast LINES feed the whole
    # lookup (the tail re-derives r/my from the same lines).
    uv_x_line = uv[0, :, 0]
    uv_y_line = uv[:, 0, 1]
    from shaderflow_tpu.ops import tailfuse
    bar_stack = sf.prelude_indexed("iBarField")
    if bar_stack is not None:
        # The tail reads this frame's bar plane from the batch stack
        # (tailfuse.Indexed)
        bar_raw = tailfuse.Indexed(bar_stack[0], bar_stack[1])
    else:
        bar_raw = sf.prelude("iBarField")

    # Batch-invariant per-pixel fields (_visualizer_static_prelude): read a
    # precomputed plane instead of recomputing atan2/sqrt/smoothstep chains
    # per frame per pixel. Inactive (None) in realtime mode — the tail's own
    # formulation below remains the reference.
    def _indexed(name):
        stack = sf.prelude_indexed(name)
        return tailfuse.Indexed(stack[0], stack[1]) if stack is not None else None

    fscale_in = _indexed("iVizFscale")
    rad_in = _indexed("iVizRad")
    blink_in = _indexed("iVizBlink")
    lvig_in = _indexed("iVizLvig")
    has_static = None not in (fscale_in, rad_in, blink_in, lvig_in)
    if bar_raw is None:
        # Per-frame fallback (realtime/streamed spectrogram): nearest bin
        # lookup indexed by the radial angle, channel chosen by the bar's
        # half-plane
        from shaderflow_tpu.ops.sampling import lookup_nearest_1d_select
        circle = jnp.abs(
            tailfuse.atan2(uv_x_line[None, :], -uv_y_line[:, None]) / PI)
        bar_raw = lookup_nearest_1d_select(
            sf.tex("iSpectrogram"), circle,
            channel_where=(uv_x_line[None, :] < 0),
            out_dtype=jnp.bfloat16)

    # Waveform on top and bottom: sampled at v=0 along x only — one
    # separable row instead of per-pixel gathers
    wave_tex = sf.tex("iWaveform")
    wave_row = sample_separable(wave_tex, sf.astuv[0, :, 0], jnp.zeros(1))  # (1, W', C)
    wave = 0.2 * wave_row[0]                                               # (W', C)

    # The trivial 2D camera's plane projection is an axis-aligned affine map:
    # its uv and out-of-bounds collapse to 1D lines the tail broadcasts
    cam_x = uv[0, :, 0]
    cam_y = uv[:, 0, 1]
    cam_oob = cam.out_of_bounds[0, :].astype(jnp.float32)

    # Everything after the samples is per-pixel math + the SSAA box filter:
    # the tail stage (ops/tailfuse.py), one kernel with the final pass on
    # the GPU.
    from shaderflow_tpu.ops import tailfuse

    def tail(tp):
        vol = tp.scalar("vol")
        std = tp.scalar("std")
        space_rgb = (1.0 / 255.0, 11.0 / 255.0, 26.0 / 255.0)

        def sstep01(x):  # smoothstep(0, 1, x)
            t = jnp.clip(x, 0.0, 1.0)
            return t * t * (3.0 - 2.0 * t)

        # Base + radial-blur combine happens here rather than as its own
        # full-field pass.
        rgb = [(base + blur) * color_inv
               for base, blur in zip(tp.vec("base"), tp.vec("blur"))]

        # Blink on snare/kick (screen agluv radius). The radial power is a
        # frame-invariant field: precomputed (static prelude) when available
        if has_static:
            blink = tp.f(1.0 + 5.0 * std * tp.plane("blinkp"))
        else:
            alen = jnp.sqrt(tp.agluv_x * tp.agluv_x + tp.agluv_y * tp.agluv_y)
            t6 = jnp.clip(alen - 0.3, 0.0, 1.0)
            t6 = t6 * t6
            blink = tp.f(1.0 + 5.0 * std * (t6 * t6 * t6))
        rgb = [c * blink for c in rgb]

        # Music bars: music_uv = rotate2d(-pi/2) * cam.gluv * scale
        # = (-y, x) * scale — GLSL's column-major mat2 applies the
        # TRANSPOSE of the textbook rotation (shaderflow.glsl:75-77).
        # atan2(k a, k b) == atan2(a, b) and |m| == scale * |uv|, so the
        # angle falloff and the unit radius are frame-invariant fields
        # (static preludes); only the scale multiply is per-frame.
        scale = 1.0 - 0.4 * jnp.sqrt(jnp.abs(vol))
        radius = 0.17
        if has_static:
            # GEOMETRY planes: f32 — they gate the bar ring's hard edges
            # (the reason the prelude stores them f32 in the first place)
            fscale = tp.plane("fscale", dtype=jnp.float32)
            rad0 = tp.plane("rad0", dtype=jnp.float32)
            r = rad0 * scale
        else:
            ux, uy = tp.col("camx"), tp.row("camy")
            mx, my = -uy * scale, ux * scale
            circle = jnp.abs(tailfuse.atan2(my, mx) / PI)
            fscale = 0.05 + 3.0 * sstep01(circle / 2.0)
            rad0 = jnp.sqrt(ux * ux + uy * uy)
            r = jnp.sqrt(mx * mx + my * my)

        # GEOMETRY: bar feeds the ring threshold (hard edge) — f32
        bar = jnp.sqrt(tp.plane("bar", dtype=jnp.float32) / 1000.0) * fscale
        ring = radius + 0.5 * bar
        inside = r < radius
        on_bar = r < ring
        smix = tp.f(sstep01(0.5 + bar))
        fall = tp.f(tailfuse.powf(jnp.maximum((r - ring) * 0.5, 1e-6), 0.05))
        rgb = [jnp.where(inside, c * 0.5,
                         jnp.where(on_bar, c + (1.0 - c) * smix, c * fall))
               for c in rgb]

        # Fade to deep space with camera-plane distance (|uv| == rad0)
        dmix = tp.f(sstep01(rad0 / 20.0))
        rgb = [c + (s - c) * dmix for c, s in zip(rgb, space_rgb)]

        # Vignette (screen astuv): the log of the field is frame-invariant
        # (static prelude); only exp(p * lvig) is per-frame
        if has_static:
            vpow = tp.f(jnp.exp((0.1 + 0.15 * vol)
                                * tp.plane("lvig", dtype=jnp.float32)))
        else:
            sx, sy = tp.astuv_x, tp.astuv_y
            vig = sx * (1.0 - sy) * sy * (1.0 - sx)
            vpow = tp.f(tailfuse.powf(jnp.maximum(vig * 20.0, 1e-6),
                                      0.1 + 0.15 * vol))
        rgb = [c * vpow for c in rgb]

        # Waveform overlay top and bottom (screen gluv y)
        gy = tp.gluv_y
        dark = tp.f(jnp.where(1.0 - gy < tp.col("wave0"), 0.8, 1.0)
                    * jnp.where(1.0 + gy < tp.col("wave1"), 0.8, 1.0))
        rgb = [c * dark for c in rgb]

        # Out of bounds -> deep space color. LAST: the reference's early
        # return (visualizer.frag:11-14) means no waveform darkening or any
        # other stage ever touches an out-of-bounds pixel.
        oob = tp.col("oob") > 0.5
        return [jnp.where(oob, s, c) for c, s in zip(rgb, space_rgb)]

    inputs = dict(
        base=tailfuse.ColSampled(base_rows, u_line, texels_per_px=base_tpp),
        blur=tailfuse.ColSampled(blur_rows, u_line, texels_per_px=blur_tpp),
        bar=bar_raw,
        oob=tailfuse.Col(cam_oob),
        wave0=tailfuse.Col(wave[:, 0]), wave1=tailfuse.Col(wave[:, 1]),
        vol=sf.iAudioVolume, std=sf.iAudioSTD)
    if has_static:
        inputs.update(fscale=fscale_in, rad0=rad_in, blinkp=blink_in,
                      lvig=lvig_in)
    else:
        inputs.update(camx=tailfuse.Col(cam_x), camy=tailfuse.Row(cam_y))
    return sf.tail(tail, **inputs)


class Visualizer(ShaderScene):
    """Radial Bars Music Visualizer Scene"""
    audio_file = None

    def build(self):
        from shaderflow_tpu.audio import ShaderAudio
        from shaderflow_tpu.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu.audio.waveform import ShaderWaveform
        from shaderflow_tpu.piano import PianoNote
        self.audio = ShaderAudio(scene=self, name="iAudio",
                                 file=self.audio_file or assets.music_wav())
        self.waveform = ShaderWaveform(scene=self, audio=self.audio)
        self.spectrogram = ShaderSpectrogram(scene=self, length=0, audio=self.audio,
                                             smooth=False)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(14000.0),
            piano=True,
        )
        self.back = ShaderTexture(scene=self, name="background").from_numpy(
            assets.background_array())
        self.shader.fragment = visualizer_frag
        self.batch_preludes["iBarField"] = _visualizer_bar_prelude
        for key in ("iVizFscale", "iVizRad", "iVizBlink", "iVizLvig"):
            self.batch_preludes[key] = _static_prelude_field(key)

    def handle(self, message):
        ShaderScene.handle(self, message)
        if isinstance(message, ShaderMessage.Window.FileDrop):
            self.back.from_image(message.first)


# ---------------------------------------------------------------------------- #

def raymarch_frag(sf):
    """Stacked boxes ray marcher (raymarch.frag)."""
    MAX_STEPS, MAX_DIST, MIN_DIST = 100, 100.0, 0.001
    cam = sf.camera
    origin = cam.origin
    forward = ops.normalize(cam.target - cam.origin)

    def sd_scene(point):
        sdf = jnp.full(point.shape[:-1], 2 * MAX_DIST, jnp.float32)
        for i in range(2, 8):
            sdf = ops.sd_union(sdf, ops.sd_box(point, vec3(0.0, 0.0, float(i)),
                                               vec3(float(i - 1))))
        return sdf

    def body(_, state):
        traveled, steps, done = state
        point = origin + forward * traveled[..., None]
        walk = sd_scene(point)
        active = ~done
        traveled = traveled + jnp.where(active, walk, 0.0)
        # GLSL break semantics (raymarch.frag): the breaking iteration's
        # walk IS accumulated into traveled, but `steps` is the for-loop
        # counter AT break — break skips the increment, so the breaking
        # iteration does not count (tools/gl_oracle.py raymarch_fragment
        # mirrors this; getting it wrong shifts col by sqrt(n+1)-sqrt(n)).
        breaking = (walk < MIN_DIST) | (walk > MAX_DIST)
        steps = steps + (active & ~breaking).astype(jnp.int32)
        done = done | breaking
        return traveled, steps, done

    traveled = jnp.zeros(origin.shape[:-1], jnp.float32)
    steps = jnp.zeros(origin.shape[:-1], jnp.int32)
    done = jnp.zeros(origin.shape[:-1], bool)
    traveled, steps, done = lax.fori_loop(0, MAX_STEPS, body, (traveled, steps, done))

    col = 1.0 - jnp.sqrt(steps.astype(jnp.float32)) * 0.1
    return vec4(col, col, col, 1.0)


class RayMarch(ShaderScene):
    """Ray Marching demo"""

    def build(self):
        self.shader.fragment = raymarch_frag


# ---------------------------------------------------------------------------- #

def life_simulation_frag(sf):
    """Conway's Game of Life step (life/simulation.glsl): 3x3 neighborhood
    from the previous frame (temporal slot 1), gated to every iLifePeriod
    frames."""
    size = sf.uniform("iLifeSize")
    previous = sf.tex("iLife", 1, 0)
    pixel = (sf.astuv * size).astype(jnp.int32)

    near = jnp.zeros(pixel.shape[:-1], jnp.int32)
    current = jnp.zeros(pixel.shape[:-1], jnp.int32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cell = (sf.texel_fetch(previous, pixel + jnp.array([dx, dy]))[..., 0]
                    > 0.5).astype(jnp.int32)
            if dx == 0 and dy == 0:
                current = cell
            else:
                near = near + cell

    # Survival: 2-3 neighbors; birth: exactly 3
    alive = jnp.where(current == 1, ((near == 2) | (near == 3)), (near == 3))
    stepped = alive.astype(jnp.float32)

    hold = sf.texture(previous, sf.astuv)[..., 0]
    out = jnp.where(jnp.mod(sf.iFrame, sf.uniform("iLifePeriod")) != 0, hold, stepped)
    return out[..., None]


def life_visuals_frag(sf):
    """Temporal integration of the simulation states (life/visuals.glsl)."""
    cam = sf.camera
    uv = cam.stuv
    colors = [ops.PALETTE_MAGMA_1, ops.PALETTE_MAGMA_2,
              ops.PALETTE_MAGMA_3, ops.PALETTE_MAGMA_4]

    exponent = 1.3
    area = 1 / (exponent + 1)
    life = sf.stexture(sf.tex("iLife", 0, 0), uv)[..., 0]
    for i, factor in enumerate((0.8, 0.6, 0.4, 0.2), start=1):
        life = life + (sf.stexture(sf.tex("iLife", i, 0), uv)[..., 0]
                       * (factor ** exponent))
    life = life / (5 * area)

    rgb = ops.palette(life, *colors)
    rgb = jnp.where(cam.out_of_bounds[..., None], colors[0], rgb)
    return vec4(rgb, 1.0)


class Life(ShaderScene):
    """Conway's Game of Life"""

    life_period: int = 6

    def setup(self):
        width, height = 192, 108
        random = np.random.default_rng(0).integers(0, 2, (height, width)).astype(np.float32)
        self.simulation.texture.size = (width, height)
        self.simulation.texture.write(random, temporal=1)

    def build(self):
        self.simulation = ShaderProgram(scene=self, name="iLife")
        self.simulation.texture.temporal = 10
        self.simulation.texture.filter = "nearest"
        self.simulation.texture.dtype = "f4"
        self.simulation.texture.components = 1
        self.simulation.texture.track = False
        self.simulation.fragment = life_simulation_frag
        self.shader.fragment = life_visuals_frag

    def pipeline(self):
        yield from ShaderScene.pipeline(self)
        yield Uniform("int", "iLifePeriod", self.life_period)


SCENES = [Basic, ShaderToy, MultiShader, Multipass, MotionBlur, Dynamics, Video,
          Audio, Waveform, MusicBars, Visualizer, RayMarch, Life]

if __name__ == "__main__":
    from shaderflow_tpu.cli import launch
    launch(SCENES)
