"""
Fractal scenes — iteration-heavy pixels.

Equivalents of the reference fractal examples
(/root/reference/examples/fractals/): Mandelbrot (escape-time loop bounded
by the quality parameter) and complex Tetration. The iteration counts are
compile-time constants derived from the scene quality (a static uniform),
so XLA unrolls/fuses the escape loop instead of tracing data-dependent
Python control flow.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
from jax import lax

sys.path.insert(0, str(Path(__file__).parent.parent))

from shaderflow_tpu import ops
from shaderflow_tpu.ops import cmul, cpow, vec2, vec4
from shaderflow_tpu.scene import ShaderScene


def mandelbrot_frag(sf):
    """Escape-time Mandelbrot with magma palette (mandelbrot.frag).

    Iteration runs through ops.fractal.escape_iterations: per-block
    early-exit while loops on the GPU (frame cost follows each block's own
    escape time), masked fori_loop elsewhere. The palette + out-of-bounds
    mask + SSAA downsample + u8 quantize run in the tail stage."""
    from shaderflow_tpu.ops import tailfuse
    from shaderflow_tpu.ops.fractal import (escape_iterations,
                                            escape_iterations_sep)
    cam = sf.camera

    quality = max(1, int(1000.0 * sf.uniform("iQualityS")))

    import math
    import numpy as _np
    magma = tuple(_np.asarray(stop) for stop in (
        ops.PALETTE_MAGMA_1, ops.PALETTE_MAGMA_2,
        ops.PALETTE_MAGMA_3, ops.PALETTE_MAGMA_4))
    oob_color = magma[0]     # palette_magma(0) == stop A exactly

    # Visual iteration cap: the tail maps count i to palette(pow(1-i/q, 20))
    # quantized to u8. For saturated pixels t^20 is tiny, so only the A->B
    # palette segment applies (slope 4*max|B-A| per unit t^20); any count
    # with slope*255*t^20 < 0.5 renders within half a u8 step of the q-count
    # color — for ANY view. Iterating past that cap is dead work: cap =
    # q*(1 - (0.5/(255*slope))^(1/20)) ~ 0.284*q. Counts below the cap stay
    # EXACT (bit-identical to the reference loop).
    slope = 4.0 * float(max(abs(magma[1] - magma[0])))
    cap = math.ceil(quality * (1.0 - (0.5 / (255.0 * slope)) ** (1.0 / 20.0)))
    # Trivial (axis-aligned) camera: gluv is an outer product of two lines,
    # so the escape kernel reads two LINES instead of four (H, W) planes,
    # and out-of-bounds is a column line. `iCameraTrivial` is a static — rotating the camera
    # flips it and retraces onto the general plane path below.
    trivial = bool(sf.uniform("iCameraTrivial", default=False))
    if trivial:
        cx_line = cam.gluv[0, :, 0] - 0.5
        cy_line = cam.gluv[:, 0, 1]
        # out_dtype=f32: the tail consumes floats (exact: counts are
        # f32-representable)
        iters = escape_iterations_sep(cx_line, cy_line, quality,
                                      radius=3.0, saturate=cap,
                                      out_dtype=jnp.float32)
        oob_in = tailfuse.Col(cam.out_of_bounds[0, :].astype(jnp.float32))
    else:
        c = cam.gluv - vec2(0.5, 0.0)
        iters = escape_iterations(c, quality, radius=3.0, saturate=cap,
                                  out_dtype=jnp.float32)
        oob_in = cam.out_of_bounds.astype(jnp.float32)

    def tail(tp):
        t = 1.0 - tp.plane("iters") / quality
        # x^20 as a multiply chain (exp(20 log t) would lose the t == 0
        # interior exactly)
        t2 = t * t
        t4 = t2 * t2
        t16 = (t4 * t4) * (t4 * t4)
        t = t16 * t4
        oob = (tp.col("oob") if trivial else tp.plane("oob")) > 0.5
        out = []
        for channel in range(3):
            a, b, cc, d = (float(stop[channel]) for stop in magma)
            # GLSL mix does NOT clamp: the selected branches extrapolate
            # (C->D continues past t=0.75), exactly like ops.palette
            ab = a + (b - a) * (t * 4.0)
            bc = b + (cc - b) * ((t - 0.25) * 4.0)
            cd = cc + (d - cc) * ((t - 0.5) * 4.0)
            value = jnp.where(t < 0.25, ab, jnp.where(t < 0.5, bc, cd))
            out.append(jnp.where(oob, float(oob_color[channel]), value))
        return out

    return sf.tail(tail,
                   iters=iters.astype(jnp.float32),
                   oob=oob_in)


class Mandelbrot(ShaderScene):
    """Mandelbrot fractal"""

    def build(self):
        self.shader.fragment = mandelbrot_frag


def julia_frag(sf):
    """Julia set: same escape iteration with a fixed c and z0 = pixel;
    the c parameter orbits slowly over time for the classic morphing zoom."""
    from shaderflow_tpu.ops.fractal import escape_iterations_z0
    cam = sf.camera
    z0 = cam.gluv
    cx = -0.8 + 0.156 * jnp.cos(sf.iTime * 0.31)
    cy = 0.156 + 0.08 * jnp.sin(sf.iTime * 0.17)

    quality = max(1, int(1000.0 * sf.uniform("iQualityS")))
    # Visual cap (see mandelbrot_frag): every channel is bounded by
    # value = pow(1-i/q, 8), so once 255*t^8 < 0.25 the capped and true
    # colors both round within half a u8 step — the hue wheel is
    # irrelevant at that magnitude. Counts below the cap stay exact.
    import math
    cap = math.ceil(quality * (1.0 - (0.25 / 255.0) ** (1.0 / 8.0)))
    iters = escape_iterations_z0(z0, cx, cy, quality, radius=3.0,
                                 saturate=cap)

    TAU = 2.0 * jnp.pi

    def tail(tp):
        it = tp.plane("iters")
        t = 1.0 - it / quality
        t2 = t * t
        t8 = (t2 * t2) * (t2 * t2)             # == power(t, 8), exact
        # hsv2rgb (ops.stdlib.hsv2rgb) in the plane dialect, s = 0.8
        h = jnp.mod(TAU * (it / 64.0), TAU)
        value = t8
        c = value * 0.8
        x = c * (1.0 - jnp.abs(jnp.mod(h / (jnp.pi / 3.0), 2.0) - 1.0))
        m = value - c
        sector = jnp.floor(6.0 * (h / TAU))
        zero = jnp.zeros_like(c)

        def pick(options):
            out = zero
            for k, option in enumerate(options):
                out = jnp.where(sector == float(k), option, out)
            return out

        oob = tp.plane("oob") > 0.5
        r = pick([c, x, zero, zero, x, c]) + m
        g = pick([x, c, c, x, zero, zero]) + m
        b = pick([zero, zero, x, c, c, x]) + m
        return (jnp.where(oob, 0.0, r), jnp.where(oob, 0.0, g),
                jnp.where(oob, 0.0, b))

    return sf.tail(tail,
                   iters=iters.astype(jnp.float32),
                   oob=cam.out_of_bounds.astype(jnp.float32))


class Julia(ShaderScene):
    """Julia fractal with a time-orbiting parameter"""

    def build(self):
        self.shader.fragment = julia_frag


def tetration_frag(sf):
    """Complex tetration fractal (tetration.frag): Z <- C^Z iterated."""
    cam = sf.camera
    c = cam.gluv
    MAX_STEPS = 67

    def body(_, state):
        z, escaped = state
        znew = cpow(c, z)
        active = ~escaped
        # The breaking value of Z is what colors the pixel (GLSL breaks
        # AFTER the update), so z freezes at its first escaped value
        z = jnp.where(active[..., None], znew, z)
        mag = ops.cmag(z)
        escaped = escaped | (mag > 100.0) | ~jnp.isfinite(mag)
        return z, escaped

    z = c
    escaped = jnp.zeros(c.shape[:-1], bool)
    z, escaped = lax.fori_loop(0, MAX_STEPS, body, (z, escaped))
    # tetration.frag:48 `float k = it / MAX_STEPS` — INTEGER division (both
    # operands int): k is 1 only when the loop completed without breaking
    # (the orbit never escaped), else 0. Binary, not a smooth ramp. Orbits
    # that blow up to inf/nan never satisfy `Z.r > 100.0` in GLSL either
    # (NaN compares false) and would reach k=1 with an undefined hue; the
    # finite guard above maps them to k=0 (black) instead — the one
    # deliberate deviation (driver-UB otherwise).
    k = (~escaped).astype(jnp.float32)

    from shaderflow_tpu.ops import tailfuse
    TAU = 2.0 * jnp.pi

    def tail(tp):
        # hue = the reference's (0, 2pi)-range atan2 in CYCLES, fed to the
        # radians-domain hsv (preserves the scene's existing look);
        # tailfuse.atan2 is the oracle-pinned poly with the standard
        # (-pi, pi] range — mod folds it to (0, 2pi)
        h = jnp.mod(tailfuse.atan2(tp.plane("zy"), tp.plane("zx")), TAU) / TAU
        value = tp.plane("k")
        x = value * (1.0 - jnp.abs(jnp.mod(h / (jnp.pi / 3.0), 2.0) - 1.0))
        sector = jnp.floor(6.0 * (h / TAU))
        zero = jnp.zeros_like(value)

        def pick(options):
            out = zero
            for index, option in enumerate(options):
                out = jnp.where(sector == float(index), option, out)
            return out

        # s = 1: c == v, m == 0
        return (pick([value, x, zero, zero, x, value]),
                pick([x, value, value, x, zero, zero]),
                pick([zero, zero, x, value, value, x]))

    return sf.tail(tail,
                   k=k,
                   zx=z[..., 0], zy=z[..., 1])


class Tetration(ShaderScene):
    """Complex tetration fractal"""

    def build(self):
        self.shader.fragment = tetration_frag


SCENES = [Mandelbrot, Julia, Tetration]

if __name__ == "__main__":
    from shaderflow_tpu.cli import launch
    launch(SCENES)
