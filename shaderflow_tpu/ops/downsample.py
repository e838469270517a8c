"""
Fused SSAA downsample + uint8 quantization — the "final pass".

Equivalent of the reference's iFinal shader program
(/root/reference/shaderflow/resources/shaders/fragment/final.glsl:12-32): for
every output pixel, average a subsample x subsample grid of bilinear taps
spanning one output pixel of the supersampled render. Unlike the reference
(a second GL draw + u8 FBO), this fuses into the same XLA program as the
render itself — the supersampled frame never round-trips to HBM as a
separate pass when XLA fuses producer/consumer.

Fast path: when the render is an exact integer multiple of the output and
the subsample kernel equals that multiple, every tap lands on a texel center
and the shader reduces to exact s x s average pooling (a reshape-mean XLA
handles at memory bandwidth).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from shaderflow_tpu.ops.sampling import resample_separable_blocked

Array = jax.Array


def box_downsample(x: Array, factor: int) -> Array:
    """Exact factor x factor average pooling of (H, W, C) via
    lax.reduce_window."""
    window = jax.lax.reduce_window(
        x, 0.0, jax.lax.add,
        window_dimensions=(factor, factor, 1),
        window_strides=(factor, factor, 1),
        padding="VALID")
    return window / float(factor * factor)


def quantize_u8(x: Array) -> Array:
    """GL UNSIGNED_BYTE conversion: floor(clamp(c, 0, 1) * 255 + 0.5).

    Half-away rounding, not jnp.round's half-to-even — GL hardware rounds
    ties up, and PSNR parity cares about exactly these off-by-ones. Always
    computes in f32 (a bf16 *255 would round to 8 significant bits — half a
    quantization step of error); the upcast fuses into the elementwise
    chain, costing no extra HBM traffic for bf16 inputs."""
    x = x.astype(jnp.float32)
    return jnp.floor(jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)


def _output_astuv(height: int, width: int) -> Array:
    """Pixel-center GL texture coordinates of the output grid (row 0 = top)."""
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    return jnp.stack(jnp.meshgrid(u, v, indexing="xy"), axis=-1)  # (H, W, 2)


def ssaa_downsample(
    render: Array,
    out_height: int,
    out_width: int,
    subsample: int = 2,
    components: int = 3,
) -> Array:
    """Downsample a supersampled (Hr, Wr, C) float render to
    (out_height, out_width, components) float in [0, 1]."""
    rh, rw = render.shape[0], render.shape[1]
    # Slice channels FIRST (lets XLA dead-code-eliminate the alpha lane the
    # shader produced), then materialize the supersampled render exactly
    # once: without the barrier XLA fuses the whole producing shader into
    # EACH pooling tap below, recomputing the frame subsample^2 times.
    render = render[..., :components]
    render = jax.lax.optimization_barrier(render)

    # Equal resolution: the subsample^2 bilinear taps all land within one
    # pixel of a clamp-to-edge linear texture, which collapses to a
    # SEPARABLE 3-tap stencil per axis (tap offsets d_k = -1/2 + (k+1/2)/s
    # texels; averaging the bilinear reads gives weights [m, 1-2m, m] with
    # m = mean(max(d_k, 0))). Same math as the general path below but as 6
    # fused shift-adds instead of two dense interp matmuls per tap —
    # measured 4 ms/frame -> ~0.5 ms at 4K (the pianoroll/raymarch configs
    # run ssaa=1 subsample=2 through exactly this branch).
    if (rh, rw) == (out_height, out_width) and subsample >= 1:
        if subsample == 1:
            return render
        m = sum(max(0.0, -0.5 + (k + 0.5) / subsample)
                for k in range(subsample)) / subsample
        padded = jnp.pad(render, ((1, 1), (1, 1), (0, 0)), mode="edge")
        rows = ((1.0 - 2.0 * m) * padded[1:1 + out_height]
                + m * (padded[0:out_height] + padded[2:2 + out_height]))
        return ((1.0 - 2.0 * m) * rows[:, 1:1 + out_width]
                + m * (rows[:, 0:out_width] + rows[:, 2:2 + out_width]))

    # Exact average pooling when taps align with texel centers.
    if (rh == out_height * subsample) and (rw == out_width * subsample) and subsample > 1:
        return box_downsample(render, subsample)

    # General path: subsample^2 bilinear taps per output pixel
    # (final.glsl:21-29). Every tap is the composition of two 1D linear
    # interpolation operators (C_du over columns, R_dv over rows) and the
    # tap grid is axis-aligned, so by linearity the whole tap sum
    # factorizes: sum_{du,dv} C_du∘R_dv = (sum_du C_du)∘(sum_dv R_dv).
    # The s^2-tap average collapses into ONE separable resample whose
    # per-axis matrices are the tap-averaged hat bands (identical math;
    # summation order differs by matmul ULPs) — contracted BLOCKED
    # (resample_separable_blocked): each output block reads only its
    # ~block*texels_per_px window instead of the dense (Ho, Hr) x (Hr, W)
    # GEMM, which is quadratic waste at 4K ssaa<1 / raw-scale configs.
    u_centers = (jnp.arange(out_width, dtype=jnp.float32) + 0.5) / out_width
    v_centers = 1.0 - (jnp.arange(out_height, dtype=jnp.float32) + 0.5) / out_height

    pixel_u = 1.0 / out_width
    pixel_v = 1.0 / out_height
    pos_rows = []
    pos_cols = []
    for k in range(subsample):
        du = -pixel_u / 2.0 + (pixel_u / subsample) * (0.5 + k)
        dv = -pixel_v / 2.0 + (pixel_v / subsample) * (0.5 + k)
        # Texel positions per sampling.sample_separable's conventions
        pos_cols.append((u_centers + du) * rw - 0.5)
        pos_rows.append((1.0 - (v_centers + dv)) * rh - 0.5)
    out = resample_separable_blocked(
        render,
        jnp.stack(pos_rows), jnp.stack(pos_cols),
        rows_per_px=rh / out_height, cols_per_px=rw / out_width)
    return out[..., :components]


def final_pass(render: Array, out_height: int, out_width: int, subsample: int = 2) -> Array:
    """Full final pass: SSAA downsample + u8 quantize -> (H, W, 3) uint8."""
    return quantize_u8(ssaa_downsample(render, out_height, out_width, subsample, components=3))
