"""
Shader-tail stage: per-pixel post-processing written in a plane dialect,
followed by the SSAA downsample and uint8 quantization.

The reference renders the shader, then runs the final.glsl box downsample as
a second GL pass (/root/reference/shaderflow/resources/shaders/fragment/
final.glsl:12-32). Here a pixel program may hand its elementwise "tail"
(masks, vignettes, overlays after the texture samples) to the engine as a
TailSpec. On the GPU, in the exact-pooling SSAA regime, one Pallas kernel
(Triton route) evaluates the tail, pools and quantizes per block of output
pixels, so the full-resolution render is never written (tail_final_kernel).
Everywhere else the tail runs on full-resolution arrays (eval_reference)
followed by ops.downsample.final_pass — the semantic definition the kernel
is tested against.

Usage, from a pixel program (shader.py Frag):

    def my_frag(sf):
        color = ...expensive sampling...
        def tail(tp):
            r, g, b = tp.vec3("color")
            v = tp.astuv_x * (1 - tp.astuv_y)      # coordinate planes
            r, g, b = r * v, g * v, b * v
            return r, g, b
        return sf.tail(tail, color=color)

The tail function is written in the PLANE dialect: every value is a 2D
(rows, cols) array (one channel = one plane). It must be pure jnp/lax
elementwise math (no convolutions, no neighbor access). Inputs are declared
by shape: full planes, per-row lines (Row), per-column lines (Col), small
lookup tables (Table), column-resampled textures (ColSampled) and planes
picked from a stacked batch-prelude output (Indexed).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

Array = jax.Array


# --------------------------------------------------------------------------- #
# Polynomial transcendentals shared by the tails and the oracle-pinned scenes

def atan2(y: Array, x: Array) -> Array:
    """Polynomial atan2 for tail functions (range (-pi, pi], max error ~1e-5
    rad). The example scenes' oracle pins were taken with this polynomial,
    so it stays instead of lax.atan2.

    Matches IEEE arctan2 on infinities (escaped-fractal z planes contain
    them); deviation: -0.0 is treated as +0.0, so atan2(0, -0.0) is 0, not
    pi.

    Computes in f32 regardless of input dtype (8 mantissa bits would wreck
    the minimax polynomial). Returns f32."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    # hi == lo covers the both-infinite case (inf/inf is NaN, but IEEE
    # arctan2(+-inf, +-inf) is +-pi/4 etc.) and is exact (t = 1) for equal
    # finite magnitudes; escaped-fractal z values hit this (tetration golden).
    t = jnp.where((hi == lo) & (hi > 0.0), jnp.float32(1.0),
                  lo / jnp.maximum(hi, 1e-30))
    s = t * t
    # Minimax polynomial for atan(t), t in [0, 1]
    r = t * (0.99997726 + s * (-0.33262347 + s * (0.19354346
             + s * (-0.11643287 + s * (0.05265332 + s * -0.01172120)))))
    r = jnp.where(ay > ax, jnp.float32(math.pi / 2) - r, r)
    r = jnp.where(x < 0.0, jnp.float32(math.pi) - r, r)
    return jnp.where(y < 0.0, -r, r)


def powf(x: Array, p) -> Array:
    """pow for tail functions with GLSL semantics exp(p*log(x)) — x must be
    > 0 or the result is 0/undefined, exactly like GLSL pow. x == 0 with
    p > 0 returns 0. Computes in f32 regardless of input dtype."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.exp(jnp.asarray(p, jnp.float32) * jnp.log(x))


# --------------------------------------------------------------------------- #
# Input wrappers

class Row(NamedTuple):
    """A per-row input: shape (render_height,) — broadcast along x."""
    value: Any


class Col(NamedTuple):
    """A per-column input: shape (render_width,) — broadcast along y."""
    value: Any


class Table(NamedTuple):
    """A small (bins, channels) lookup table."""
    value: Any


class ColSampled(NamedTuple):
    """A texture input whose last 1D linear filtering pass, along columns,
    is left to the tail stage.

    `planes` are row-interpolated intermediates (render_height, W_in) — the
    output of ops.sampling.sample_rows_planes_blocked. The tail stage
    resamples their columns at `u_line` (colsample) right where the tail
    reads them, so XLA can fuse the resample into the tail's fusion.

    u_line: (render_width,) normalized u in [0, 1] (u * W_in - 0.5 texel
    convention, CLAMP; same CONTRACT as sample_separable_planes_blocked:
    positions inside [0, W_in - 1], taps per output pixel <= texels_per_px).
    """
    planes: Any            # tuple of (render_height, W_in) arrays
    u_line: Any            # (render_width,) normalized
    texels_per_px: float


class ColSampledSpec(NamedTuple):
    planes: tuple          # tuple of (Hr, W_in) arrays
    positions: Any         # (Wr,) continuous texel positions, clipped


class Indexed(NamedTuple):
    """One (Hr, Wr) plane selected from a stacked (N, Hr, Wr) array by a
    traced index — typically a batch-prelude output read inside the render
    scan. The index is clipped to [0, N)."""
    stack: Any             # (N, Hr, Wr) array
    index: Any             # traced i32 scalar in [0, N)


class TailSpec(NamedTuple):
    """A deferred tail stage: returned by Frag.tail(), consumed by the engine."""
    fn: Callable[["TailCtx"], Any]
    planes: dict          # name -> tuple of (Hr, Wr) arrays (channel planes)
    rows: dict            # name -> (Hr,) array
    cols: dict            # name -> (Wr,) array
    scalars: dict         # name -> 0-d traced value
    tables: dict          # name -> (bins, C) array
    colsampled: dict = {}  # name -> ColSampledSpec
    indexed: dict = {}     # name -> Indexed


def make_spec(fn: Callable, render_height: int, render_width: int,
              **inputs) -> TailSpec:
    """Classify keyword inputs by shape into the TailSpec buckets."""
    planes, rows, cols, scalars, tables = {}, {}, {}, {}, {}
    colsampled = {}
    indexed = {}
    for name, value in inputs.items():
        if isinstance(value, Indexed):
            stack = jnp.asarray(value.stack)
            if stack.shape[1:] != (render_height, render_width):
                raise ValueError(
                    f"Indexed input {name!r}: stack shape {stack.shape} != "
                    f"(N, {render_height}, {render_width})")
            indexed[name] = Indexed(stack, jnp.asarray(value.index, jnp.int32))
            continue
        if isinstance(value, ColSampled):
            channels = tuple(jnp.asarray(p) for p in value.planes)
            w_in = channels[0].shape[1]
            for channel in channels:
                if channel.shape != (render_height, w_in):
                    raise ValueError(
                        f"ColSampled input {name!r}: plane shape "
                        f"{channel.shape} != ({render_height}, {w_in})")
            u = jnp.asarray(value.u_line).reshape(render_width)
            positions = jnp.clip(u * w_in - 0.5, 0.0, float(w_in - 1))
            colsampled[name] = ColSampledSpec(channels, positions)
            continue
        if isinstance(value, Row):
            rows[name] = jnp.asarray(value.value).reshape(render_height)
        elif isinstance(value, Col):
            cols[name] = jnp.asarray(value.value).reshape(render_width)
        elif isinstance(value, Table):
            table = jnp.asarray(value.value)
            if table.ndim == 1:
                table = table[:, None]
            tables[name] = table
        elif isinstance(value, (tuple, list)):
            # Pre-split channel planes (sample_separable_planes & co.)
            channels = tuple(jnp.asarray(v) for v in value)
            for channel in channels:
                if channel.shape != (render_height, render_width):
                    raise ValueError(
                        f"Tail input {name!r}: channel plane shape "
                        f"{channel.shape} != render {(render_height, render_width)}")
            planes[name] = channels
        else:
            value = jnp.asarray(value)
            if value.ndim == 0:
                scalars[name] = value
            elif value.ndim == 1:
                if value.shape[0] == render_height and render_height != render_width:
                    rows[name] = value
                elif value.shape[0] == render_width and render_height != render_width:
                    cols[name] = value
                else:
                    raise ValueError(
                        f"Ambiguous 1D tail input {name!r} (len {value.shape[0]}); "
                        f"wrap it in tailfuse.Row(...) or tailfuse.Col(...)")
            elif value.ndim == 2:
                planes[name] = (value,)
            elif value.ndim == 3:
                planes[name] = tuple(value[..., c] for c in range(value.shape[-1]))
            else:
                raise ValueError(f"Unsupported tail input {name!r} ndim={value.ndim}")
    return TailSpec(fn, planes, rows, cols, scalars, tables, colsampled,
                    indexed)


# --------------------------------------------------------------------------- #
# The tail context: what the tail function sees

class TailCtx:
    """Handed to the tail function. All values are 2D (Hr, Wr) float32
    planes covering the whole render."""

    dtype = jnp.float32

    def __init__(self, planes, rows, cols, scalars, tables,
                 row_index: Array, col_index: Array,
                 render_height: int, render_width: int, aspect: float):
        self._planes = planes      # name -> tuple of 2D arrays
        self._rows = rows          # name -> (Hr, 1) column vector
        self._cols = cols          # name -> (1, Wr) row vector
        self._scalars = scalars
        self._tables = tables      # name -> (bins, C) f32
        self._row_index = row_index  # (Hr, Wr) f32 row index
        self._col_index = col_index
        self.render_height = render_height
        self.render_width = render_width
        self.aspect = aspect

    # -- inputs --------------------------------------------------------------

    def plane(self, name: str, channel: int = 0, dtype=None) -> Array:
        """A channel plane as f32 (or an explicit `dtype`)."""
        return self._planes[name][channel].astype(dtype or self.dtype)

    def channels(self, name: str) -> int:
        return len(self._planes[name])

    def vec(self, name: str) -> tuple:
        return tuple(p.astype(self.dtype) for p in self._planes[name])

    # Aliases making intent explicit at call sites
    def vec2(self, name: str) -> tuple:
        return self.vec(name)

    def vec3(self, name: str) -> tuple:
        return self.vec(name)

    def row(self, name: str) -> Array:
        """Per-row input broadcast to the working shape."""
        return jnp.broadcast_to(self._rows[name].astype(jnp.float32),
                                self._row_index.shape)

    def col(self, name: str) -> Array:
        return jnp.broadcast_to(self._cols[name].astype(jnp.float32),
                                self._col_index.shape)

    def scalar(self, name: str) -> Array:
        return self._scalars[name]

    def f(self, x: Array) -> Array:
        """Cast a value into the color-math dtype (f32)."""
        return jnp.asarray(x).astype(self.dtype)

    def lookup(self, name: str, index_plane: Array, channel: int = 0) -> Array:
        """Nearest lookup table[clip(round-down(index)), channel] for a small
        Table input."""
        table = jnp.asarray(self._tables[name], jnp.float32)
        bins = table.shape[0]
        idx = jnp.clip(index_plane.astype(jnp.int32), 0, bins - 1)
        return jnp.take(table[:, channel], idx)

    # -- coordinates (ssaa-resolution, GL conventions) ------------------------

    @property
    def astuv_x(self) -> Array:
        return (self._col_index + 0.5) / self.render_width

    @property
    def astuv_y(self) -> Array:
        """astuv y grows UP the screen (absolute shadertoy uv,
        shaderflow.glsl); row 0 is y near 1."""
        return 1.0 - (self._row_index + 0.5) / self.render_height

    @property
    def agluv_x(self) -> Array:
        return self.astuv_x * 2.0 - 1.0

    @property
    def agluv_y(self) -> Array:
        return self.astuv_y * 2.0 - 1.0

    @property
    def gluv_x(self) -> Array:
        return self.agluv_x * self.aspect

    @property
    def gluv_y(self) -> Array:
        return self.agluv_y


# --------------------------------------------------------------------------- #
# Evaluation

def colsample_dense(plane: Array, positions: Array) -> Array:
    """Column resample of a (Hr, W_in) plane at (Wr,) continuous texel
    positions -> (Hr, Wr) f32, as one matmul against the 2-tap hat-weight
    matrix W[k, c] = max(0, 1 - |pos(c) - k|). The weights take the plane's
    dtype (bf16 planes round them), accumulation is f32."""
    w_in = plane.shape[1]
    texels = jnp.arange(w_in, dtype=jnp.float32)
    weights = jnp.maximum(1.0 - jnp.abs(positions[None, :] - texels[:, None]),
                          0.0)                                  # (W_in, Wr)
    if plane.dtype == jnp.bfloat16:
        weights = weights.astype(jnp.bfloat16)
    return jnp.dot(plane, weights, preferred_element_type=jnp.float32)


def colsample_gather(plane: Array, positions: Array) -> Array:
    """The same resample as colsample_dense, as two column gathers and a
    lerp in f32 (positions lie in [0, W_in - 1], so the right tap is
    clamped only where its weight is 0)."""
    w_in = plane.shape[1]
    left = jnp.clip(jnp.floor(positions), 0, w_in - 1).astype(jnp.int32)
    right = jnp.minimum(left + 1, w_in - 1)
    frac = positions - left.astype(jnp.float32)
    a = jnp.take(plane, left, axis=1).astype(jnp.float32)
    b = jnp.take(plane, right, axis=1).astype(jnp.float32)
    return a + (b - a) * frac


def _materialize_colsampled(spec: TailSpec) -> dict:
    """ColSampled inputs -> full (Hr, Wr) channel planes (the gather form:
    faster than the dense one end to end on the GPU, PERF.md)."""
    return {name: tuple(colsample_gather(plane, cs.positions)
                        for plane in cs.planes)
            for name, cs in spec.colsampled.items()}


def _materialize_indexed(spec: TailSpec) -> dict:
    """Dynamic-index each Indexed stack -> one (Hr, Wr) channel plane."""
    extra = {}
    for name, ix in spec.indexed.items():
        index = jnp.clip(ix.index, 0, ix.stack.shape[0] - 1)
        extra[name] = (jax.lax.dynamic_index_in_dim(
            ix.stack, index, 0, keepdims=False),)
    return extra


def _full_ctx(spec: TailSpec, render_height: int, render_width: int,
              aspect: float) -> TailCtx:
    rows = {k: v.reshape(-1, 1) for k, v in spec.rows.items()}
    cols = {k: v.reshape(1, -1) for k, v in spec.cols.items()}
    row_index = jax.lax.broadcasted_iota(
        jnp.float32, (render_height, render_width), 0)
    col_index = jax.lax.broadcasted_iota(
        jnp.float32, (render_height, render_width), 1)
    planes = {**spec.planes, **_materialize_colsampled(spec),
              **_materialize_indexed(spec)}
    return TailCtx(planes, rows, cols, spec.scalars, spec.tables,
                   row_index, col_index, render_height, render_width, aspect)


def _tail_planes(spec: TailSpec, render_height: int, render_width: int,
                 aspect: float) -> list:
    """Run the tail on full-resolution arrays -> three (Hr, Wr) f32 planes."""
    ctx = _full_ctx(spec, render_height, render_width, aspect)
    return [jnp.broadcast_to(jnp.asarray(p, jnp.float32),
                             (render_height, render_width))
            for p in spec.fn(ctx)[:3]]


def eval_reference(spec: TailSpec, render_height: int, render_width: int,
                   aspect: float) -> Array:
    """Run the tail on full-resolution arrays -> (Hr, Wr, 3) float32."""
    return jnp.stack(_tail_planes(spec, render_height, render_width, aspect),
                     axis=-1)


# --------------------------------------------------------------------------- #
# The tail kernel (Pallas, Triton route): tail + pool + quantize per tile

# Output pixels per program and warps, chosen by a sweep on an H100 at the
# Visualizer's 1080p60 ssaa=2 export (PERF.md).
TAIL_BLOCK = (4, 128)
TAIL_WARPS = 8

# The kernel computes offsets into its flat operands in int32
MAX_FLAT_OFFSET = 2 ** 31 - 1


def _indexed_operands(ix: Indexed) -> list:
    """An Indexed input as the kernel reads it: the flat stack and the
    clipped frame index. A stack too large for int32 offsets (a (B, Hr, Wr)
    batch stack at high SSAA) is replaced by the frame's plane alone, with
    index 0."""
    index = jnp.clip(ix.index, 0, ix.stack.shape[0] - 1).astype(jnp.int32)
    if ix.stack.size > MAX_FLAT_OFFSET:
        plane = jax.lax.dynamic_index_in_dim(ix.stack, index, 0)
        return [plane.reshape(-1), jnp.zeros((1,), jnp.int32)]
    return [ix.stack.reshape(-1), index.reshape(1)]


def tail_final_kernel(spec: TailSpec, render_height: int, render_width: int,
                      out_height: int, out_width: int, subsample: int,
                      aspect: float, *, block=None, num_warps: int = None,
                      interpret: bool = False) -> Array:
    """run_tail_final in the exact-pooling regime (render == output *
    subsample) as one kernel: each program owns a block of output pixels,
    evaluates the tail once per sub-pixel offset (dy, dx) on the strided
    render pixels that pool into them, sums, averages and quantizes. Only
    the tail's inputs are read and only the u8 frame is written — no
    full-resolution intermediate exists. Table inputs are not supported.

    Every operand is passed flat and indexed with computed offsets, so edge
    blocks mask their loads and stores instead of padding."""
    s = int(subsample)
    th, tw = block or TAIL_BLOCK
    hr, wr = render_height, render_width
    plane_names = sorted(spec.planes)
    row_names, col_names = sorted(spec.rows), sorted(spec.cols)
    scalar_names = sorted(spec.scalars)
    cs_names, ix_names = sorted(spec.colsampled), sorted(spec.indexed)

    operands = []
    for name in plane_names:
        operands += [p.reshape(-1) for p in spec.planes[name]]
    operands += [spec.rows[n].reshape(-1) for n in row_names]
    operands += [spec.cols[n].reshape(-1) for n in col_names]
    if scalar_names:
        operands.append(jnp.stack([jnp.asarray(spec.scalars[n], jnp.float32)
                                   for n in scalar_names]))
    for name in cs_names:
        cs = spec.colsampled[name]
        operands += [p.reshape(-1) for p in cs.planes]
        operands.append(cs.positions.astype(jnp.float32))
    for name in ix_names:
        operands += _indexed_operands(spec.indexed[name])

    def load(ref, index, mask):
        return pltriton.load(ref.at[index], mask=mask, other=0)

    def kernel(*refs):
        out_ref, refs = refs[-1], iter(refs[:-1])
        plane_refs = {n: [next(refs) for _ in spec.planes[n]]
                      for n in plane_names}
        row_refs = {n: next(refs) for n in row_names}
        col_refs = {n: next(refs) for n in col_names}
        scalar_ref = next(refs) if scalar_names else None
        cs_refs = {n: ([next(refs) for _ in spec.colsampled[n].planes],
                       next(refs)) for n in cs_names}
        ix_refs = {n: (next(refs), next(refs)) for n in ix_names}

        orow = pl.program_id(0) * th + jnp.arange(th)
        ocol = pl.program_id(1) * tw + jnp.arange(tw)
        row_ok, col_ok = orow < out_height, ocol < out_width
        mask = row_ok[:, None] & col_ok[None, :]
        scalars = {n: scalar_ref[k] for k, n in enumerate(scalar_names)}
        acc = [jnp.zeros((th, tw), jnp.float32) for _ in range(3)]
        for dy in range(s):
            for dx in range(s):
                rows = orow * s + dy
                cols = ocol * s + dx
                flat = rows[:, None] * wr + cols[None, :]
                planes = {n: tuple(load(r, flat, mask) for r in plane_refs[n])
                          for n in plane_names}
                for n, (refs_cs, pos_ref) in cs_refs.items():
                    w_in = spec.colsampled[n].planes[0].shape[1]
                    pos = load(pos_ref, cols, col_ok)
                    left = jnp.clip(jnp.floor(pos), 0, w_in - 1).astype(
                        jnp.int32)
                    right = jnp.minimum(left + 1, w_in - 1)
                    frac = (pos - left.astype(jnp.float32))[None, :]
                    base = rows[:, None] * w_in
                    sampled = []
                    for ref in refs_cs:
                        a = load(ref, base + left[None, :], mask).astype(
                            jnp.float32)
                        b = load(ref, base + right[None, :], mask).astype(
                            jnp.float32)
                        sampled.append(a + (b - a) * frac)
                    planes[n] = tuple(sampled)
                for n, (stack_ref, index_ref) in ix_refs.items():
                    planes[n] = (load(stack_ref, index_ref[0] * (hr * wr)
                                      + flat, mask),)
                ctx = TailCtx(
                    planes,
                    {n: load(r, rows, row_ok)[:, None]
                     for n, r in row_refs.items()},
                    {n: load(r, cols, col_ok)[None, :]
                     for n, r in col_refs.items()},
                    scalars, {},
                    jnp.broadcast_to(rows[:, None].astype(jnp.float32),
                                     (th, tw)),
                    jnp.broadcast_to(cols[None, :].astype(jnp.float32),
                                     (th, tw)),
                    hr, wr, aspect)
                result = spec.fn(ctx)
                acc = [total + jnp.broadcast_to(
                    jnp.asarray(p, jnp.float32), (th, tw))
                    for total, p in zip(acc, result[:3])]
        pixel = (orow[:, None] * out_width + ocol[None, :]) * 3
        for channel, total in enumerate(acc):
            value = jnp.clip(total / float(s * s), 0.0, 1.0)
            quantized = jnp.floor(value * 255.0 + 0.5).astype(jnp.int32)
            pltriton.store(out_ref.at[pixel + channel],
                           quantized.astype(jnp.uint8), mask=mask)

    frame = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((out_height * out_width * 3,),
                                       jnp.uint8),
        grid=(pl.cdiv(out_height, th), pl.cdiv(out_width, tw)),
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps or TAIL_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="tail_final",
    )(*operands)
    return frame.reshape(out_height, out_width, 3)


def _use_kernel() -> bool:
    """The tail kernel is compiled for the GPU only."""
    return jax.default_backend() == "gpu"


def run_tail_final(spec: TailSpec, render_height: int, render_width: int,
                   out_height: int, out_width: int, subsample: int,
                   aspect: float) -> Array:
    """Tail + SSAA downsample + u8 quantize -> (out_h, out_w, 3) uint8.

    The exact-pooling regime (render == output * subsample) runs the tail
    kernel on the GPU. Elsewhere the tail is evaluated on full-resolution
    arrays and handed to final_pass."""
    from shaderflow_tpu.ops.downsample import final_pass
    s = int(subsample)
    with jax.named_scope("tail_final"):
        if (_use_kernel() and s > 1 and not spec.tables
                and render_height == out_height * s
                and render_width == out_width * s):
            return tail_final_kernel(spec, render_height, render_width,
                                     out_height, out_width, s, aspect)
        rgb = eval_reference(spec, render_height, render_width, aspect)
        return final_pass(rgb, out_height, out_width, s)
