"""
Texture sampling kernels.

Replacement for OpenGL texture units: textures are (H, W, C)
float32 device arrays sampled with gather + lerp. Semantics match GL:
texel centers at (i + 0.5)/N, GL_REPEAT wraps, CLAMP_TO_EDGE clamps,
GL_LINEAR bilinear / GL_NEAREST point sampling. Arrays are stored with
row 0 = top of the image; the GL bottom-left v-origin is folded into the
sampler (v=1 maps to row 0), so all uv math matches the reference GLSL
(/root/reference/shaderflow/resources/shaders/include/shaderflow.glsl:162-208)
without any flipping in user code.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shaderflow_tpu.ops import stdlib as sl

Array = jax.Array


class Sampler2D(NamedTuple):
    """A texture bound for sampling. `data` is traced; the sampling state
    (filter, wrap modes) is static — it selects the compiled code path, the
    same way GL sampler state selects fixed-function hardware behavior."""

    data: Array            # (H, W, C) float32
    linear: bool = True    # GL_LINEAR vs GL_NEAREST
    repeat_x: bool = True  # GL_REPEAT vs CLAMP_TO_EDGE
    repeat_y: bool = True

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def components(self) -> int:
        return self.data.shape[2]

    # Convenience: sampler(uv) samples like GLSL texture(sampler, uv)
    def __call__(self, uv: Array) -> Array:
        return sample(self, uv)


jax.tree_util.register_pytree_node(
    Sampler2D,
    lambda s: ((s.data,), (s.linear, s.repeat_x, s.repeat_y)),
    lambda aux, children: Sampler2D(children[0], *aux),
)


def _wrap(i: Array, n: int, repeat: bool) -> Array:
    if repeat:
        return jnp.mod(i, n)
    return jnp.clip(i, 0, n - 1)


def _gather(data: Array, iy: Array, ix: Array) -> Array:
    """Fetch texels: data (H, W, C), integer index arrays (...,) -> (..., C)."""
    return data[iy, ix]


def sample(tex: Sampler2D, uv: Array) -> Array:
    """Sample at GL texture coordinates uv (..., 2), u right / v up in [0,1].

    Equivalent of GLSL texture(sampler2D, uv); the workhorse behind the
    astexture/stexture/gtexture family (shaderflow.glsl:162-208).
    A MipSampler routes to trilinear mip sampling with automatic LOD, so
    every coordinate-space accessor honors texture(mipmaps=True).
    """
    if isinstance(tex, MipSampler):
        return sample_mip(tex, uv)
    h, w = tex.height, tex.width
    u = uv[..., 0] * w - 0.5
    # v up -> rows top-down: row = (1 - v)*H - 0.5
    v = (1.0 - uv[..., 1]) * h - 0.5

    # Texel fetches go through flat 1D takes on (H*W,) channel planes
    # instead of four two-axis advanced-index gathers: each d[iy, ix]
    # lowers to its own gather + index concatenate + bounds select, ~4-5x
    # the ops of the bilinear math itself (measured on the GLSL
    # visualizer's 80-tap blur: ~217 ops/px/sample -> the flat form is the
    # dominant-term fix). The takes are PER CHANNEL on purpose: one take on
    # the whole (H*W, C) array forces an (N, C) gather result whose
    # layout can pad the minor C (2..4) — a memory blowup that OOMed 4K
    # scenes on the original accelerator. C takes on 1D planes keep clean
    # layouts; texels and
    # per-channel lerp order are unchanged (bit-identical values).
    chans = tex.data.shape[2:]
    planes = ([tex.data.reshape(h * w)] if not chans else
              [tex.data[..., c].reshape(h * w) for c in range(chans[0])])

    def _restack(per_chan):
        return per_chan[0] if not chans else jnp.stack(per_chan, axis=-1)

    if not tex.linear:
        ix = _wrap(jnp.floor(u + 0.5).astype(jnp.int32), w, tex.repeat_x)
        iy = _wrap(jnp.floor(v + 0.5).astype(jnp.int32), h, tex.repeat_y)
        idx = iy * w + ix
        return _restack([jnp.take(p, idx, axis=0, mode="clip")
                         for p in planes])

    x0f = jnp.floor(u)
    y0f = jnp.floor(v)
    fx = u - x0f
    fy = v - y0f
    x0 = _wrap(x0f.astype(jnp.int32), w, tex.repeat_x)
    x1 = _wrap(x0f.astype(jnp.int32) + 1, w, tex.repeat_x)
    y0 = _wrap(y0f.astype(jnp.int32), h, tex.repeat_y)
    y1 = _wrap(y0f.astype(jnp.int32) + 1, h, tex.repeat_y)

    rows0 = y0 * w
    rows1 = y1 * w
    idx = jnp.stack([rows0 + x0, rows0 + x1, rows1 + x0, rows1 + x1])
    out = []
    for p in planes:
        tx = jnp.take(p, idx, axis=0, mode="clip")   # (4, ...)
        top = tx[0] + (tx[1] - tx[0]) * fx
        bottom = tx[2] + (tx[3] - tx[2]) * fx
        out.append(top + (bottom - top) * fy)
    return _restack(out)


# --------------------------------------------------------------------------- #
# Mipmaps — minification anti-aliasing.
#
# Role-equivalent of the reference's mipmaps/anisotropy texture attributes
# (/root/reference/shaderflow/texture.py:82-137), where the GL driver builds
# the pyramid and selects levels from quad derivatives. Here:
# the pyramid is built INSIDE the jitted program (2x2 mean pooling per
# level, a reshape the compiler turns into cheap vector adds; for static
# textures XLA hoists the whole chain out of the frame scan, so it costs
# once per batch), and the level is selected from the uv FIELD's own
# finite-difference derivatives — the per-pixel analogue of GL's implicit
# quad derivatives, available here because samplers always see whole
# coordinate fields rather than single fragments.


class MipSampler(NamedTuple):
    """A texture bound with its mip pyramid. `levels[0]` is the full-
    resolution Sampler2D; each next level halves (floor) both dimensions.
    Calling it samples with automatic LOD from the uv field; pass `lod=`
    for an explicit scalar or per-pixel level.

    `aniso > 1` enables anisotropic filtering (GL_TEXTURE_MAX_ANISOTROPY,
    reference /root/reference/shaderflow/texture.py:110-137): auto-LOD
    sampling takes `aniso` trilinear taps spread along the footprint's
    major axis, with the mip level chosen from the MINOR axis — oblique
    minification stays sharp along the view direction instead of blurring
    isotropically."""

    levels: tuple  # tuple[Sampler2D, ...]
    aniso: int = 1  # static max taps (1 = isotropic trilinear)

    @property
    def base(self) -> "Sampler2D":
        return self.levels[0]

    # Sampler2D-compatible surface (delegates to the full-res level) so a
    # MipSampler flows through texel_fetch and size queries unchanged
    @property
    def data(self) -> Array:
        return self.levels[0].data

    @property
    def height(self) -> int:
        return self.levels[0].height

    @property
    def width(self) -> int:
        return self.levels[0].width

    @property
    def components(self) -> int:
        return self.levels[0].components

    @property
    def linear(self) -> bool:
        return self.levels[0].linear

    @property
    def repeat_x(self) -> bool:
        return self.levels[0].repeat_x

    @property
    def repeat_y(self) -> bool:
        return self.levels[0].repeat_y

    def __call__(self, uv: Array, lod=None) -> Array:
        return sample_mip(self, uv, lod)


jax.tree_util.register_pytree_node(
    MipSampler,
    lambda s: (tuple(s.levels), s.aniso),
    lambda aux, children: MipSampler(tuple(children), aux),
)


def mip_pyramid(tex: Sampler2D, max_levels: int = None,
                anisotropy: int = 1) -> MipSampler:
    """Build the 2x2 box pyramid down to 1x1 (or max_levels). Odd
    dimensions drop the last row/column per level (the GL NPOT floor
    convention)."""
    levels = [tex]
    data = tex.data
    total = 1 + int(np.floor(np.log2(max(tex.height, tex.width, 1))))
    if max_levels is not None:
        total = min(total, int(max_levels))
    for _ in range(1, total):
        h, w, c = data.shape
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        trimmed = data[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
        if h > 1:
            trimmed = trimmed.reshape(nh, 2, -1, c).mean(axis=1).reshape(nh, trimmed.shape[1], c)
        if w > 1:
            trimmed = trimmed.reshape(nh, nw, 2, c).mean(axis=2)
        data = trimmed
        levels.append(Sampler2D(data, tex.linear, tex.repeat_x, tex.repeat_y))
    return MipSampler(tuple(levels), int(max(1, anisotropy)))


def auto_lod(uv: Array, height: int, width: int) -> Array:
    """Per-pixel mip level from the uv field's screen-space derivatives:
    lod = log2(max texel footprint), clamped at 0 (magnification). The uv
    field must be an image-shaped (..., H, W, 2) array — the standard Frag
    coordinate fields are."""
    tx = uv[..., 0] * width
    ty = uv[..., 1] * height
    # Finite differences along the screen axes; edge pixels reuse their
    # neighbor's derivative (GL quads behave the same way).
    def d(a, axis):
        diff = jnp.abs(jnp.diff(a, axis=axis))
        last = jnp.take(diff, jnp.array([diff.shape[axis] - 1]), axis=axis)
        return jnp.concatenate([diff, last], axis=axis)
    footprint = jnp.maximum(
        jnp.maximum(d(tx, -1), d(ty, -1)),   # d/dx
        jnp.maximum(d(tx, -2), d(ty, -2)))   # d/dy
    return jnp.maximum(jnp.log2(jnp.maximum(footprint, 1e-12)), 0.0)


def sample_mip(mip: MipSampler, uv: Array, lod=None) -> Array:
    """Trilinear mipmap sampling (GL LINEAR_MIPMAP_LINEAR).

    lod=None derives the per-pixel level from the uv field (auto_lod);
    a static Python scalar samples exactly two levels; a traced scalar or
    per-pixel field blends every level with hat weights (each level's
    bilinear sample is cheap — the deep levels are tiny — but callers on a
    hot path should prefer a static lod)."""
    levels = mip.levels
    n = len(levels)
    if n == 1:
        return sample(levels[0], uv)
    if lod is None:
        if getattr(mip, "aniso", 1) > 1 and uv.ndim >= 3:
            return sample_mip_aniso(mip, uv)
        lod = auto_lod(uv, levels[0].height, levels[0].width)
    if not hasattr(lod, "shape") and not hasattr(lod, "dtype"):
        # Static scalar: exactly two levels
        lod = float(min(max(lod, 0.0), n - 1))
        k = int(np.floor(lod))
        if k >= n - 1:
            return sample(levels[-1], uv)
        frac = lod - k
        lo = sample(levels[k], uv)
        if frac == 0.0:
            return lo
        hi = sample(levels[k + 1], uv)
        return lo + (hi - lo) * frac
    lod = jnp.clip(lod, 0.0, float(n - 1))
    out = None
    for k, level in enumerate(levels):
        w = jnp.clip(1.0 - jnp.abs(lod - k), 0.0, 1.0)[..., None]
        term = sample(level, uv) * w
        out = term if out is None else out + term
    return out


def sample_mip_aniso(mip: MipSampler, uv: Array, taps: int = None) -> Array:
    """Anisotropic trilinear sampling (GL EXT_texture_filter_anisotropic
    semantics; reference sampler state texture.py:110-137): `taps` bilinear-
    per-level samples spread along the screen footprint's MAJOR axis, LOD
    chosen from the footprint divided by the (clamped) anisotropy ratio —
    sharp along the compressed direction, antialiased along the long one.

    The uv field must be image-shaped (..., H, W, 2) (the standard Frag
    coordinate fields), like auto_lod. Cost: taps x levels bilinear samples
    per pixel — an opt-in quality feature, not a hot-path default."""
    taps = int(taps or mip.aniso)
    levels = mip.levels
    n = len(levels)
    h0, w0 = levels[0].height, levels[0].width
    tx = uv[..., 0] * w0
    ty = uv[..., 1] * h0

    # Signed screen-space derivatives (forward differences; the last pixel
    # reuses its neighbor's — GL quad derivatives behave the same way).
    def d(a, axis):
        diff = jnp.diff(a, axis=axis)
        last = jnp.take(diff, jnp.array([diff.shape[axis] - 1]), axis=axis)
        return jnp.concatenate([diff, last], axis=axis)

    dtx_dx, dty_dx = d(tx, -1), d(ty, -1)
    dtx_dy, dty_dy = d(tx, -2), d(ty, -2)
    len_x = jnp.sqrt(dtx_dx * dtx_dx + dty_dx * dty_dx)
    len_y = jnp.sqrt(dtx_dy * dtx_dy + dty_dy * dty_dy)
    major_is_x = len_x >= len_y
    major = jnp.maximum(len_x, len_y)
    minor = jnp.minimum(len_x, len_y)
    ratio = jnp.clip(major / jnp.maximum(minor, 1e-12), 1.0, float(taps))
    # LOD from the footprint shrunk by the realized anisotropy (GL spec:
    # log2(Pmax / N)); clamp at 0 so magnification stays bilinear-sharp.
    lod = jnp.clip(jnp.maximum(
        jnp.log2(jnp.maximum(major / ratio, 1e-12)), 0.0), 0.0, float(n - 1))
    # Major-axis direction in uv units; taps cover the footprint minus one
    # sample's own width (ratio=1 -> zero spread == plain trilinear). No
    # aniso spread at magnification (major <= 1 texel).
    vx = jnp.where(major_is_x, dtx_dx, dtx_dy) / w0
    vy = jnp.where(major_is_x, dty_dx, dty_dy) / h0
    spread = jnp.where(major > 1.0, 1.0 - 1.0 / ratio, 0.0)

    level_w = [jnp.clip(1.0 - jnp.abs(lod - k), 0.0, 1.0)[..., None]
               for k in range(n)]
    acc = None
    for k in range(taps):
        frac = (k + 0.5) / taps - 0.5
        duv = jnp.stack([vx, vy], axis=-1) * (spread * frac)[..., None]
        tap_uv = uv + duv
        tap = None
        for j, level in enumerate(levels):
            term = sample(level, tap_uv) * level_w[j]
            tap = term if tap is None else tap + term
        acc = tap if acc is None else acc + tap
    return acc / taps


def _interp_matrix(positions: Array, n: int, repeat: bool) -> Array:
    """(M, n) linear-interpolation weight matrix: row m holds the bilinear
    hat weights of continuous texel position positions[m] over the n texels
    (2 nonzeros per row; REPEAT folds weights across the wrap seam). A dense
    matmul with this matrix IS 1D linear texture filtering."""
    texels = jnp.arange(n, dtype=jnp.float32)
    if repeat:
        delta = positions[:, None] - texels[None, :]
        # Wrap distance onto [-n/2, n/2): taps across the seam interpolate
        delta = jnp.mod(delta + n / 2.0, float(n)) - n / 2.0
        return jnp.maximum(1.0 - jnp.abs(delta), 0.0)
    # CLAMP_TO_EDGE: clamping the continuous position to [0, n-1] puts full
    # weight on the edge texel outside the range — identical to clamping the
    # two tap indices
    positions = jnp.clip(positions, 0.0, float(n - 1))
    delta = positions[:, None] - texels[None, :]
    return jnp.maximum(1.0 - jnp.abs(delta), 0.0)


def _separable_lod(mip: "MipSampler", u_line: Array, v_line: Array) -> Array:
    """Scalar LOD for axis-aligned grid sampling: the texel footprint is
    the per-axis line spacing (uniform up to animation), so one traced
    scalar log2(max footprint) stands in for auto_lod's per-pixel field."""
    fu = jnp.max(jnp.abs(jnp.diff(u_line))) * mip.width if u_line.shape[0] > 1 else jnp.float32(0)
    fv = jnp.max(jnp.abs(jnp.diff(v_line))) * mip.height if v_line.shape[0] > 1 else jnp.float32(0)
    foot = jnp.maximum(jnp.maximum(fu, fv), 1e-12)
    return jnp.maximum(jnp.log2(foot), 0.0)


def _reject_mip(tex, who: str):
    if isinstance(tex, MipSampler):
        raise TypeError(
            f"{who} is a single-level fast path: a mipmapped texture would "
            "silently lose minification filtering. Pass sampler.base to "
            "sample level 0 explicitly, or use sample()/sample_separable() "
            "which select mip levels.")


def sample_separable(tex: Sampler2D, u_line: Array, v_line: Array,
                     precision: str = "float32") -> Array:
    """Axis-aligned grid sampling: u varies only along columns, v only along
    rows -> two 1D interpolations instead of H*W*4 pointwise gathers.
    Bit-identical (within matmul rounding) to sample() on the meshgrid of
    (u_line, v_line).

    Linear filtering is expressed as two dense interpolation-matrix matmuls
    (MXU-native — the GEMM-first recipe for resampling on systolic arrays);
    nearest filtering keeps row gathers (exactness over speed).

    precision="bfloat16" runs the matmuls at the MXU's native width (~4x
    faster): the interpolation error stays under ~2^-9 relative — below half
    a uint8 quantization step — which 8-bit video output cannot see.
    """
    if isinstance(tex, MipSampler):
        # Mip-aware routing (reference GL would minify here too): blend the
        # per-level separable samples with hat weights around a traced
        # scalar LOD from the line spacing. Deep levels are tiny, so the
        # cost is ~2x level 0 at most.
        lod = jnp.clip(_separable_lod(tex, u_line, v_line),
                       0.0, float(len(tex.levels) - 1))
        out = None
        for k, level in enumerate(tex.levels):
            wk = jnp.clip(1.0 - jnp.abs(lod - k), 0.0, 1.0)
            term = sample_separable(level, u_line, v_line, precision) * wk
            out = term if out is None else out + term
        return out
    h, w = tex.height, tex.width
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5

    if not tex.linear:
        iy = _wrap(jnp.floor(v + 0.5).astype(jnp.int32), h, tex.repeat_y)
        ix = _wrap(jnp.floor(u + 0.5).astype(jnp.int32), w, tex.repeat_x)
        return tex.data[iy][:, ix]

    w_rows = _interp_matrix(v, h, tex.repeat_y)               # (H', H)
    w_cols = _interp_matrix(u, w, tex.repeat_x)               # (W', W)
    data = tex.data
    if precision == "bfloat16":
        w_rows = w_rows.astype(jnp.bfloat16)
        w_cols = w_cols.astype(jnp.bfloat16)
        data = data.astype(jnp.bfloat16)
    rows = jnp.einsum("oh,hwc->owc", w_rows, data,
                      preferred_element_type=jnp.float32)     # (H', W, C)
    if precision == "bfloat16":
        rows = rows.astype(jnp.bfloat16)
    out = jnp.einsum("pw,owc->opc", w_cols, rows,
                     preferred_element_type=jnp.float32)      # (H', W', C)
    # Keep downstream shader math out of the matmul's fusion (XLA otherwise
    # folds whole shader tails into the dot epilogue and blows scoped VMEM)
    return jax.lax.optimization_barrier(out)


def sample_separable_planes(tex: Sampler2D, u_line: Array, v_line: Array,
                            precision: str = "float32",
                            out_dtype=None) -> tuple:
    """sample_separable, but returning one (H', W') plane PER CHANNEL.

    Feeding a Pallas tail kernel (ops/tailfuse.py) from the channel-last
    (H', W', C) form forces a minor-dim-3 relayout per channel slice, which
    XLA fuses into the sampling dot and blows its scoped VMEM; pure 2D
    matmuls per channel sidestep the 3D layout entirely (and lower to
    cleaner MXU loops than the batched einsum)."""
    _reject_mip(tex, "sample_separable_planes")
    h, w = tex.height, tex.width
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5

    if not tex.linear:
        iy = _wrap(jnp.floor(v + 0.5).astype(jnp.int32), h, tex.repeat_y)
        ix = _wrap(jnp.floor(u + 0.5).astype(jnp.int32), w, tex.repeat_x)
        data = tex.data[iy][:, ix]
        return tuple(data[..., c] for c in range(data.shape[-1]))

    w_rows = _interp_matrix(v, h, tex.repeat_y)               # (H', H)
    w_cols = _interp_matrix(u, w, tex.repeat_x)               # (W', W)
    data = tex.data
    if precision == "bfloat16":
        w_rows = w_rows.astype(jnp.bfloat16)
        w_cols = w_cols.astype(jnp.bfloat16)
        data = data.astype(jnp.bfloat16)
    w_cols_t = w_cols.T                                       # (W, W')
    out_dtype = out_dtype or jnp.float32
    planes = []
    for c in range(data.shape[-1]):
        rows = jnp.dot(w_rows, data[..., c],
                       preferred_element_type=jnp.float32)    # (H', W)
        if precision == "bfloat16":
            rows = rows.astype(jnp.bfloat16)
        plane = jnp.dot(rows, w_cols_t,
                        preferred_element_type=jnp.float32)   # (H', W')
        planes.append(plane.astype(out_dtype))
    return tuple(jax.lax.optimization_barrier(tuple(planes)))


def _blocked_axis(pos: Array, out_len: int, n: int, block: int,
                  in_block: int) -> tuple:
    """Per-block window offsets + tile-local hat-weight matrices for 1D
    linear filtering of monotone-ish positions.

    `pos` is (out_len,) — or (T, out_len) for T tap positions per output
    pixel, whose hat weights are AVERAGED (the separable tap-sum of the
    SSAA box filter, ops/downsample.py).

    Returns (offs (nb,) i32, weights (nb, block, in_block) f32, nb): block b
    of the output interpolates texels [offs[b], offs[b]+in_block) with
    weights[b]. Positions are clipped to [0, n-1] (CLAMP_TO_EDGE; callers
    guarantee no REPEAT seam crossing — see sample_separable_planes)."""
    if pos.ndim == 1:
        pos = pos[None, :]
    taps = pos.shape[0]
    nb = -(-out_len // block)
    pad = nb * block - out_len
    if pad:
        pos = jnp.concatenate([pos, jnp.broadcast_to(pos[:, -1:], (taps, pad))],
                              axis=1)
    pos = jnp.clip(pos, 0.0, float(n - 1))
    blocks = pos.reshape(taps, nb, block)
    offs = jnp.clip(jnp.floor(blocks.min(axis=(0, 2))).astype(jnp.int32) - 1,
                    0, n - in_block)
    texels = jnp.arange(in_block, dtype=jnp.float32)
    delta = (blocks[:, :, :, None]
             - offs[None, :, None, None].astype(jnp.float32) - texels)
    weights = jnp.maximum(1.0 - jnp.abs(delta), 0.0).mean(axis=0)
    return offs, weights, nb


def resample_separable_blocked(data: Array, pos_rows: Array, pos_cols: Array,
                               rows_per_px: float, cols_per_px: float,
                               block: int = 240) -> Array:
    """Banded separable resample of channel-last (H, W, C) data — the
    general-path engine of the SSAA/raw-scale final pass.

    pos_rows (T, Ho) / pos_cols (T, Wo): continuous texel positions per
    output pixel (T >= 1 taps averaged — the factored SSAA box filter).
    rows_per_px / cols_per_px: static upper bounds on |d position / d output
    pixel| INCLUDING the tap spread. The dense interp matrices are band
    matrices of bandwidth ~taps+2 that the dense path multiplies as full
    (Ho, Hr) x (Hr, W) GEMMs — quadratic waste at 4K. Each `block` of output
    rows/cols instead contracts only a dynamic-sliced window of
    ~block*bound texels (the sample_separable_planes_blocked recipe,
    channel-last). CLAMP semantics; bit-identical to the dense band matmul
    up to summation-order ULPs. Falls back to dense einsums when the
    windows would span the whole texture anyway."""
    h, w = data.shape[0], data.shape[1]
    out_h = pos_rows.shape[-1]
    out_w = pos_cols.shape[-1]

    def in_block_for(bound: float, n: int) -> int:
        need = int(math.ceil(block * bound + bound)) + 3
        return min(n, max(64, -(-need // 64) * 64))

    in_rows = in_block_for(rows_per_px, h)
    in_cols = in_block_for(cols_per_px, w)

    if in_rows >= h and in_cols >= w:  # dense is already optimal
        texels_r = jnp.arange(h, dtype=jnp.float32)
        texels_c = jnp.arange(w, dtype=jnp.float32)
        pr = jnp.clip(pos_rows if pos_rows.ndim == 2 else pos_rows[None],
                      0.0, float(h - 1))
        pc = jnp.clip(pos_cols if pos_cols.ndim == 2 else pos_cols[None],
                      0.0, float(w - 1))
        w_rows = jnp.maximum(1.0 - jnp.abs(pr[:, :, None] - texels_r), 0.0).mean(0)
        w_cols = jnp.maximum(1.0 - jnp.abs(pc[:, :, None] - texels_c), 0.0).mean(0)
        rows = jnp.einsum("oh,hwc->owc", w_rows, data,
                          preferred_element_type=jnp.float32)
        return jnp.einsum("pw,owc->opc", w_cols, rows,
                          preferred_element_type=jnp.float32)

    roffs, rweights, nb_r = _blocked_axis(pos_rows, out_h, h, block, in_rows)
    coffs, cweights, nb_c = _blocked_axis(pos_cols, out_w, w, block, in_cols)

    # Stage 1: rows. Each output-row block contracts an (in_rows, W, C) window.
    row_parts = []
    for k in range(nb_r):
        window = jax.lax.dynamic_slice(data, (roffs[k], 0, 0),
                                       (in_rows, w, data.shape[2]))
        row_parts.append(jnp.einsum("bi,iwc->bwc", rweights[k], window,
                                    preferred_element_type=jnp.float32))
    rows = jnp.concatenate(row_parts, axis=0)[:out_h]
    # Stage 2: columns of the row-filtered intermediate.
    col_parts = []
    for k in range(nb_c):
        window = jax.lax.dynamic_slice(rows, (0, coffs[k], 0),
                                       (out_h, in_cols, rows.shape[2]))
        col_parts.append(jnp.einsum("bi,oic->obc", cweights[k], window,
                                    preferred_element_type=jnp.float32))
    return jnp.concatenate(col_parts, axis=1)[:, :out_w]


def sample_separable_planes_blocked(
        tex: Sampler2D, u_line: Array, v_line: Array,
        texels_per_px: tuple, precision: str = "float32",
        out_dtype=None, block: int = 240) -> tuple:
    """sample_separable_planes exploiting the 2-nonzeros-per-row band
    structure of the interpolation matrices.

    The dense separable sampler runs the MXU at ~85% peak but pays ~n/2
    redundant FLOPs per tap (the interp matrix is a bandwidth-2 band it
    treats as dense). Here each `block` of output rows/columns contracts
    only against a small dynamic-sliced texture window sized from the
    caller's bound on |d(texel position)/d(output pixel)| — 10-15x fewer
    FLOPs for the visualizer background (measured 47 -> ~5 ms/batch).

    Contract (caller-guaranteed, in exchange for the speed):
      * positions monotone enough that each output block's taps span
        <= block*texels_per_px texels (true for any affine uv map, the
        separable-sampling precondition anyway);
      * no REPEAT seam interpolation: continuous positions stay inside
        [0, n-1] on a repeat axis (zoom-in backgrounds). Edge weights use
        CLAMP semantics. Violations clamp to the window edge — bounded
        error, never NaN.

    texels_per_px = (du, dv): upper bounds on texels per output pixel along
    u (columns) and v (rows), including any animated zoom's maximum.
    """
    _reject_mip(tex, "sample_separable_planes_blocked")
    h, w = tex.height, tex.width
    du, dv = texels_per_px
    u = u_line * w - 0.5
    v = (1.0 - v_line) * h - 0.5
    out_w = u.shape[0]
    out_h = v.shape[0]

    def in_block_for(bound: float, n: int) -> int:
        need = int(math.ceil(block * bound)) + 3
        return min(n, max(64, -(-need // 64) * 64))

    in_rows = in_block_for(dv, h)
    in_cols = in_block_for(du, w)
    if in_rows >= h and in_cols >= w:
        return sample_separable_planes(tex, u_line, v_line,
                                       precision=precision, out_dtype=out_dtype)

    compute_dtype = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    out_dtype = out_dtype or jnp.float32
    data = tex.data.astype(compute_dtype)

    roffs, rweights, nb_r = _blocked_axis(v, out_h, h, block, in_rows)
    coffs, cweights, nb_c = _blocked_axis(u, out_w, w, block, in_cols)
    rweights = rweights.astype(compute_dtype)
    # Stage 2 contracts (out_h, in_cols) @ (in_cols, block)
    cweights_t = jnp.swapaxes(cweights, 1, 2).astype(compute_dtype)

    planes = []
    for c in range(data.shape[-1]):
        data_c = data[..., c]
        # Stage 1: rows. Each output-row block reads an in_rows-tall window.
        row_parts = []
        for k in range(nb_r):
            window = jax.lax.dynamic_slice(data_c, (roffs[k], 0), (in_rows, w))
            row_parts.append(jnp.dot(rweights[k], window,
                                     preferred_element_type=jnp.float32))
        rows_c = jnp.concatenate(row_parts, axis=0)[:out_h]
        rows_c = rows_c.astype(compute_dtype)
        # Stage 2: columns of the row-interpolated intermediate.
        col_parts = []
        for k in range(nb_c):
            window = jax.lax.dynamic_slice(rows_c, (0, coffs[k]),
                                           (out_h, in_cols))
            col_parts.append(jnp.dot(window, cweights_t[k],
                                     preferred_element_type=jnp.float32))
        plane = jnp.concatenate(col_parts, axis=1)[:, :out_w]
        planes.append(plane.astype(out_dtype))
    return tuple(jax.lax.optimization_barrier(tuple(planes)))


def sample_rows_planes_blocked(
        tex: Sampler2D, v_line: Array, texels_per_px: float,
        precision: str = "float32", out_dtype=None,
        block: int = 240) -> tuple:
    """Stage 1 (row interpolation) of the blocked separable sampler only:
    returns one (out_h, tex_w) plane per channel, row-filtered at v_line but
    NOT column-sampled — the form ops.tailfuse.ColSampled consumes, where
    the final column interpolation happens inside the fused tail kernel.
    Same CLAMP-window contract as sample_separable_planes_blocked."""
    _reject_mip(tex, "sample_rows_planes_blocked")
    h, w = tex.height, tex.width
    v = (1.0 - v_line) * h - 0.5
    out_h = v.shape[0]

    need = int(math.ceil(block * texels_per_px)) + 3
    in_rows = min(h, max(64, -(-need // 64) * 64))
    compute_dtype = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    out_dtype = out_dtype or jnp.float32
    data = tex.data.astype(compute_dtype)

    if in_rows >= h:
        w_rows = _interp_matrix(v, h, tex.repeat_y).astype(compute_dtype)
        return tuple(jax.lax.optimization_barrier(tuple(
            jnp.dot(w_rows, data[..., c],
                    preferred_element_type=jnp.float32).astype(out_dtype)
            for c in range(data.shape[-1]))))

    roffs, rweights, nb_r = _blocked_axis(v, out_h, h, block, in_rows)
    rweights = rweights.astype(compute_dtype)
    planes = []
    for c in range(data.shape[-1]):
        data_c = data[..., c]
        parts = []
        for k in range(nb_r):
            window = jax.lax.dynamic_slice(data_c, (roffs[k], 0), (in_rows, w))
            parts.append(jnp.dot(rweights[k], window,
                                 preferred_element_type=jnp.float32))
        planes.append(jnp.concatenate(parts, axis=0)[:out_h].astype(out_dtype))
    return tuple(jax.lax.optimization_barrier(tuple(planes)))


def splat_kernel(offsets: Array, size: int, weights: Array = None) -> Array:
    """Build a tap kernel from N continuous offsets by bilinear splatting:
    K = sum_j hat(x - dx_j) (x) hat(y - dy_j). Sampling a texture at p + d_j
    for all j and summing is EXACTLY applying this kernel around p then
    sampling once at p (bilinear interpolation is linear in the texture).

    Offsets are (N, 2) as (dx, dy) in ARRAY texel units: x right, y DOWN
    (callers flip v-space offsets). `size` must be odd and
    >= 2*ceil(max|offset|) + 3.
    """
    half = size // 2
    grid = jnp.arange(-half, half + 1, dtype=jnp.float32)
    dx = offsets[:, 0:1]                              # (N, 1)
    dy = offsets[:, 1:2]
    hat_x = jnp.maximum(1.0 - jnp.abs(grid[None, :] - dx), 0.0)   # (N, size)
    hat_y = jnp.maximum(1.0 - jnp.abs(grid[None, :] - dy), 0.0)
    if weights is not None:
        hat_x = hat_x * jnp.asarray(weights, jnp.float32)[:, None]
    return jnp.einsum("ny,nx->yx", hat_y, hat_x)      # (size, size)


def convolve2d(image: Array, kernel: Array) -> Array:
    """Depthwise tap application: out[y, x] = sum_{dy,dx}
    kernel[h2+dy, w2+dx] * image[y+dy, x+dx] (zero padding at edges).
    This is cross-correlation — exactly the splat_kernel orientation.

    Implemented as static shift-and-add over the padded image: XLA fuses the
    taps into one elementwise loop (lax.conv with a single feature channel
    is the wrong tool for image-space taps).
    """
    h, w, c = image.shape
    kh, kw = kernel.shape
    h2, w2 = kh // 2, kw // 2
    padded = jnp.pad(image, ((h2, h2), (w2, w2), (0, 0)))
    out = jnp.zeros_like(image)
    for dy in range(kh):
        for dx in range(kw):
            out = out + padded[dy:dy + h, dx:dx + w] * kernel[dy, dx]
    return out


def lookup_nearest_1d(tex: Sampler2D, v_field: Array, mode: str = "onehot",
                      precision: str = "float32") -> Array:
    """Per-pixel NEAREST lookup along a texture's v axis (u fixed at the
    first column) for a small table texture — the radial-spectrogram access
    pattern.

    The default "onehot" mode contracts a bf16 one-hot against the table
    as a matmul (table values
    round to bf16, ~2^-8 relative — invisible at 8 bits); "select" unrolls
    a select-accumulate chain (exact, but measured to fuse worse inside
    large shader graphs — kept for small-graph uses)."""
    h = tex.height
    # v up -> row index (same as sample() nearest path)
    rows = jnp.floor((1.0 - v_field) * h).astype(jnp.int32)
    rows = jnp.clip(rows, 0, h - 1) if not tex.repeat_y else jnp.mod(rows, h)
    table = tex.data[:, 0, :]                           # (H, C)
    bins, channels = table.shape

    if mode == "select":
        # Barrier sandwich: isolated, the select chain fuses into a single
        # VPU pass; embedded in a large shader graph XLA splits it into
        # dozens of full-field kernels
        rows, table = jax.lax.optimization_barrier((rows, table))
        acc = jnp.zeros(v_field.shape + (channels,), jnp.float32)
        for b in range(bins):
            acc = acc + jnp.where((rows == b)[..., None], table[b], 0.0)
        return jax.lax.optimization_barrier(acc)

    # precision="bfloat16" also emits the RESULT in bf16 (half the HBM write
    # traffic of this full-field pass); the rounding is the same 2^-8 order
    # the bf16 table already accepts. Consumers upcast on first use.
    out_dtype = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    onehot = (rows[..., None] == jnp.arange(bins)).astype(jnp.bfloat16)
    return jnp.einsum("...b,bc->...c", onehot, table.astype(jnp.bfloat16),
                      preferred_element_type=out_dtype)


def lookup_nearest_1d_planes(tex: Sampler2D, v_field: Array,
                             precision: str = "bfloat16") -> tuple:
    """lookup_nearest_1d, one 2D plane per channel (matvec per channel keeps
    every array 2D — see sample_separable_planes for why that matters when
    the consumer is a Pallas tail kernel)."""
    h = tex.height
    rows = jnp.floor((1.0 - v_field) * h).astype(jnp.int32)
    rows = jnp.clip(rows, 0, h - 1) if not tex.repeat_y else jnp.mod(rows, h)
    table = tex.data[:, 0, :]                           # (H, C)
    bins, channels = table.shape
    out_dtype = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    onehot = (rows[..., None] == jnp.arange(bins)).astype(jnp.bfloat16)
    planes = tuple(
        jnp.einsum("...b,b->...", onehot, table[:, c].astype(jnp.bfloat16),
                   preferred_element_type=out_dtype)
        for c in range(channels))
    return tuple(jax.lax.optimization_barrier(planes))


def lookup_nearest_1d_select(tex: Sampler2D, v_field: Array,
                             channel_where: Array = None, channel: int = 0,
                             chunk: int = 16, out_dtype=None) -> Array:
    """Two-level per-pixel NEAREST table lookup returning ONE (H, W) plane.

    The one-hot matmul of lookup_nearest_1d pays bins compares per pixel per
    channel to build the one-hot — the dominant cost (the MXU contraction is
    nearly free). This variant: (1) folds the per-pixel CHANNEL selection
    (channel_where: True -> channel 0, False -> channel 1) into the low bits
    of a flattened (bins*C,) table, and (2) splits the index into hi/lo
    levels — a one-hot over ceil(bins*C/chunk) hi-groups (an MXU matmul
    against the (groups, chunk) reshaped table) plus `chunk` select-adds for
    the lo bits. Compares per pixel drop ~chunk-fold; the radial-bar lookup
    measured 74 -> ~25 ms/batch at 4K.
    """
    h = tex.height
    rows = jnp.floor((1.0 - v_field) * h).astype(jnp.int32)
    rows = jnp.clip(rows, 0, h - 1) if not tex.repeat_y else jnp.mod(rows, h)
    table = tex.data[:, 0, :]                           # (bins, C)
    bins, channels = table.shape

    if channel_where is not None:
        flat_index = rows * channels + jnp.where(channel_where, 0, 1)
    else:
        flat_index = rows * channels + channel
    n = bins * channels
    groups = -(-n // chunk)
    flat_table = jnp.pad(table.reshape(-1), (0, groups * chunk - n))

    hi = flat_index // chunk
    lo = flat_index - hi * chunk
    # All arithmetic in bf16: hi < groups and lo < chunk are small integers
    # (exact in bf16), and every sum below has exactly ONE nonzero term (the
    # one-hots), so bf16 selects bf16 table values with NO extra rounding —
    # while the VPU runs the compare/mul/add chain at 2x f32 throughput.
    # (XLA lowers these tiny-K contractions as elementwise fusions, not MXU
    # dots, so vector throughput is the whole cost.)
    hi16 = hi.astype(jnp.bfloat16)
    lo16 = lo.astype(jnp.bfloat16)
    onehot = (hi16[..., None] == jnp.arange(groups, dtype=jnp.bfloat16)
              ).astype(jnp.bfloat16)
    chunks = jnp.einsum("...h,hk->...k", onehot,
                        flat_table.reshape(groups, chunk).astype(jnp.bfloat16),
                        preferred_element_type=jnp.bfloat16)  # (..., chunk)
    # Lo-level as multiply+minor-dim reduce (one dot-epilogue fusion; per-k
    # minor slices instead force the (..., chunk) intermediate into HBM).
    # out_dtype=bf16 writes half the bytes of this full-field pass (values
    # already round-tripped a bf16 table).
    onehot_lo = (lo16[..., None] == jnp.arange(chunk, dtype=jnp.bfloat16)
                 ).astype(jnp.bfloat16)
    out = jnp.sum(chunks * onehot_lo, axis=-1)
    if out_dtype is None or out.dtype != out_dtype:
        out = out.astype(out_dtype or jnp.float32)
    return jax.lax.optimization_barrier(out)


def lookup_nearest_1d_select_batched(
        tables: Array, v_field: Array, channel_where: Array = None,
        channel: int = 0, repeat_y: bool = False, out_dtype=None) -> Array:
    """Batched form of lookup_nearest_1d_select: expand per-frame tables
    over ONE static index field -> (B, H, W).

    When the index field is frame-invariant (the radial-bar angle map) and
    only the tiny (bins, C) table changes per frame, the whole batch is one
    gather from the (B, bins*C) tables OUTSIDE the render scan. Run it from
    a scene batch_preludes hook (engine.PreludeCtx).

    tables: (B, bins, C); v_field (H, W); channel_where as in the per-frame
    variant (True -> channel 0). Values round through bf16 (same as the
    per-frame path's bf16 table).
    """
    batch, bins, channels = tables.shape
    height, width = v_field.shape
    rows = jnp.floor((1.0 - v_field) * bins).astype(jnp.int32)
    rows = jnp.mod(rows, bins) if repeat_y else jnp.clip(rows, 0, bins - 1)
    if channel_where is not None:
        flat_index = rows * channels + jnp.where(
            jnp.broadcast_to(channel_where, rows.shape), 0, 1)
    else:
        flat_index = rows * channels + channel
    n = bins * channels
    flat_tables = tables.reshape(batch, n)
    out_dtype = out_dtype or jnp.float32

    # Exact gather; values round through bf16 so the batched and per-frame
    # select variants agree
    flat16 = flat_tables.astype(jnp.bfloat16)
    out = jnp.take(flat16, flat_index.reshape(-1), axis=1)
    return out.reshape(batch, height, width).astype(out_dtype)


def texel_fetch(tex: Sampler2D, xy: Array) -> Array:
    """GLSL texelFetch: integer texel coordinates, x right / y up from the
    bottom-left (GL convention), no filtering, zero outside bounds."""
    h, w = tex.height, tex.width
    x = xy[..., 0]
    y_row = (h - 1) - xy[..., 1]
    inside = (x >= 0) & (x < w) & (xy[..., 1] >= 0) & (xy[..., 1] < h)
    x = jnp.clip(x, 0, w - 1)
    y_row = jnp.clip(y_row, 0, h - 1)
    flat = tex.data.reshape(h * w, *tex.data.shape[2:])
    texels = jnp.take(flat, y_row * w + x, axis=0, mode="clip")
    return jnp.where(inside[..., None], texels, 0.0)


# --------------------------------------------------------------------------- #
# GLSL-style coordinate-space texture accessors (shaderflow.glsl:165-208).
# These take explicit scene aspect where the GLSL reads the iAspectRatio
# uniform; the Frag context binds them.

def astexture(tex: Sampler2D, astuv: Array) -> Array:
    return sample(tex, astuv)


def gtexture(tex: Sampler2D, gluv: Array, mirror: bool = False) -> Array:
    if mirror:
        return gmtexture(tex, gluv)
    scale = sl.vec2(tex.height / tex.width, 1.0)
    return sample(tex, sl.gluv2stuv(gluv * scale))


def gmtexture(tex: Sampler2D, gluv: Array, want_aspect: float = 1.0) -> Array:
    return gtexture(tex, sl.gluv_mirrored_repeat(gluv, want_aspect))


def agtexture(tex: Sampler2D, agluv: Array, aspect: float, mirror: bool = False) -> Array:
    if mirror:
        return agtexture(tex, sl.agluv_mirrored_repeat(agluv), aspect)
    return gtexture(tex, sl.agluv2gluv(agluv, aspect))


def stexture(tex: Sampler2D, stuv: Array) -> Array:
    return gtexture(tex, sl.stuv2gluv(stuv))
