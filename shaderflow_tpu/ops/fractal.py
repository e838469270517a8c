"""
Escape-time fractal iteration with per-block early exit.

The divergence problem of iteration-heavy pixels (SURVEY.md §7 "hard
parts"): a fixed-trip masked fori_loop costs max_iter iterations for EVERY
pixel, but escape times are spatially coherent — most blocks of a
Mandelbrot view escape within a few dozen iterations while only blocks on
the set's boundary need the full budget. On a GPU the reference's fragment
shader gets this for free: a warp leaves the loop once all of its pixels
have escaped. The Pallas kernel here (Triton route) does the same per
block: each program runs its own while_loop that stops when no pixel of
its block is alive, so frame cost follows the per-block escape time
instead of the whole frame's slowest pixel.

escape_iterations*() dispatch: the kernel on GPU backends, the equivalent
masked fori_loop (_escape_xla) elsewhere. Both follow the reference GLSL
loop (mandelbrot.frag): check |z| > radius, then z = z^2 + c.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

Array = jax.Array

# Kernel launch shape, chosen by a sweep on an H100 at the Mandelbrot
# scene's 1080p60 ssaa=2 render (PERF.md): a block
# of BLOCK_ROWS x BLOCK_COLS pixels per program, NUM_WARPS warps, and
# UNROLL loop steps per aliveness check.
BLOCK_ROWS = 8
BLOCK_COLS = 32
NUM_WARPS = 2
UNROLL = 4


def _interior_mask(cx: Array, cy: Array) -> Array:
    """Main-cardioid + period-2-bulb membership. Points inside NEVER escape
    (mathematically), so the loop would run to max_iter for them — skipping
    the iteration is exact: q(q + (x - 1/4)) <= y^2/4 (cardioid),
    (x+1)^2 + y^2 <= 1/16 (bulb). Valid only for z0 == c (Mandelbrot)."""
    xq = cx - 0.25
    q = xq * xq + cy * cy
    cardioid = q * (q + xq) <= 0.25 * (cy * cy)
    bulb = (cx + 1.0) * (cx + 1.0) + cy * cy <= 0.0625
    return cardioid | bulb


def _trip(max_iter: int, saturate) -> int:
    return int(max_iter) if saturate is None else min(int(max_iter),
                                                      int(saturate))


def _escape_xla(zx0: Array, zy0: Array, cx: Array, cy: Array,
                max_iter: int, radius: float, interior: Array = None,
                saturate: int = None, out_dtype=jnp.int32) -> Array:
    """The plain reference: a fixed-trip masked fori_loop over the frame."""
    r2 = radius * radius
    trip = _trip(max_iter, saturate)

    def body(_, state):
        zx, zy, iters, escaped = state
        nx = zx * zx - zy * zy + cx
        ny = 2.0 * zx * zy + cy
        active = ~escaped
        zx = jnp.where(active, nx, zx)
        zy = jnp.where(active, ny, zy)
        escaped = escaped | (zx * zx + zy * zy > r2)
        return zx, zy, iters + active.astype(jnp.int32), escaped

    iters = jnp.zeros(zx0.shape, jnp.int32)
    escaped = zx0 * zx0 + zy0 * zy0 > r2
    if interior is not None:
        escaped = escaped | interior
    _, _, iters, _ = jax.lax.fori_loop(0, trip, body, (zx0, zy0, iters, escaped))
    if interior is not None:
        iters = jnp.where(interior, max_iter, iters)
    return iters.astype(out_dtype)


def _escape_kernel(zx0: Array, zy0: Array, cx: Array, cy: Array,
                   max_iter: int, radius: float, *, lines: bool = False,
                   interior: bool = False, saturate: int = None,
                   out_dtype=jnp.int32, block=None, num_warps: int = None,
                   unroll: int = None, interpret: bool = False) -> Array:
    """Escape counts by a Pallas kernel on the Triton route.

    Plane form: zx0, zy0, cx, cy are (H, W) f32 planes. Separable form
    (`lines=True`, Mandelbrot with an axis-aligned camera): zx0 is the (W,)
    cx line, zy0 the (H,) cy line, cx/cy are None, and z0 == c is rebuilt
    per block from the two lines. `interior=True` applies the cardioid /
    bulb shortcut (z0 == c only), computed in-kernel.

    Step math and ordering are those of _escape_xla, so counts agree with
    it except where the compilers contract the orbit arithmetic into FMAs
    differently (chaotic boundary pixels, at most one count apart).
    `block`, `num_warps` and `unroll` default to the module constants."""
    if lines:
        height, width = zy0.shape[0], zx0.shape[0]
    else:
        height, width = zx0.shape
    bh, bw = block or (BLOCK_ROWS, BLOCK_COLS)
    num_warps = num_warps or NUM_WARPS
    unroll = unroll or UNROLL
    r2 = float(radius) * float(radius)
    trip = _trip(max_iter, saturate)
    main_end = trip - trip % unroll

    def kernel(*refs):
        out_ref = refs[-1]
        r0 = pl.program_id(0) * bh
        c0 = pl.program_id(1) * bw
        rows = r0 + jnp.arange(bh)
        cols = c0 + jnp.arange(bw)
        row_ok = rows < height
        col_ok = cols < width
        mask = row_ok[:, None] & col_ok[None, :]
        if lines:
            cxl_ref, cyl_ref = refs[:2]
            cx_line = pltriton.load(cxl_ref.at[pl.ds(c0, bw)],
                                    mask=col_ok, other=0.0)
            cy_line = pltriton.load(cyl_ref.at[pl.ds(r0, bh)],
                                    mask=row_ok, other=0.0)
            cx_t = jnp.broadcast_to(cx_line[None, :], (bh, bw))
            cy_t = jnp.broadcast_to(cy_line[:, None], (bh, bw))
            zx, zy = cx_t, cy_t
        else:
            window = (pl.ds(r0, bh), pl.ds(c0, bw))
            zx, zy, cx_t, cy_t = (
                pltriton.load(ref.at[window], mask=mask, other=0.0)
                for ref in refs[:4])

        alive = (zx * zx + zy * zy <= r2) & mask
        if interior:
            inside = _interior_mask(cx_t, cy_t)
            alive = alive & ~inside
        alive = alive.astype(jnp.int32)
        iters = jnp.zeros((bh, bw), jnp.int32)

        def step(state):
            zx, zy, iters, alive = state
            nx = zx * zx - zy * zy + cx_t
            ny = 2.0 * zx * zy + cy_t
            live = alive > 0
            zx = jnp.where(live, nx, zx)
            zy = jnp.where(live, ny, zy)
            iters = iters + alive
            alive = jnp.where(zx * zx + zy * zy > r2, 0, alive)
            return zx, zy, iters, alive

        def cond(state):
            k, _, _, _, alive = state
            return (k < main_end) & (jnp.max(alive) > 0)

        def body(state):
            k, *rest = state
            rest = tuple(rest)
            for _ in range(unroll):
                rest = step(rest)
            return (k + unroll, *rest)

        _, zx, zy, iters, alive = jax.lax.while_loop(
            cond, body, (jnp.int32(0), zx, zy, iters, alive))
        # Remainder steps (trip % unroll), masked like any other step
        state = (zx, zy, iters, alive)
        for _ in range(trip % unroll):
            state = step(state)
        iters = state[2]
        if interior:
            iters = jnp.where(inside, max_iter, iters)
        pltriton.store(out_ref.at[pl.ds(r0, bh), pl.ds(c0, bw)],
                       iters.astype(out_ref.dtype), mask=mask)

    operands = (zx0, zy0) if lines else (zx0, zy0, cx, cy)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((height, width), out_dtype),
        grid=(pl.cdiv(height, bh), pl.cdiv(width, bw)),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="escape_iterations",
    )(*operands)


def _use_kernel() -> bool:
    """The kernel is compiled for the GPU only; elsewhere the plain loop."""
    return jax.default_backend() == "gpu"


def escape_iterations(c: Array, max_iter: int, radius: float = 3.0,
                      saturate: int = None, out_dtype=jnp.int32) -> Array:
    """Mandelbrot escape-time iteration count per pixel for c = (..., 2).

    Semantics match the reference loop (examples/fractals mandelbrot.frag):
    break when |z| > radius, else z = z*z + c, starting from z = c. Pixels
    inside the main cardioid / period-2 bulb are emitted as max_iter without
    iterating (they mathematically never escape); this collapses the
    per-block escape time for every block that overlaps the set's interior.

    `saturate`: optional visual iteration cap. Counts below it are EXACT;
    pixels still alive at `saturate` report `saturate` instead of max_iter.
    Callers whose shading crushes deep counts to one color (e.g. the
    reference's pow(1 - i/q, 20) palette, where every count past ~0.29*q
    lands within half a u8 step of the interior color) pass the cap at
    which their own tail's output becomes quantizer-indistinguishable —
    dead-work elimination, view-independent, bounded by construction.
    Interior-mask pixels still report max_iter exactly.
    """
    cx = jnp.asarray(c[..., 0], jnp.float32)
    cy = jnp.asarray(c[..., 1], jnp.float32)
    if _use_kernel():
        return _escape_kernel(cx, cy, cx, cy, int(max_iter), float(radius),
                              interior=True, saturate=saturate,
                              out_dtype=out_dtype)
    return _escape_xla(cx, cy, cx, cy, int(max_iter), float(radius),
                       interior=_interior_mask(cx, cy), saturate=saturate,
                       out_dtype=out_dtype)


def escape_iterations_sep(cx_line: Array, cy_line: Array, max_iter: int,
                          radius: float = 3.0, saturate: int = None,
                          out_dtype=jnp.int32) -> Array:
    """Mandelbrot escape counts for the SEPARABLE-camera case:
    c[i, j] = (cx_line[j], cy_line[i]) — an axis-aligned (trivial) 2D
    camera's gluv is an outer product of two lines, so the kernel reads two
    lines instead of (H, W) planes. Counts equal escape_iterations on the
    broadcast grid. Fragments gate on the camera's `trivial` static
    uniform; rotation flips it and retraces onto the plane path."""
    cx_line = jnp.asarray(cx_line, jnp.float32)
    cy_line = jnp.asarray(cy_line, jnp.float32)
    if _use_kernel():
        return _escape_kernel(cx_line, cy_line, None, None, int(max_iter),
                              float(radius), lines=True, interior=True,
                              saturate=saturate, out_dtype=out_dtype)
    c = jnp.stack(jnp.broadcast_arrays(cx_line[None, :], cy_line[:, None]),
                  axis=-1)
    return escape_iterations(c, max_iter, radius=radius, saturate=saturate,
                             out_dtype=out_dtype)


def escape_iterations_z0(z0: Array, cx, cy, max_iter: int, radius: float = 3.0,
                         saturate: int = None, out_dtype=jnp.int32) -> Array:
    """General escape iteration: per-pixel z0 (..., 2), c given per-pixel or
    as (traced) scalars — the Julia-set form (no interior shortcut: it is
    only sound when z0 == c)."""
    zx0 = jnp.asarray(z0[..., 0], jnp.float32)
    zy0 = jnp.asarray(z0[..., 1], jnp.float32)
    cx = jnp.broadcast_to(jnp.asarray(cx, jnp.float32), zx0.shape)
    cy = jnp.broadcast_to(jnp.asarray(cy, jnp.float32), zy0.shape)
    escape = _escape_kernel if _use_kernel() else _escape_xla
    return escape(zx0, zy0, cx, cy, int(max_iter), float(radius),
                  saturate=saturate, out_dtype=out_dtype)
