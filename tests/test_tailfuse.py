"""Tail stage (ops/tailfuse.py): input classification, the ColSampled
column resample (gather form pinned to the dense hat-weight form), Indexed
and Table inputs, and the tail + final pass."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from shaderflow_tpu.ops import tailfuse
from shaderflow_tpu.ops.downsample import final_pass


def _make_spec(render_h, render_w):
    rng = np.random.default_rng(7)
    color = jnp.asarray(rng.random((render_h, render_w, 3), np.float32))
    gain = jnp.asarray(rng.random((render_h, render_w), np.float32))
    rowv = jnp.asarray(np.linspace(0.0, 1.0, render_h, dtype=np.float32))
    colv = jnp.asarray(np.linspace(-1.0, 1.0, render_w, dtype=np.float32))
    vol = jnp.float32(0.37)

    def tail(tp):
        r, g, b = tp.vec3("color")
        k = tp.plane("gain")
        y = tp.row("rowv")
        x = tp.col("colv")
        v = tp.scalar("vol")
        vig = tp.astuv_x * (1.0 - tp.astuv_y) + 0.5
        mask = (tp.gluv_x * tp.gluv_x + tp.gluv_y * tp.gluv_y) < 1.0
        r = jnp.where(mask, r * k + v, r) * vig
        g = jnp.where(mask, g + y, g * 0.5) * vig
        b = (b + x * 0.1) * (1.0 + v) * vig
        return r, g, b

    return tailfuse.make_spec(
        tail, render_h, render_w,
        color=color, gain=gain,
        rowv=tailfuse.Row(rowv), colv=tailfuse.Col(colv), vol=vol)


def test_make_spec_classification():
    spec = _make_spec(16, 32)
    assert set(spec.planes) == {"color", "gain"}
    assert len(spec.planes["color"]) == 3
    assert set(spec.rows) == {"rowv"}
    assert set(spec.cols) == {"colv"}
    assert set(spec.scalars) == {"vol"}


def test_ambiguous_1d_rejected():
    with pytest.raises(ValueError, match="Ambiguous"):
        tailfuse.make_spec(lambda tp: None, 32, 32, x=jnp.zeros(32))


def test_run_tail_final_fallback_on_cpu():
    """run_tail_final is the tail on full-resolution arrays followed by the
    SSAA final pass."""
    out_h, out_w, s = 24, 64, 2
    spec = _make_spec(out_h * s, out_w * s)
    out = tailfuse.run_tail_final(spec, out_h * s, out_w * s, out_h, out_w, s, 1.0)
    rgb = tailfuse.eval_reference(spec, out_h * s, out_w * s, 1.0)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(final_pass(rgb, out_h, out_w, s)))


def test_atan2_nonfinite_matches_ieee():
    """Poly atan2 must match IEEE arctan2 on infinities: escaped-fractal z
    planes contain +-inf (the tetration golden regressed 42 dB when
    inf/inf produced NaN -> black pixels instead of pi/4 hues)."""
    inf = np.float32(np.inf)
    # (0, -0.0) is deliberately absent: the poly treats -0.0 as +0.0
    # (returns 0, IEEE says pi) — a documented deviation to keep the hot
    # kernel free of a signbit divide.
    ys = np.array([inf, inf, -inf, -inf, 1.0, -1.0, inf, -inf, 0.0,
                   5.0, 5.0], np.float32)
    xs = np.array([inf, -inf, inf, -inf, inf, inf, 1.0, 1.0, 0.0,
                   5.0, -5.0], np.float32)
    got = np.asarray(tailfuse.atan2(jnp.asarray(ys), jnp.asarray(xs)))
    want = np.arctan2(ys, xs)
    assert np.allclose(got, want, atol=2e-5), (got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("w_in,u_range", [
    (640, (0.2, 0.45)),      # zoom in: ~0.2 texels per output pixel
    (1920, (0.02, 0.98)),    # ~1 texel per output pixel, as the Visualizer
    (300, (0.0, 1.0)),       # whole range, clamped at both edges
])
def test_colsample_gather_matches_dense(dtype, w_in, u_range):
    """The two ColSampled forms agree: f32 planes to float rounding, bf16
    planes within one u8 step after quantization (the dense form rounds
    its hat weights to bf16, the gather form lerps in f32)."""
    from shaderflow_tpu.ops.downsample import quantize_u8
    rng = np.random.default_rng(5)
    out_w = 512
    plane = jnp.asarray(rng.random((24, w_in), np.float32)).astype(dtype)
    u = jnp.asarray(np.linspace(*u_range, out_w, dtype=np.float32))
    positions = jnp.clip(u * w_in - 0.5, 0.0, float(w_in - 1))
    dense = tailfuse.colsample_dense(plane, positions)
    gather = tailfuse.colsample_gather(plane, positions)
    assert dense.shape == gather.shape == (24, out_w)
    assert dense.dtype == gather.dtype == jnp.float32
    if dtype == jnp.float32:
        np.testing.assert_allclose(np.asarray(gather), np.asarray(dense),
                                   atol=2e-6)
    else:
        a = np.asarray(quantize_u8(gather)).astype(np.int16)
        b = np.asarray(quantize_u8(dense)).astype(np.int16)
        assert np.abs(a - b).max() <= 1


def test_colsampled_input_resamples_columns():
    """A ColSampled input reaches the tail as the column resample of its
    row-sampled planes at the u line (u * W_in - 0.5 texel convention)."""
    render_h, render_w, w_in = 16, 64, 40
    rng = np.random.default_rng(11)
    planes = tuple(jnp.asarray(rng.random((render_h, w_in), np.float32))
                   for _ in range(3))
    u_line = jnp.asarray(np.linspace(0.1, 0.9, render_w, dtype=np.float32))
    spec = tailfuse.make_spec(
        lambda tp: tp.vec3("tex"), render_h, render_w,
        tex=tailfuse.ColSampled(planes, u_line, texels_per_px=1.0))
    assert set(spec.colsampled) == {"tex"}
    rgb = np.asarray(tailfuse.eval_reference(spec, render_h, render_w, 1.0))
    positions = np.clip(np.asarray(u_line) * w_in - 0.5, 0, w_in - 1)
    for channel, plane in enumerate(planes):
        plane = np.asarray(plane)
        expected = np.stack([np.interp(positions, np.arange(w_in), row)
                             for row in plane])
        np.testing.assert_allclose(rgb[..., channel], expected, atol=1e-5)


@pytest.mark.parametrize("index", [0, 3, 4, 9])   # 9 exercises the clip
def test_indexed_stack_selects_plane(index):
    """Indexed inputs: the tail sees stack[clip(index)]."""
    render_h, render_w = 8, 32
    rng = np.random.default_rng(21)
    stack = jnp.asarray(rng.random((5, render_h, render_w), np.float32))

    def tail(tp):
        (v,) = tp.vec("sel")
        return v, 1.0 - v, v * 0.5

    spec = tailfuse.make_spec(tail, render_h, render_w,
                              sel=tailfuse.Indexed(stack, jnp.int32(index)))
    assert "sel" in spec.indexed
    rgb = np.asarray(tailfuse.eval_reference(spec, render_h, render_w, 1.0))
    plane = np.asarray(stack)[min(index, 4)]
    np.testing.assert_array_equal(rgb[..., 0], plane)
    np.testing.assert_allclose(rgb[..., 1], 1.0 - plane, atol=1e-7)


def test_table_lookup_nearest_clipped():
    """tp.lookup: nearest bin, index rounded down and clipped to the table."""
    table = np.array([[0.1, 1.0], [0.2, 2.0], [0.3, 3.0]], np.float32)
    index = jnp.asarray(np.array([[-1.0, 0.0, 0.9, 1.5, 2.2, 7.0]],
                                 np.float32))

    def tail(tp):
        lookup = tp.lookup("tab", index, channel=1)
        return lookup, lookup, lookup

    spec = tailfuse.make_spec(tail, 1, 6, tab=tailfuse.Table(table))
    rgb = np.asarray(tailfuse.eval_reference(spec, 1, 6, 1.0))
    np.testing.assert_allclose(rgb[0, :, 0], [1.0, 1.0, 1.0, 2.0, 3.0, 3.0])


@pytest.mark.parametrize("subsample", [1, 2, 3])
def test_run_tail_final_shape_and_dtype(subsample):
    out_h, out_w = 10, 24
    spec = _make_spec(out_h * subsample, out_w * subsample)
    out = tailfuse.run_tail_final(spec, out_h * subsample, out_w * subsample,
                                  out_h, out_w, subsample, out_w / out_h)
    assert out.shape == (out_h, out_w, 3)
    assert out.dtype == jnp.uint8


def test_powf_glsl_semantics():
    x = jnp.asarray([0.0, 0.25, 1.0, 4.0], jnp.float32)
    got = np.asarray(tailfuse.powf(x, 0.5))
    np.testing.assert_allclose(got, [0.0, 0.5, 1.0, 2.0], rtol=1e-6)


# ---------------------------------------------------------------------------- #
# The tail kernel (Pallas, Triton route) in interpret mode

def _smooth_spec(render_h, render_w, w_in=40):
    """Every input kind the kernel takes, smooth math only (no hard edges
    whose side a rounding difference could flip)."""
    rng = np.random.default_rng(9)
    planes = tuple(jnp.asarray(rng.random((render_h, w_in), np.float32))
                   .astype(jnp.bfloat16) for _ in range(3))
    stack = jnp.asarray(rng.random((4, render_h, render_w), np.float32))
    gain = jnp.asarray(rng.random((render_h, render_w), np.float32))

    def tail(tp):
        r, g, b = tp.vec3("tex")
        (sel,) = tp.vec("sel")
        glow = jnp.exp(-2.0 * (tp.gluv_x ** 2 + tp.gluv_y ** 2))
        return (r * sel + tp.scalar("k") * glow,
                jnp.sqrt(g * tp.row("v") + 1e-3) * tp.plane("gain"),
                b * tp.col("u"))

    return tailfuse.make_spec(
        tail, render_h, render_w,
        tex=tailfuse.ColSampled(planes, jnp.linspace(0.05, 0.95, render_w),
                                texels_per_px=1.0),
        sel=tailfuse.Indexed(stack, jnp.int32(2)), gain=gain,
        k=jnp.float32(0.25), u=tailfuse.Col(jnp.linspace(0, 1, render_w)),
        v=tailfuse.Row(jnp.linspace(1, 0, render_h)))


@pytest.mark.parametrize("make,out_h,out_w,s,block", [
    (_make_spec, 12, 40, 2, (8, 16)),     # planes, rows, cols, scalars
    (_make_spec, 7, 33, 2, (8, 16)),      # edge blocks hang past the frame
    (_smooth_spec, 9, 24, 2, (4, 16)),    # ColSampled + Indexed
    (_smooth_spec, 5, 20, 3, (8, 32)),    # ssaa=3
])
def test_tail_kernel_interpret_matches_plain(make, out_h, out_w, s, block):
    """The kernel's tail + pool + quantize equals eval_reference +
    final_pass in the exact-pooling regime."""
    render_h, render_w = out_h * s, out_w * s
    spec = make(render_h, render_w)
    aspect = out_w / out_h
    plain = np.asarray(final_pass(tailfuse.eval_reference(
        spec, render_h, render_w, aspect), out_h, out_w, s))
    kernel = np.asarray(tailfuse.tail_final_kernel(
        spec, render_h, render_w, out_h, out_w, s, aspect, block=block,
        interpret=True))
    assert kernel.shape == (out_h, out_w, 3) and kernel.dtype == np.uint8
    diff = np.abs(kernel.astype(np.int16) - plain.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


@pytest.mark.parametrize("depth,height,width,whole", [
    (128, 3240, 5760, False),   # 1080p ssaa=3 batch stack: past int32
    (64, 4320, 7680, True),     # 4K ssaa=2, batch 64: just within
    (65, 4320, 7680, False),    # one frame more: past int32
    (1, 3240, 5760, True),      # a batch-invariant plane
])
def test_indexed_operands_keep_offsets_in_int32(depth, height, width, whole):
    """The kernel gets an Indexed stack whole only while int32 offsets
    reach all of it; otherwise it gets the frame's plane."""
    ix = tailfuse.Indexed(
        jax.ShapeDtypeStruct((depth, height, width), jnp.bfloat16),
        jax.ShapeDtypeStruct((), jnp.int32))
    flat, index = jax.eval_shape(tailfuse._indexed_operands, ix)
    assert flat.shape == ((depth if whole else 1) * height * width,)
    assert index.shape == (1,) and index.dtype == jnp.int32


def test_tail_kernel_interpret_reads_plane_of_large_stack(monkeypatch):
    """With the stack past the offset limit, the kernel reads the frame's
    plane alone and still equals the plain tail."""
    out_h, out_w, s = 9, 24, 2
    render_h, render_w = out_h * s, out_w * s
    monkeypatch.setattr(tailfuse, "MAX_FLAT_OFFSET", render_h * render_w)
    spec = _smooth_spec(render_h, render_w)
    aspect = out_w / out_h
    plain = np.asarray(final_pass(tailfuse.eval_reference(
        spec, render_h, render_w, aspect), out_h, out_w, s))
    kernel = np.asarray(tailfuse.tail_final_kernel(
        spec, render_h, render_w, out_h, out_w, s, aspect, block=(4, 16),
        interpret=True))
    diff = np.abs(kernel.astype(np.int16) - plain.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


@pytest.mark.parametrize("scene", ["Visualizer", "Mandelbrot"])
def test_scene_tail_kernel_interpret_matches_plain(monkeypatch, scene):
    """Through the engine: a scene's frames with the tail kernel (interpret
    mode) equal its frames with the plain tail."""
    import functools
    import sys
    from pathlib import Path
    repo = Path(__file__).parent.parent
    for sub in ("examples", "examples/basic", "examples/fractals"):
        sys.path.insert(0, str(repo / sub))
    import demo
    import fractals
    cls = {"Visualizer": demo.Visualizer, "Mandelbrot": fractals.Mandelbrot}[scene]
    monkeypatch.setattr(tailfuse, "tail_final_kernel", functools.partial(
        tailfuse.tail_final_kernel, interpret=True, block=(8, 32)))

    def render(kernel):
        monkeypatch.setattr(tailfuse, "_use_kernel", lambda: kernel)
        instance = cls()
        instance._setup_run(width=128, height=72, fps=10, time=0.2,
                            ssaa=2.0, freewheel=True)
        instance.engine.begin_batch()
        for _ in range(2):
            instance.next(dt=instance.frametime)
        return np.asarray(instance.engine.flush(2))

    diff = np.abs(render(True).astype(np.int16)
                  - render(False).astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


@pytest.mark.parametrize("case,expected", [
    ("exact", True),          # render == output * 2: the kernel
    ("equal_res", False),     # ssaa=1 subsample=2: the 3-tap stencil
    ("no_pooling", False),    # subsample 1
    ("table", False),         # Table inputs stay on the plain path
])
def test_run_tail_final_kernel_dispatch(monkeypatch, case, expected):
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        return jnp.zeros((args[3], args[4], 3), jnp.uint8)

    monkeypatch.setattr(tailfuse, "_use_kernel", lambda: True)
    monkeypatch.setattr(tailfuse, "tail_final_kernel", spy)
    out_h, out_w = 8, 16
    s, render_h, render_w = {"exact": (2, 16, 32), "equal_res": (2, 8, 16),
                             "no_pooling": (1, 8, 16),
                             "table": (2, 16, 32)}[case]
    spec = _make_spec(render_h, render_w)
    if case == "table":
        spec = spec._replace(tables={"t": jnp.ones((4, 1))})
    out = tailfuse.run_tail_final(spec, render_h, render_w, out_h, out_w, s,
                                  2.0)
    assert out.shape == (out_h, out_w, 3)
    assert bool(calls) == expected
