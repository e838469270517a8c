"""Escape-time iteration: kernel/XLA parity and reference semantics.

The Pallas kernel (Triton route) runs here in interpret mode; the compiled
kernel is checked on the card by tests/test_gpu.py and chip_smoke.py."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from shaderflow_tpu.ops import fractal
from shaderflow_tpu.ops.fractal import (
    _escape_kernel, _escape_xla, _interior_mask, escape_iterations,
    escape_iterations_sep, escape_iterations_z0)


def grid(h=64, w=128):
    x = np.linspace(-2.2, 0.8, w, dtype=np.float32)
    y = np.linspace(-1.2, 1.2, h, dtype=np.float32)
    cx, cy = np.meshgrid(x, y)
    return jnp.asarray(cx), jnp.asarray(cy)


def lines(h=64, w=128):
    cx_line = jnp.asarray(np.linspace(-2.2, 1.0, w, dtype=np.float32))
    cy_line = jnp.asarray(np.linspace(-1.3, 1.3, h, dtype=np.float32))
    cx = jnp.broadcast_to(cx_line[None, :], (h, w))
    cy = jnp.broadcast_to(cy_line[:, None], (h, w))
    return cx_line, cy_line, cx, cy


kernel = functools.partial(_escape_kernel, interpret=True)


def test_known_points():
    c = jnp.array([[[0.0, 0.0]], [[3.0, 3.0]]])  # interior / instant escape
    iters = np.asarray(escape_iterations(c, 50))
    assert iters[0, 0] == 50   # interior: never escapes
    assert iters[1, 0] == 0    # |c| > 3 at start


def test_pallas_interpret_matches_xla():
    cx, cy = grid()
    expected = np.asarray(_escape_xla(cx, cy, cx, cy, 100, 3.0))
    got = np.asarray(kernel(cx, cy, cx, cy, 100, 3.0, block=(32, 64)))
    np.testing.assert_array_equal(got, expected)


def test_julia_form_scalar_c():
    cx, cy = grid(16, 32)
    z0 = jnp.stack([cx, cy], axis=-1)
    iters = np.asarray(escape_iterations_z0(z0, -0.8, 0.156, 60))
    assert iters.shape == (16, 32)
    assert iters.min() >= 0 and iters.max() <= 60
    assert iters.std() > 0  # structured escape field


def test_saturate_exact_below_cap_clamped_above():
    cx, cy = grid()
    full = np.asarray(_escape_xla(cx, cy, cx, cy, 200, 3.0))
    capped = np.asarray(_escape_xla(cx, cy, cx, cy, 200, 3.0, saturate=57))
    np.testing.assert_array_equal(capped, np.minimum(full, 57))


def test_pallas_saturate_monotone_matches_xla():
    """Saturation cap (not a multiple of the unroll, so the remainder steps
    run) plus the in-kernel interior shortcut must stay bit-identical to
    the plain XLA loop."""
    cx, cy = grid()
    expected = np.asarray(_escape_xla(
        cx, cy, cx, cy, 100, 3.0, interior=_interior_mask(cx, cy),
        saturate=57))
    got = np.asarray(kernel(cx, cy, cx, cy, 100, 3.0, block=(32, 64),
                            unroll=8, interior=True, saturate=57))
    np.testing.assert_array_equal(got, expected)


def test_kernel_julia_form_matches_xla():
    """Julia form (z0 = pixel, constant c, no interior shortcut)."""
    cx, cy = grid()
    ccx = jnp.full_like(cx, -0.8)
    ccy = jnp.full_like(cy, 0.156)
    expected = np.asarray(_escape_xla(cx, cy, ccx, ccy, 80, 3.0))
    got = np.asarray(kernel(cx, cy, ccx, ccy, 80, 3.0, block=(16, 64)))
    np.testing.assert_array_equal(got, expected)


def test_escape_counts_monotone_in_budget():
    cx, cy = grid(32, 64)
    few = np.asarray(_escape_xla(cx, cy, cx, cy, 20, 3.0))
    many = np.asarray(_escape_xla(cx, cy, cx, cy, 200, 3.0))
    assert np.all(many >= few)
    assert many.max() == 200  # interior pixels exist in this view


def test_lines_kernel_matches_plane_kernel():
    """The separable-c lines kernel (two line inputs, c/z0/interior rebuilt
    per block) is bit-identical to the plane kernel AND the XLA loop on the
    outer-product grid — including saturation and the interior mask."""
    cx_line, cy_line, cx, cy = lines()
    for cap in (None, 37):
        ref = np.asarray(_escape_xla(cx, cy, cx, cy, 100, 3.0,
                                     interior=_interior_mask(cx, cy),
                                     saturate=cap))
        plane = np.asarray(kernel(cx, cy, cx, cy, 100, 3.0, block=(32, 64),
                                  interior=True, saturate=cap))
        got = np.asarray(kernel(cx_line, cy_line, None, None, 100, 3.0,
                                block=(32, 64), lines=True, interior=True,
                                saturate=cap))
        np.testing.assert_array_equal(plane, ref, err_msg=f"cap={cap}")
        np.testing.assert_array_equal(got, ref, err_msg=f"cap={cap}")


@pytest.mark.parametrize("shape,block", [
    ((37, 150), (16, 32)),    # neither axis divides: masked edge blocks
    ((8, 64), (16, 64)),      # block taller than the frame
    ((48, 96), (8, 128)),     # block wider than the frame
])
def test_kernel_edge_blocks_masked(shape, block):
    """Blocks that hang past the frame must neither read nor write outside
    it: counts match the XLA loop everywhere, at every block shape."""
    cx_line, cy_line, cx, cy = lines(*shape)
    ref = np.asarray(_escape_xla(cx, cy, cx, cy, 60, 3.0,
                                 interior=_interior_mask(cx, cy)))
    got = np.asarray(kernel(cx_line, cy_line, None, None, 60, 3.0,
                            lines=True, interior=True, block=block, unroll=3))
    assert got.shape == shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_dtype", [jnp.int32, jnp.float32])
def test_kernel_out_dtype(out_dtype):
    cx_line, cy_line, cx, cy = lines(16, 64)
    got = kernel(cx_line, cy_line, None, None, 40, 3.0, lines=True,
                 interior=True, block=(16, 64), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    ref = _escape_xla(cx, cy, cx, cy, 40, 3.0,
                      interior=_interior_mask(cx, cy))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_escape_iterations_sep_fallback_matches():
    """Off the GPU escape_iterations_sep takes the plane path on the
    broadcast grid — same counts as escape_iterations."""
    w, h = 96, 48
    cx_line = np.linspace(-2.0, 0.7, w, dtype=np.float32)
    cy_line = np.linspace(-1.2, 1.2, h, dtype=np.float32)
    c = np.stack(np.broadcast_arrays(cx_line[None, :], cy_line[:, None]), -1)
    a = np.asarray(escape_iterations_sep(cx_line, cy_line, 80, saturate=23))
    b = np.asarray(escape_iterations(c.astype(np.float32), 80, saturate=23))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entry", ["plane", "sep", "z0"])
def test_dispatch_on_gpu_uses_kernel(monkeypatch, entry):
    """Where the kernel is available, every entry point routes through it
    (here in interpret mode) and gives the XLA loop's counts."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return _escape_kernel(*args, interpret=True, **kwargs)

    cx_line, cy_line, cx, cy = lines(32, 64)
    c = jnp.stack([cx, cy], axis=-1)
    if entry == "plane":
        run = lambda: escape_iterations(c, 50, saturate=29)
    elif entry == "sep":
        run = lambda: escape_iterations_sep(cx_line, cy_line, 50, saturate=29)
    else:
        run = lambda: escape_iterations_z0(c, -0.8, 0.156, 50, saturate=29)
    expected = np.asarray(run())
    monkeypatch.setattr(fractal, "_use_kernel", lambda: True)
    monkeypatch.setattr(fractal, "_escape_kernel", spy)
    got = np.asarray(run())
    assert len(calls) == 1
    assert calls[0].get("lines", False) == (entry == "sep")
    assert calls[0].get("interior", False) == (entry != "z0")
    np.testing.assert_array_equal(got, expected)


def test_dispatch_off_gpu_uses_xla(monkeypatch):
    """The CPU backend never reaches the kernel."""
    def boom(*args, **kwargs):
        raise AssertionError("kernel reached off the GPU")

    monkeypatch.setattr(fractal, "_escape_kernel", boom)
    cx_line, cy_line, _, _ = lines(16, 32)
    assert np.asarray(escape_iterations_sep(cx_line, cy_line, 30)).shape == (16, 32)
