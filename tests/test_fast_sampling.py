"""Fast-path sampling: separable grids and tap-kernel convolution must agree
with brute-force per-pixel sampling (the correctness anchor for the
visualizer's restructured hot path)."""

import numpy as np

import jax.numpy as jnp

from shaderflow_tpu.ops.sampling import (
    Sampler2D, convolve2d, sample, sample_separable, splat_kernel,
)
from shaderflow_tpu.ops.stdlib import vec2


def random_tex(h=16, w=24, c=3, seed=0, **kwargs):
    rng = np.random.default_rng(seed)
    return Sampler2D(jnp.asarray(rng.uniform(size=(h, w, c)).astype(np.float32)), **kwargs)


def test_separable_matches_pointwise_linear():
    tex = random_tex(linear=True, repeat_x=True, repeat_y=False)
    u = jnp.linspace(-0.2, 1.3, 33)
    v = jnp.linspace(-0.1, 1.1, 17)
    grid = jnp.stack(jnp.meshgrid(u, v, indexing="xy"), axis=-1)
    expected = np.asarray(sample(tex, grid))
    got = np.asarray(sample_separable(tex, u, v))
    # matmul-reassociation rounding vs pointwise lerp
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_separable_matches_pointwise_nearest():
    tex = random_tex(linear=False, repeat_x=False, repeat_y=True)
    u = jnp.linspace(0.01, 0.99, 19)
    v = jnp.linspace(0.01, 0.99, 11)
    grid = jnp.stack(jnp.meshgrid(u, v, indexing="xy"), axis=-1)
    np.testing.assert_array_equal(
        np.asarray(sample_separable(tex, u, v)),
        np.asarray(sample(tex, grid)))


def test_splat_kernel_integer_offsets():
    kernel = np.asarray(splat_kernel(jnp.array([[1.0, -2.0], [0.0, 0.0]]), 7))
    assert kernel.shape == (7, 7)
    assert kernel[3, 3] == 1.0     # (0, 0)
    assert kernel[1, 4] == 1.0     # dx=+1, dy=-2
    assert kernel.sum() == 2.0


def test_splat_kernel_fractional_weights():
    kernel = np.asarray(splat_kernel(jnp.array([[0.5, 0.0]]), 5))
    assert kernel[2, 2] == 0.5 and kernel[2, 3] == 0.5
    np.testing.assert_allclose(kernel.sum(), 1.0, atol=1e-6)


def test_kernel_conv_equals_multi_tap_sampling():
    """sum_j Bilin(B, p + d_j) == Bilin(conv(B, splat(d_j)), p) for integer
    texel offsets (exact); fractional offsets soften by < one texel."""
    tex = random_tex(h=20, w=20, c=2, linear=True, repeat_x=False, repeat_y=False)
    # Integer texel offsets in array units
    offsets = jnp.array([[1.0, 0.0], [-2.0, 1.0], [0.0, -1.0]])
    kernel = splat_kernel(offsets, 7)
    blurred = Sampler2D(convolve2d(tex.data, kernel), linear=True,
                        repeat_x=False, repeat_y=False)

    # Sample somewhere central (away from zero-padding edge effects)
    u = jnp.linspace(0.3, 0.7, 9)
    v = jnp.linspace(0.3, 0.7, 9)
    got = np.asarray(sample_separable(blurred, u, v))

    expected = np.zeros_like(got)
    for dx, dy in np.asarray(offsets):
        # array-texel offset -> uv offset: du = dx/W, dv = -dy/H (v up)
        du, dv = dx / 20.0, -dy / 20.0
        grid = jnp.stack(jnp.meshgrid(u + du, v + dv, indexing="xy"), axis=-1)
        expected += np.asarray(sample(tex, grid))
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_convolve2d_identity():
    tex = random_tex(h=8, w=8, c=4)
    kernel = jnp.zeros((3, 3)).at[1, 1].set(1.0)
    np.testing.assert_allclose(np.asarray(convolve2d(tex.data, kernel)),
                               np.asarray(tex.data), atol=1e-6)


def test_convolve2d_shift():
    tex = random_tex(h=8, w=8, c=1)
    # Tap at dx=+1: out[y,x] = image[y, x+1]
    kernel = jnp.zeros((3, 3)).at[1, 2].set(1.0)
    out = np.asarray(convolve2d(tex.data, kernel))
    np.testing.assert_allclose(out[:, :-1], np.asarray(tex.data)[:, 1:], atol=1e-6)


def test_lookup_nearest_1d_matches_pointwise():
    from shaderflow_tpu.ops.sampling import lookup_nearest_1d
    rng = np.random.default_rng(5)
    table = Sampler2D(jnp.asarray(rng.uniform(size=(7, 1, 2)).astype(np.float32)),
                      linear=False, repeat_y=False)
    v = jnp.asarray(rng.uniform(-0.1, 1.1, size=(9, 13)).astype(np.float32))
    uv = jnp.stack([jnp.zeros_like(v), v], axis=-1)
    expected = np.asarray(sample(table, uv))
    got = np.asarray(lookup_nearest_1d(table, v))
    np.testing.assert_allclose(got, expected, rtol=1 / 128)  # bf16 table rounding


def test_blocked_separable_matches_dense():
    """The banded/blocked sampler must agree with the dense separable path
    for in-contract maps (zoom-in, CLAMP-equivalent interior positions)."""
    from shaderflow_tpu.ops.sampling import (
        sample_separable_planes, sample_separable_planes_blocked)
    tex = random_tex(h=96, w=128, linear=True, repeat_x=True, repeat_y=True)
    # Zoomed-in affine map: positions stay inside [0, n-1] (no seam), taps
    # per output pixel well under the declared bound
    out_h, out_w = 517, 771   # odd sizes exercise block padding
    u = jnp.linspace(0.1, 0.88, out_w)
    v = jnp.linspace(0.9, 0.12, out_h)
    dense = sample_separable_planes(tex, u, v)
    tpp_u = float(0.78 * 128 / out_w) * 1.2
    tpp_v = float(0.78 * 96 / out_h) * 1.2
    blocked = sample_separable_planes_blocked(
        tex, u, v, texels_per_px=(tpp_u, tpp_v), block=64)
    for d, b in zip(dense, blocked):
        np.testing.assert_allclose(np.asarray(b), np.asarray(d), atol=2e-4)


def test_blocked_separable_bf16_close():
    from shaderflow_tpu.ops.sampling import (
        sample_separable_planes, sample_separable_planes_blocked)
    tex = random_tex(h=96, w=128, linear=True)
    u = jnp.linspace(0.05, 0.93, 300)
    v = jnp.linspace(0.95, 0.07, 200)
    dense = sample_separable_planes(tex, u, v)
    blocked = sample_separable_planes_blocked(
        tex, u, v, texels_per_px=(0.5, 0.6), block=64,
        precision="bfloat16", out_dtype=jnp.bfloat16)
    for d, b in zip(dense, blocked):
        # Two stages of bf16 rounding (~2^-7 at values near 1) — the same
        # error class as the shipped dense bf16 path
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(d),
                                   atol=1.6e-2)


def test_blocked_separable_falls_back_to_dense_when_windows_cover():
    """A bound so large the windows span the whole texture returns the dense
    path's exact result (the dispatch short-circuit)."""
    from shaderflow_tpu.ops.sampling import (
        sample_separable_planes, sample_separable_planes_blocked)
    tex = random_tex(h=32, w=40, linear=True)
    u = jnp.linspace(0.0, 1.0, 50)
    v = jnp.linspace(1.0, 0.0, 30)
    dense = sample_separable_planes(tex, u, v)
    blocked = sample_separable_planes_blocked(tex, u, v, texels_per_px=(9.0, 9.0))
    for d, b in zip(dense, blocked):
        np.testing.assert_allclose(np.asarray(b), np.asarray(d), atol=0)


def _bar_tables_and_field(seed=3, batch=5, bins=23, channels=2, h=40, w=64):
    rng = np.random.default_rng(seed)
    tables = jnp.asarray(rng.uniform(size=(batch, bins, channels)).astype(np.float32))
    v_field = jnp.asarray(rng.uniform(0.02, 0.98, size=(h, w)).astype(np.float32))
    channel_where = jnp.asarray(rng.random((h, w)) > 0.5)
    return tables, v_field, channel_where


def test_lookup_batched_matches_per_frame():
    """The batched table-expand must agree with running the per-frame
    select variant once per frame."""
    from shaderflow_tpu.ops.sampling import (
        lookup_nearest_1d_select, lookup_nearest_1d_select_batched)
    tables, v_field, channel_where = _bar_tables_and_field()
    batched = np.asarray(lookup_nearest_1d_select_batched(
        tables, v_field, channel_where=channel_where), np.float32)
    for b in range(tables.shape[0]):
        tex = Sampler2D(tables[b][:, None, :], linear=False, repeat_y=False)
        per_frame = np.asarray(lookup_nearest_1d_select(
            tex, v_field, channel_where=channel_where), np.float32)
        # both paths round values through bf16
        np.testing.assert_allclose(batched[b], per_frame, atol=1e-6)
