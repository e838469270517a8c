"""Microbench: dense vs blocked separable resample (VERDICT r3 #6).

The SSAA/raw-scale general path used to run dense (Ho, Hr) x (Hr, W) band
matmuls; resample_separable_blocked contracts per-block windows instead.
This measures both at the configs that motivated the change:

  * 4K output from a 1080p render (ssaa~0.5 at 4K)
  * 4K ssaa=0.5 exactly (render 1920x1080 -> 3840x2160, subsample=2 taps)
  * 1080p raw-scale x1.5 (720p render upscaled, subsample=1)

Run on the GPU with nothing else on the card. Prints one line
per config: dense ms, blocked ms, speedup.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from shaderflow_tpu.ops.sampling import resample_separable_blocked


def dense(data, pos_rows, pos_cols):
    h, w = data.shape[0], data.shape[1]
    tr = jnp.arange(h, dtype=jnp.float32)
    tc = jnp.arange(w, dtype=jnp.float32)
    pr = jnp.clip(pos_rows, 0.0, h - 1.0)
    pc = jnp.clip(pos_cols, 0.0, w - 1.0)
    w_rows = jnp.maximum(1.0 - jnp.abs(pr[:, :, None] - tr), 0.0).mean(0)
    w_cols = jnp.maximum(1.0 - jnp.abs(pc[:, :, None] - tc), 0.0).mean(0)
    rows = jnp.einsum("oh,hwc->owc", w_rows, data,
                      preferred_element_type=jnp.float32)
    return jnp.einsum("pw,owc->opc", w_cols, rows,
                      preferred_element_type=jnp.float32)


def tap_positions(out_len: int, in_len: int, subsample: int):
    centers = (jnp.arange(out_len, dtype=jnp.float32) + 0.5) / out_len
    rows = []
    for k in range(subsample):
        d = -0.5 / out_len + (1.0 / out_len / subsample) * (0.5 + k)
        rows.append((centers + d) * in_len - 0.5)
    return jnp.stack(rows)


def timeit(fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    print(f"device: {jax.devices()[0]}")
    rng = np.random.default_rng(0)
    configs = [
        ("4K from 1080p, s=2", (1080, 1920), (2160, 3840), 2),
        ("4K ssaa=0.5, s=2  ", (1080, 1920), (2160, 3840), 2),
        ("1080p raw x1.5 s=1", (720, 1280), (1080, 1920), 1),
    ]
    for name, (rh, rw), (oh, ow), s in configs:
        data = jnp.asarray(rng.random((rh, rw, 3), np.float32))
        pos_r = tap_positions(oh, rh, s)
        pos_c = tap_positions(ow, rw, s)

        d = jax.jit(dense)
        b = jax.jit(lambda x, pr, pc: resample_separable_blocked(
            x, pr, pc, rows_per_px=rh / oh, cols_per_px=rw / ow))
        ms_d = timeit(d, data, pos_r, pos_c)
        ms_b = timeit(b, data, pos_r, pos_c)
        err = float(jnp.abs(d(data, pos_r, pos_c) - b(data, pos_r, pos_c)).max())
        print(f"{name}: dense {ms_d:7.2f} ms | blocked {ms_b:7.2f} ms | "
              f"{ms_d / ms_b:5.1f}x | max|diff| {err:.2e}")


if __name__ == "__main__":
    main()
