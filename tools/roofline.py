"""Roofline accounting for the graded configs (BASELINE.md) on the GPU.

For each config: steady-state ms/frame (measured through the real export
loop), an ANALYTIC per-frame FLOP/byte account (tools/flopcount.py walks
the actual render program's jaxpr — including inside Pallas kernel bodies
and lax.scan trip counts, which XLA's own compiled cost model gets wrong:
it counts scan bodies once and sees custom calls as opaque), and the
speed-of-light frame time those imply on the card's published peaks —
i.e. whether the program is bandwidth- or compute-bound and how far it
sits from the walls.

The mandelbrot escape loop is data-dependent (per-block early-exit while):
the walker reports its per-round cost, and this tool closes the loop by
MEASURING the iteration map at the graded view and converting it to
executed rounds at the kernel's real granularity (its block shape and
unroll, ops/fractal.py).

Byte accounting is a floor: program I/O + full Pallas operand/result
traffic; XLA-fused intermediates between kernels are not modeled.

Each config runs in its own subprocess, one after another (one JAX
process on the card at a time; the parent never initializes JAX).

Peaks come from PEAKS, keyed by JAX's device_kind; a device that is not
in the table is an error, not a default.

Usage: python tools/roofline.py [config ...]   (default: all six)
       python tools/roofline.py --one <config> (child mode: one JSON line)
Prints one JSON line per config, then a markdown table.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "examples" / "basic"))
sys.path.insert(0, str(REPO / "examples" / "fractals"))

# Published dense peaks per device_kind: NVIDIA H100 SXM data sheet
# (dense, no sparsity, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_s=3.35e12,
                                  tensor_bf16_flop_s=989e12,
                                  f32_flop_s=67e12),
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}")
    return PEAKS[device_kind]

CONFIGS = {
    "basic": dict(width=512, height=288, fps=30.0, ssaa=1.0, batch=128),
    "bars": dict(width=1280, height=720, fps=30.0, ssaa=1.0, batch=128),
    "visualizer": dict(width=1920, height=1080, fps=60.0, ssaa=2.0, batch=128),
    "mandelbrot": dict(width=1920, height=1080, fps=60.0, ssaa=2.0, batch=128),
    "raymarch": dict(width=1920, height=1080, fps=60.0, ssaa=1.0, batch=128),
    "pianoroll": dict(width=3840, height=2160, fps=60.0, ssaa=1.0, batch=64),
}


def scene_for(name: str):
    import demo
    import fractals
    import piano_roll
    return {
        "visualizer": demo.Visualizer,
        "bars": demo.MusicBars,
        "basic": demo.Basic,
        "raymarch": demo.RayMarch,
        "mandelbrot": fractals.Mandelbrot,
        "pianoroll": piano_roll.PianoRoll,
    }[name]()


def mandelbrot_rounds(width: int, height: int, ssaa: float,
                      quality_s: float = 0.5) -> dict:
    """Measure the escape kernel's real work at the graded view.

    The scene renders the static default camera view (fractals.py
    Mandelbrot: c = gluv - (0.5, 0), x spanning ±aspect, y ±1), so one
    frame's iteration map is every frame's. Returns the per-pixel USEFUL
    iteration mean and the EXECUTED per-pixel round-equivalents at the
    kernel's early-exit granularity (max over each block, rounded up to
    the unroll)."""
    import jax.numpy as jnp
    import numpy as np
    from shaderflow_tpu.ops import fractal
    from shaderflow_tpu.ops.fractal import escape_iterations_sep

    rw, rh = round(width * ssaa), round(height * ssaa)
    aspect = width / height
    # Pixel centers, gluv convention (y up, x aspect-corrected)
    xs = (np.arange(rw) + 0.5) / rw * 2.0 - 1.0
    ys = 1.0 - (np.arange(rh) + 0.5) / rh * 2.0
    cx = jnp.asarray(xs * aspect - 0.5, jnp.float32)
    cy = jnp.asarray(ys, jnp.float32)

    quality = max(1, int(1000.0 * quality_s))
    # Same visual-saturation cap as the fragment (fractals.py): the magma
    # A->B slope bounds the last u8-visible count at ~0.284 * quality
    slope = 0.80595    # 4 * max|PALETTE_MAGMA_2 - PALETTE_MAGMA_1|
    cap = math.ceil(quality * (1.0 - (0.5 / (255.0 * slope)) ** (1.0 / 20.0)))

    iters = np.asarray(escape_iterations_sep(
        cx, cy, quality, radius=3.0, saturate=cap, out_dtype=jnp.float32))
    # Interior-shortcut pixels REPORT max_iter but execute ZERO iterations
    # (cardioid/period-2-bulb closed form, fractal.py);
    # zero them before estimating work or the block maxima lie
    gx, gy = np.meshgrid(np.asarray(cx), np.asarray(cy))
    xq = gx - 0.25
    qv = xq * xq + gy * gy
    interior = (qv * (qv + xq) <= 0.25 * gy * gy) | \
               ((gx + 1.0) ** 2 + gy * gy <= 0.0625)
    iters = np.where(interior, 0.0, iters)
    sub, cols, unroll = (fractal.BLOCK_ROWS, fractal.BLOCK_COLS,
                         fractal.UNROLL)
    ph = (-iters.shape[0]) % sub
    pw = (-iters.shape[1]) % cols
    padded = np.pad(iters, ((0, ph), (0, pw)))
    blocks = padded.reshape(padded.shape[0] // sub, sub,
                            padded.shape[1] // cols, cols)
    block_max = blocks.max(axis=(1, 3))
    rounds = np.ceil(block_max / unroll)
    return {
        "useful_iters_px": float(iters.mean()),
        "executed_iters_px": float(rounds.mean() * unroll),
        "quality": quality,
        "cap": cap,
    }


def analytic_cost(scene, batch: int) -> dict:
    """Walk the CURRENT render program's jaxpr (flopcount.count_fn) and
    return per-frame op/byte counts. Mirrors engine.cost_analysis's
    argument staging."""
    from flopcount import count_fn

    engine = scene.engine
    if not engine._frame_uniforms:
        engine.begin_batch()
        for _ in range(min(4, batch)):
            scene.next(dt=scene.frametime)
    packed, spec, streams = engine.stack_captures(
        len(engine._frame_uniforms), pad_to=batch)
    cost = count_fn(engine._render_fn, engine._carry, packed, streams,
                    engine._static_tex, engine._sequences, spec,
                    static_argnums=(5,))
    per_trip_total = sum(f * m for _, f, m in cost.unknown_whiles)
    return {
        "alu_pf": cost.alu / batch,
        "eup_pf": cost.eup / batch,
        "mxu_pf": cost.mxu / batch,
        "bytes_pf": (cost.io_bytes + cost.pallas_bytes) / batch,
        "while_per_round_pf": per_trip_total / batch,
        "n_whiles": len(cost.unknown_whiles),
    }


def measure_one(name: str, seconds: float = 5.0) -> dict:
    cfg = CONFIGS[name]
    batch = cfg["batch"]
    scene = scene_for(name)
    common = dict(width=cfg["width"], height=cfg["height"], fps=cfg["fps"],
                  ssaa=cfg["ssaa"], batch=batch, time=seconds, output="null")

    # Time through the REAL export loop (pipelined dispatch), not
    # manually serialized begin/flush rounds
    scene.main(**common)                   # warm: compiles + precomputes
    t0 = time.monotonic()
    scene.main(**common)
    wall = time.monotonic() - t0
    frames = round(seconds * cfg["fps"])
    s_pf = wall / frames

    cost = analytic_cost(scene, batch)

    vpu_ops = cost["alu_pf"] + cost["eup_pf"]
    model = "jaxpr walk"
    extra = {}
    if name == "mandelbrot" and cost["n_whiles"]:
        mb = mandelbrot_rounds(cfg["width"], cfg["height"], cfg["ssaa"])
        # The walker counted one guaranteed round per while; the measured
        # executed-iteration mean supplies the real multiplier. Per-round
        # cost is per unroll-group: rounds = executed_iters / unroll.
        from shaderflow_tpu.ops import fractal
        rounds = mb["executed_iters_px"] / fractal.UNROLL
        vpu_ops += cost["while_per_round_pf"] * max(0.0, rounds - 1.0)
        model = "jaxpr walk + measured iterations"
        extra = {"useful_iters_px": round(mb["useful_iters_px"], 1),
                 "executed_iters_px": round(mb["executed_iters_px"], 1)}
    elif cost["n_whiles"]:
        model = "jaxpr walk (data-dependent while counted once: floor)"

    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise RuntimeError(f"roofline needs a GPU, got {device.platform!r}")
    peak = peaks(device.device_kind)
    t_alu = vpu_ops / peak["f32_flop_s"]
    t_tensor = cost["mxu_pf"] / peak["tensor_bf16_flop_s"]
    t_hbm = cost["bytes_pf"] / peak["hbm_bytes_s"]
    sol_s = max(t_alu + t_tensor, t_hbm)
    bound = "compute" if (t_alu + t_tensor) >= t_hbm else "bandwidth"
    if vpu_ops / s_pf > 1.2 * peak["f32_flop_s"]:
        # An "achieved" rate above the peak means XLA removed work the
        # per-frame count includes — for frame-static scenes (raymarch:
        # fixed camera, no iTime) the whole march is loop-invariant and
        # hoists OUT of the frame scan. The count is then an upper bound.
        model += " (frame-invariant work hoisted by XLA: static scene)"
    return {
        "config": name,
        "device": device.device_kind,
        **{k: cfg[k] for k in ("width", "height", "fps", "ssaa", "batch")},
        "ms_per_frame": round(s_pf * 1e3, 3),
        "export_fps": round(1.0 / s_pf, 1),
        "elementwise_gop_pf": round(vpu_ops / 1e9, 3),
        "transcendental_share": (round(cost["eup_pf"] / vpu_ops, 3)
                                 if vpu_ops else 0.0),
        "matmul_gflop_pf": round(cost["mxu_pf"] / 1e9, 3),
        "gbytes_pf": round(cost["bytes_pf"] / 1e9, 4),
        "achieved_gbps": round(cost["bytes_pf"] / s_pf / 1e9, 1),
        "achieved_elementwise_tops": round(vpu_ops / s_pf / 1e12, 3),
        "sol_ms": round(sol_s * 1e3, 3),
        "pct_of_light": round(100.0 * sol_s / s_pf, 1),
        "bound": bound,
        "model": model,
        **extra,
    }


def main() -> None:
    if "--one" in sys.argv:
        name = sys.argv[sys.argv.index("--one") + 1]
        print(json.dumps(measure_one(name)), flush=True)
        return

    names = [a for a in sys.argv[1:] if not a.startswith("-")] or list(CONFIGS)
    rows = []
    for name in names:
        print(f"== {name} ==", file=sys.stderr, flush=True)
        proc = subprocess.run(
            [sys.executable, "-u", __file__, "--one", name],
            capture_output=True, text=True)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            print(proc.stderr[-2000:], file=sys.stderr)
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not rows:
        sys.exit("no measurements")
    peak = peaks(rows[0]["device"])
    print(f"\nRoofline on {rows[0]['device']} (published peaks: HBM "
          f"{peak['hbm_bytes_s'] / 1e12:.2f} TB/s, bf16 tensor "
          f"{peak['tensor_bf16_flop_s'] / 1e12:.0f} TFLOP/s, f32 "
          f"{peak['f32_flop_s'] / 1e12:.0f} TFLOP/s):\n")
    print("| Config | ms/frame | elementwise Gop | matmul GFLOP | GB/frame "
          "| GB/s | SoL ms | % of light | bound |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['config']} {r['width']}x{r['height']}@{r['fps']:g} "
              f"ssaa={r['ssaa']:g} | {r['ms_per_frame']:.3f} "
              f"| {r['elementwise_gop_pf']:.2f} "
              f"| {r['matmul_gflop_pf']:.2f} | {r['gbytes_pf']:.3f} "
              f"| {r['achieved_gbps']:.0f} | {r['sol_ms']:.3f} "
              f"| {r['pct_of_light']:.0f}% | {r['bound']} |")


if __name__ == "__main__":
    main()
