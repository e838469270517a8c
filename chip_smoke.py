#!/usr/bin/env python3
"""Smoke test of the export path on an NVIDIA GPU.

Runs in one process, one JAX process per card:

  0. device:   JAX must see GPU devices; prints the card's name and power
               limit as nvidia-smi reports them.
  1. main:     the flagship Visualizer exported through scene.main() at
               1920x1080, 60 fps, ssaa=2, for 4 s — 240 non-black u8 frames;
               a second run gives the same bytes and compiles nothing.
  2. scenes:   Mandelbrot (1080p60 ssaa=2) and PianoRoll (3840x2160@60,
               ssaa=1) through scene.main() for 1 s each; the Visualizer
               at 1080p60 ssaa=3 for 2 s, in one batch of 128 and in
               batches of 16, which must agree.
  3. kernels:  the escape-time kernel, the tail kernel (ssaa=2 and ssaa=3)
               and the ColSampled column resample against their plain
               references at real widths.
  4. oracle:   the oracle-pinned scenes (tools/psnr_gate.py) against
               tools/gl_oracle.py, at the bars of tests/test_psnr_reference.py.

With --four only the multi-card phase runs: the Visualizer frame-sharded
and MotionBlur row-sharded over four cards, each compared with the
single-card export of the same frames.

Any failing phase exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def log(message: str) -> None:
    print(message, flush=True)


def card_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return result.stdout.strip().splitlines()[0]


class CompileCounter:
    """Counts XLA compilations (backend compiles and persistent-cache
    loads) while attached."""

    def __init__(self):
        from jax import monitoring
        self.count = 0
        monitoring.register_event_duration_secs_listener(self._duration)
        monitoring.register_event_listener(self._event)

    def _duration(self, event: str, duration: float, **_) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.count += 1

    def _event(self, event: str, **_) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.count += 1


def export(scene, path: Path, **kwargs) -> np.ndarray:
    """scene.main() into a raw rgb24 file -> (F, H, W, 3) u8 frames."""
    scene.main(output=str(path), **kwargs)
    meta = json.loads(path.with_suffix(path.suffix + ".json").read_text())
    frames = np.fromfile(path, np.uint8)
    return frames.reshape(meta["frames"], meta["height"], meta["width"], 3)


def check_frames(name: str, frames: np.ndarray, count: int, height: int,
                 width: int) -> None:
    expected = (count, height, width, 3)
    if frames.shape != expected:
        raise AssertionError(f"{name}: frames {frames.shape} != {expected}")
    black = [i for i in range(count) if not frames[i].any()]
    if black:
        raise AssertionError(f"{name}: {len(black)} black frames "
                             f"(first {black[0]})")


def examples():
    for sub in ("examples", "examples/basic", "examples/fractals", "tools"):
        sys.path.insert(0, str(REPO / sub))
    import demo
    import fractals
    import piano_roll
    return demo, fractals, piano_roll


def phase_main(tmp: Path, card: str, counter: CompileCounter) -> None:
    from shaderflow_tpu.io.framepump import FramePump
    demo, _, _ = examples()

    read_fd, write_fd = os.pipe()
    try:
        pump = FramePump(write_fd, slot_size=64, slots=2)
        native = pump.is_native
        pump.close()
    finally:
        os.close(write_fd)
        os.close(read_fd)
    if not native:
        raise AssertionError("framepump: native library did not build")
    log(f"framepump: native build ok; ffmpeg binary: "
        f"{shutil.which('ffmpeg') or 'none (audio read through wave)'}")

    scene = demo.Visualizer()
    settings = dict(width=1920, height=1080, fps=60, time=4, ssaa=2)
    start = time.perf_counter()
    frames = export(scene, tmp / "viz.rgb", **settings)
    cold = time.perf_counter() - start
    check_frames("visualizer", frames, 240, 1080, 1920)
    digest = hashlib.sha256(frames.tobytes()).hexdigest()
    del frames

    compiles = counter.count
    start = time.perf_counter()
    frames = export(scene, tmp / "viz.rgb", **settings)
    warm = time.perf_counter() - start
    recompiles = counter.count - compiles
    check_frames("visualizer (second run)", frames, 240, 1080, 1920)
    if hashlib.sha256(frames.tobytes()).hexdigest() != digest:
        raise AssertionError("visualizer: second run gave other bytes")
    if recompiles:
        raise AssertionError(f"visualizer: second run compiled "
                             f"{recompiles} programs")
    log(f"phase 1 visualizer 1920x1080@60 ssaa=2, 240 frames: ok; "
        f"cold {cold:.2f} s, warm {warm:.2f} s "
        f"({240 / warm:.1f} frames/s warm, into a raw file) on {card}")


def phase_scenes(tmp: Path) -> None:
    demo, fractals, piano_roll = examples()
    for name, scene, settings in (
            ("mandelbrot", fractals.Mandelbrot(),
             dict(width=1920, height=1080, fps=60, time=1, ssaa=2)),
            ("pianoroll", piano_roll.PianoRoll(),
             dict(width=3840, height=2160, fps=60, time=1, ssaa=1))):
        start = time.perf_counter()
        frames = export(scene, tmp / f"{name}.rgb", **settings)
        seconds = time.perf_counter() - start
        check_frames(name, frames, 60, settings["height"], settings["width"])
        log(f"phase 2 {name} {settings['width']}x{settings['height']}@60 "
            f"ssaa={settings['ssaa']}, 60 frames: ok ({seconds:.2f} s, "
            f"compile included)")

    # ssaa=3 at the default batch of 128: the bar stack's frames past
    # position 116 lie beyond int32 offsets into the whole stack. The same
    # frames in batches of 16 must agree.
    settings = dict(width=1920, height=1080, fps=60, time=2, ssaa=3)
    start = time.perf_counter()
    frames = export(demo.Visualizer(), tmp / "viz3.rgb", **settings)
    seconds = time.perf_counter() - start
    check_frames("visualizer ssaa=3", frames, 120, 1080, 1920)
    small = export(demo.Visualizer(), tmp / "viz3b.rgb", batch=16, **settings)
    diff = np.abs(frames.astype(np.int16) - small.astype(np.int16))
    log(f"phase 2 visualizer 1920x1080@60 ssaa=3, 120 frames: batch 128 vs "
        f"batch 16: max |diff| {int(diff.max())} u8, "
        f"{float((diff != 0).mean()):.6%} of values differ (tolerance 0; "
        f"{seconds:.2f} s at batch 128, compile included)")
    if diff.max():
        raise AssertionError("visualizer ssaa=3: batch size changes frames")


def check_escape(height: int, width: int) -> None:
    import jax
    import jax.numpy as jnp
    from shaderflow_tpu.ops import fractal

    # The Mandelbrot scene's default view (gluv - (0.5, 0)) at 16:9
    cx_line = jnp.asarray(np.linspace(-1.0, 1.0, width, dtype=np.float32)
                          * (16 / 9) - 0.5)
    cy_line = jnp.asarray(np.linspace(1.0, -1.0, height, dtype=np.float32))
    cx = jnp.broadcast_to(cx_line[None, :], (height, width))
    cy = jnp.broadcast_to(cy_line[:, None], (height, width))
    max_iter, cap = 500, 142
    with jax.default_matmul_precision("highest"):
        reference = np.asarray(jax.jit(
            lambda a, b: fractal._escape_xla(
                a, b, a, b, max_iter, 3.0,
                interior=fractal._interior_mask(a, b), saturate=cap))(cx, cy))
    forms = {
        "lines": jax.jit(lambda a, b: fractal._escape_kernel(
            a, b, None, None, max_iter, 3.0, lines=True, interior=True,
            saturate=cap))(cx_line, cy_line),
        "plane": jax.jit(lambda a, b: fractal._escape_kernel(
            a, b, a, b, max_iter, 3.0, interior=True,
            saturate=cap))(cx, cy),
    }
    for form, got in forms.items():
        got = np.asarray(got)
        diff = np.abs(got.astype(np.int64) - reference)
        same = float((diff == 0).mean())
        log(f"phase 3 escape kernel ({form}) vs _escape_xla at "
            f"{width}x{height}, q={max_iter} cap={cap}: {same:.6%} "
            f"identical, max |diff| {int(diff.max())} "
            f"(tolerance: >= 99.9% identical, rest within 1; "
            f"reference precision highest)")
        if not (same >= 0.999 and diff.max() <= 1):
            raise AssertionError(f"escape kernel ({form}) disagrees")


def check_colsample(height: int, width: int, w_in: int) -> None:
    """The Visualizer's background at 1080p ssaa=2 is (2160, 1920) bf16
    row-sampled planes resampled to 3840 columns."""
    import jax
    import jax.numpy as jnp
    from shaderflow_tpu.ops import tailfuse
    from shaderflow_tpu.ops.downsample import quantize_u8

    rng = np.random.default_rng(0)
    plane = jnp.asarray(rng.random((height, w_in), np.float32)).astype(
        jnp.bfloat16)
    u = jnp.asarray(np.linspace(0.03, 0.97, width, dtype=np.float32))
    positions = jnp.clip(u * w_in - 0.5, 0.0, float(w_in - 1))
    with jax.default_matmul_precision("highest"):
        dense = np.asarray(jax.jit(lambda p, x: quantize_u8(
            tailfuse.colsample_dense(p, x)))(plane, positions))
    gather = np.asarray(jax.jit(lambda p, x: quantize_u8(
        tailfuse.colsample_gather(p, x)))(plane, positions))
    step = int(np.abs(dense.astype(np.int16) - gather.astype(np.int16)).max())
    log(f"phase 3 colsample gather vs dense at ({height}, {w_in}) -> "
        f"({height}, {width}) bf16: max {step} u8 step (tolerance 1: the "
        f"dense form rounds its weights to bf16; reference precision "
        f"highest)")
    if step > 1:
        raise AssertionError("colsample forms disagree")


def check_tail_kernel(out_height: int, out_width: int, w_in: int,
                      subsample: int, depth: int) -> None:
    """Tail kernel vs the plain tail, with every input kind the kernel
    takes (planes, rows, cols, scalars, ColSampled, Indexed) and smooth
    math only, so the two compilers' transcendentals can move a value by
    at most one quantization step. The Indexed input is a bf16 (depth, Hr,
    Wr) stack read at its last plane, as the Visualizer's bar stack is
    read at the end of a batch."""
    import jax
    import jax.numpy as jnp
    from shaderflow_tpu.ops import tailfuse
    from shaderflow_tpu.ops.downsample import final_pass

    s = subsample
    hr, wr = s * out_height, s * out_width
    aspect = out_width / out_height
    rng = np.random.default_rng(1)
    plane = jnp.asarray(rng.random((hr, w_in), np.float32)).astype(
        jnp.bfloat16)
    # Built on the card: a sawtooth that differs between planes
    def sawtooth():
        value = (jnp.arange(depth, dtype=jnp.float32)[:, None, None] * 0.618
                 + jnp.arange(hr, dtype=jnp.float32)[None, :, None] * 0.0137
                 + jnp.arange(wr, dtype=jnp.float32)[None, None, :] * 0.0071)
        return (value % 1.0).astype(jnp.bfloat16)

    stack = jax.jit(sawtooth)()

    def tail(tp):
        r, g, b = tp.vec3("tex")
        (sel,) = tp.vec("sel")
        glow = jnp.exp(-3.0 * (tp.gluv_x ** 2 + tp.gluv_y ** 2))
        return (r * sel + tp.scalar("k") * glow,
                jnp.sqrt(g * tp.row("v") + 1e-3),
                b * tp.col("u") + 0.1 * jnp.log1p(sel))

    def spec(plane, stack):
        u = jnp.linspace(0.03, 0.97, wr, dtype=jnp.float32)
        return tailfuse.make_spec(
            tail, hr, wr, tex=tailfuse.ColSampled((plane,) * 3, u, 1.0),
            sel=tailfuse.Indexed(stack, jnp.int32(depth - 1)),
            k=jnp.float32(0.3), u=tailfuse.Col(jnp.linspace(0.0, 1.0, wr)),
            v=tailfuse.Row(jnp.linspace(1.0, 0.0, hr)))

    with jax.default_matmul_precision("highest"):
        plain = np.asarray(jax.jit(lambda p, x: final_pass(
            tailfuse.eval_reference(spec(p, x), hr, wr, aspect),
            out_height, out_width, s))(plane, stack))
    kernel = np.asarray(jax.jit(lambda p, x: tailfuse.tail_final_kernel(
        spec(p, x), hr, wr, out_height, out_width, s, aspect))(plane, stack))
    del stack
    diff = np.abs(plain.astype(np.int16) - kernel.astype(np.int16))
    log(f"phase 3 tail kernel vs eval_reference + final_pass at "
        f"{wr}x{hr} -> {out_width}x{out_height} (ssaa={s}, Indexed stack "
        f"depth {depth}, last plane): max {int(diff.max())} u8 step, "
        f"{float((diff != 0).mean()):.6%} of values differ (tolerance 1: "
        f"exp/log/sqrt may round differently between the two compilers; "
        f"reference precision highest)")
    if diff.max() > 1:
        raise AssertionError("tail kernel disagrees")


def phase_kernels() -> None:
    check_escape(2160, 3840)
    check_colsample(2160, 3840, 1920)
    check_tail_kernel(1080, 1920, 1920, subsample=2, depth=3)
    # 128 * 3240 * 5760 values: offsets into the whole stack pass int32
    check_tail_kernel(1080, 1920, 1920, subsample=3, depth=128)


def phase_oracle() -> None:
    examples()
    import psnr_gate
    for name in psnr_gate.ORACLE_CONFIGS:
        result = psnr_gate.oracle_check(name)
        log(f"phase 4 oracle {name}: {result['metric']} "
            f"{result['value']:.4f} (bar {result['bar']}, default matmul "
            f"precision) {'ok' if result['ok'] else 'FAILED'}")
        if not result["ok"]:
            raise AssertionError(f"oracle parity failed: {name}")


def phase_four(tmp: Path) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    demo, _, _ = examples()
    settings = dict(width=1920, height=1080, fps=60, time=2, ssaa=2)
    for name, cls, mode in (("visualizer", demo.Visualizer, "frame"),
                            ("motionblur", demo.MotionBlur, "row")):
        start = time.perf_counter()
        single = export(cls(), tmp / f"{name}1.rgb", **settings)
        one = time.perf_counter() - start
        start = time.perf_counter()
        sharded = export(cls(), tmp / f"{name}4.rgb", devices=4, **settings)
        four = time.perf_counter() - start
        check_frames(name, single, 120, 1080, 1920)
        check_frames(f"{name} (4 cards)", sharded, 120, 1080, 1920)
        diff = np.abs(single.astype(np.int16) - sharded.astype(np.int16))
        differing = float((diff != 0).mean())
        log(f"four {name} {mode}-sharded over 4 cards vs 1 card, 120 frames "
            f"1080p60 ssaa=2: max |diff| {int(diff.max())} u8, "
            f"{differing:.6%} of values differ "
            f"(1 card {one:.2f} s, 4 cards {four:.2f} s, compile included)")
        if diff.max():
            raise AssertionError(f"{name}: {mode}-sharded output differs")


def main() -> int:
    four = "--four" in sys.argv[1:]
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import shaderflow_tpu  # noqa: F401  (fails outside a checkout)

    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    counter = CompileCounter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        if four:
            phase_four(tmp)
        else:
            phase_main(tmp, card, counter)
            phase_scenes(tmp)
            phase_kernels()
            phase_oracle()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
