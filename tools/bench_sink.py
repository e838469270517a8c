"""Export DELIVERY benchmark: FFmpegSink + C++ frame pump at production
frame sizes, with overlap evidence (wall ~= max(render, write), not sum).

The headline bench (bench.py) exports to NullSink and measures pure render
throughput — the reference's numbers include GPU readback + pipe write +
encode (/root/reference/shaderflow/exporting.py:148-200). This tool
provides the delivery-side numbers honestly:

  phase 1  pump throughput: 1080p frames through FFmpegSink + native pump
           into a draining encoder stub (bytes/s, fps-equivalent)
  phase 2  pump overlap: with a throttled (write-bound) consumer, producer
           work must hide under the writes
  phase 3  (--device) sink-consuming export of the bench scene on the GPU,
           reported against its render-only (NullSink) fps, so the cost of
           the device->host transfer and the sink is measured, not assumed.

Usage: python tools/bench_sink.py [--device] [--frames N]
Writes one JSON line per phase.
"""

import argparse
import json
import os
import stat
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

W, H = 1920, 1080
FRAME_BYTES = W * H * 3

DRAIN_STUB = r'''#!/usr/bin/env python3
import os, sys, time
if "f32le" in sys.argv and sys.argv[-1] == "-":
    sys.stdout.buffer.write(b"\x00" * (44100 * 2 * 4))   # 1 s stereo silence
    sys.exit(0)
rate = float(os.environ.get("STUB_DRAIN_BYTES_PER_SEC", "0"))
total = 0
start = time.monotonic()
fd = sys.stdin.buffer
while True:
    chunk = fd.read(1 << 20)
    if not chunk:
        break
    total += len(chunk)
    if rate > 0:
        behind = total / rate - (time.monotonic() - start)
        if behind > 0:
            time.sleep(behind)
out = sys.argv[-1]
payload = b"STUB" + total.to_bytes(8, "little")
if out == "-":
    sys.stdout.buffer.write(payload)
else:
    with open(out, "wb") as handle:
        handle.write(payload)
'''


def make_stub(directory: Path) -> None:
    script = directory / "ffmpeg"
    script.write_text(DRAIN_STUB)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    os.environ["PATH"] = f"{directory}{os.pathsep}{os.environ['PATH']}"
    from shaderflow_tpu.io.ffmpeg import FFmpeg
    FFmpeg.binary.cache_clear()
    FFmpeg.ffprobe.cache_clear()


def make_sink(out_path: Path):
    from shaderflow_tpu.io.ffmpeg import FFmpeg
    from shaderflow_tpu.io.sinks import FFmpegSink
    ff = FFmpeg()
    ff.pipe_input(pixel_format="rgb24", width=W, height=H, framerate=60)
    ff.output(path=out_path)
    ff.h264(preset="fast", crf=20)
    return FFmpegSink(ff, frame_bytes=FRAME_BYTES, buffers=5)


def read_stub_count(path: Path) -> int:
    blob = path.read_bytes()
    assert blob[:4] == b"STUB", "stub output corrupt"
    return int.from_bytes(blob[4:12], "little")


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def phase_throughput(tmp: Path, frames_total: int) -> None:
    os.environ.pop("STUB_DRAIN_BYTES_PER_SEC", None)
    out = tmp / "tp.mp4"
    sink = make_sink(out)
    assert sink.pump is not None and sink.pump.is_native, "native pump required"
    frames = np.random.default_rng(0).integers(0, 255, (64, H, W, 3), np.uint8)
    start = time.monotonic()
    sent = 0
    while sent < frames_total:
        n = min(64, frames_total - sent)
        sink.write_batch(frames[:n])
        sent += n
    sink.pump.flush()
    wall = time.monotonic() - start
    sink.finish()
    assert read_stub_count(out) == frames_total * FRAME_BYTES
    emit({
        "phase": "pump_throughput",
        "frames": frames_total, "width": W, "height": H,
        "seconds": round(wall, 3),
        "gbytes_per_sec": round(frames_total * FRAME_BYTES / wall / 1e9, 3),
        "fps_1080p": round(frames_total / wall, 1),
        "realtime_multiple_1080p60": round(frames_total / wall / 60, 2),
    })


def phase_overlap(tmp: Path) -> None:
    frames_total = 16
    per_frame_write = 0.20
    per_frame_render = 0.06
    os.environ["STUB_DRAIN_BYTES_PER_SEC"] = str(FRAME_BYTES / per_frame_write)
    frame = np.zeros((1, H, W, 3), np.uint8)

    def run(render_sleep: float, out: Path) -> float:
        sink = make_sink(out)
        start = time.monotonic()
        for _ in range(frames_total):
            if render_sleep:
                time.sleep(render_sleep)
            sink.write_batch(frame)
        sink.pump.flush()
        wall = time.monotonic() - start
        sink.finish()
        assert read_stub_count(out) == frames_total * FRAME_BYTES
        return wall

    wall_write = run(0.0, tmp / "w.mp4")
    wall_both = run(per_frame_render, tmp / "rw.mp4")
    os.environ.pop("STUB_DRAIN_BYTES_PER_SEC", None)
    render_total = frames_total * per_frame_render
    emit({
        "phase": "pump_overlap_write_bound",
        "write_bound_wall_s": round(wall_write, 2),
        "producer_work_added_s": round(render_total, 2),
        "wall_grew_s": round(wall_both - wall_write, 2),
        "overlapped": bool(wall_both - wall_write < 0.5 * render_total),
    })


def phase_device(tmp: Path, frames_total: int) -> None:
    """Real-chip export through the sink vs render-only, same scene."""
    sys.path.insert(0, str(Path(__file__).parent.parent / "examples"))
    from basic.demo import Visualizer  # the bench scene

    def run(output, label):
        scene = Visualizer()
        start = time.monotonic()
        scene.main(width=W, height=H, fps=60, ssaa=2.0,
                   time=frames_total / 60, output=output, batch=64)
        return time.monotonic() - start

    # Warm + render-only (NullSink: no device->host transfer)
    run("null", "warm")
    wall_null = run("null", "render")
    out = tmp / "dev.mp4"
    wall_sink = run(str(out), "sink")
    delivered = read_stub_count(out)
    assert delivered == frames_total * FRAME_BYTES, delivered
    emit({
        "phase": "device_export",
        "frames": frames_total,
        "render_only_fps": round(frames_total / wall_null, 1),
        "sink_consuming_fps": round(frames_total / wall_sink, 1),
        "transfer_gbytes": round(delivered / 1e9, 2),
    })


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", action="store_true",
                        help="also run the GPU export phase")
    parser.add_argument("--frames", type=int, default=600)
    args = parser.parse_args()

    if not args.device:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_stub(tmp)
        phase_throughput(tmp, args.frames)
        phase_overlap(tmp)
        if args.device:
            phase_device(tmp, min(args.frames, 128))


if __name__ == "__main__":
    main()
