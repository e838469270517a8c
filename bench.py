"""
Headline benchmark: music-visualizer export at 1080p60 with 2x SSAA.

Exports the bundled visualizer scene at 1080p60, ssaa=2 into a null sink
and reports frames/sec + realtime multiple, with the device it ran on.
Fails when JAX finds no GPU: a CPU number is never reported.

Prints exactly ONE JSON line on stdout; all logs go to stderr.
Env knobs: BENCH_SECONDS (default 10), BENCH_WIDTH/HEIGHT/FPS/SSAA/BATCH,
BENCH_SCENE (visualizer|bars|mandelbrot|raymarch|basic).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples" / "basic"))
sys.path.insert(0, str(REPO / "examples" / "fractals"))


def main() -> None:
    seconds = float(os.environ.get("BENCH_SECONDS", 10.0))
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    fps = float(os.environ.get("BENCH_FPS", 60.0))
    ssaa = float(os.environ.get("BENCH_SSAA", 2.0))
    # Fixed default batch so repeat runs (and the persistent compile cache)
    # always see identical program shapes (matches scene.default_batch_size
    # at 1080p)
    batch = int(os.environ.get("BENCH_BATCH", 128))
    which = os.environ.get("BENCH_SCENE", "visualizer")

    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {device.platform!r})")

    import demo
    import fractals
    import piano_roll

    scene_class = {
        "visualizer": demo.Visualizer,
        "bars": demo.MusicBars,
        "basic": demo.Basic,
        "raymarch": demo.RayMarch,
        "mandelbrot": fractals.Mandelbrot,
        "pianoroll": piano_roll.PianoRoll,
        "shadertoy": demo.ShaderToy,
        "life": demo.Life,
    }[which]

    common = dict(width=width, height=height, fps=fps, ssaa=ssaa,
                  batch=batch, output="null")
    if os.environ.get("BENCH_QUALITY"):
        common["quality"] = float(os.environ["BENCH_QUALITY"])

    scene = scene_class()
    # Warmup run: trace + compile + device warm caches. Resuming near the
    # end renders only ~2 full batches PLUS the same partial final batch as
    # the timed run (total_frames % batch), so every program variant the
    # timed run needs — including the padded tail flush — is a cache hit.
    total_frames = round(seconds * fps)
    batch_frames = (batch or 32) * 2 + total_frames % (batch or 32)
    scene.main(time=seconds, start=max(0.0, seconds - batch_frames / fps), **common)

    start = time.monotonic()
    scene.main(time=seconds, **common)
    took = time.monotonic() - start

    frames = round(seconds * fps)
    export_fps = frames / took
    realtime = seconds / took

    print(json.dumps({
        "metric": f"{which} export fps @ {width}x{height}@{fps:.0f} ssaa={ssaa}",
        "value": round(export_fps, 2),
        "unit": "frames/s",
        "detail": {
            "realtime_multiple": round(realtime, 2),
            "frames": frames,
            "seconds_content": seconds,
            "seconds_wall": round(took, 2),
            "device": {"platform": device.platform,
                       "kind": device.device_kind,
                       "count": len(jax.devices())},
        },
    }))


if __name__ == "__main__":
    main()
