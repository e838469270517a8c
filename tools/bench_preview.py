"""Realtime preview benchmark: can the interactive path hold 1080p60 with
live audio + HUD on the GPU?

Reports THREE decomposed measurements, so a slow display link is not
misattributed to rendering:

  * device: per-frame render cost at batch=1, launches queued back-to-back
    (what the card itself can sustain)
  * link: one displayed frame's device->host transfer (~6.2 MB at 1080p)
  * paced-60 loop: the REAL realtime path (scene.next + dispatch + async
    latest-frame-wins display, io/displaypump.py) — scene-loop fps (the
    'holds 60' verdict: input/audio/dynamics pacing) and displayed fps
    (link-bound) separately

Run on the GPU with nothing else on the card. Env:
BENCH_PREVIEW_{WIDTH,HEIGHT,FRAMES}.
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "examples" / "basic"))


def make_scene(width: int, height: int, fps: float):
    import demo
    scene = demo.Visualizer()
    scene.frame_limit = None
    scene._setup_run(width=width, height=height, fps=fps, time=1e9,
                     freewheel=False)
    scene.engine.begin_batch()
    return scene


def bench_device(scene, fps: float, frames: int) -> float:
    """Amortized per-frame device+dispatch cost: queue every launch, block
    once at the end (the async-display loop never blocks per frame)."""
    import jax
    handles = []
    for _ in range(10):  # warmup
        scene.engine.begin_batch()
        scene.next(dt=1.0 / fps)
        handles.append(scene.engine.flush(1))
    jax.block_until_ready(handles)
    handles.clear()
    t0 = time.perf_counter()
    for _ in range(frames):
        scene.engine.begin_batch()
        scene.next(dt=1.0 / fps)
        handles.append(scene.engine.flush(1))
        if len(handles) > 3:
            handles.pop(0)[0].block_until_ready()
    jax.block_until_ready(handles)
    return (time.perf_counter() - t0) / frames


def bench_link(scene, fps: float, reps: int = 5) -> float:
    import numpy as np
    scene.engine.begin_batch()
    scene.next(dt=1.0 / fps)
    frames = scene.engine.flush(1)
    np.asarray(frames[0])  # first-transfer setup cost excluded
    t0 = time.perf_counter()
    for _ in range(reps):
        np.asarray(frames[0])
    return (time.perf_counter() - t0) / reps


def bench_paced(scene, fps: float, frames: int, display: bool = True) -> dict:
    """The real async-display realtime path, paced at `fps`: duty-cycled /
    adaptively-decimated display pump + the scene's own auto micro-batch
    controller (scene._rt_batch_size/_rt_batch_feedback — N frames per
    launch when the per-launch cost exceeds the frame budget).
    Reports per-FRAME pacing (a launch covers N frames).

    STEADY STATE is what's measured: the controller's growth ladder
    (1 -> 2 -> 4 -> 8) costs one engine compile per size, which a user
    pays once per session — an untimed
    warm phase runs until the chosen micro-batch has been stable for three
    launches, and only then does timing start. `display=False` measures the
    loop without any device->host transfer."""
    import numpy as np
    from shaderflow_tpu.io.displaypump import DisplayPump

    pump = DisplayPump() if display else None
    scene.render_ui = True
    inflight = []
    times = []       # (wall_seconds, frames_covered) per launch
    displayed = 0
    rendered = 0
    timing = False
    stable = 0
    last_n = 0
    try:
        while rendered < frames or not timing:
            t0 = time.perf_counter()
            n = scene._rt_batch_size(auto_ok=True)
            scene.engine.begin_batch()
            for _ in range(n):
                scene.next(dt=1.0 / fps / n)
            dispatched = scene.engine.flush(n)
            inflight.append(dispatched)
            while len(inflight) > 3:
                inflight.pop(0)[0].block_until_ready()
            if pump is not None:
                pump.offer(dispatched)
                frame = pump.take()
            else:
                frame = None
            call = time.perf_counter() - t0
            scene._rt_batch_feedback(call, n)
            if frame is not None:
                scene._draw_hud(frame.copy())
                if timing:
                    displayed += 1
            budget = n / fps - call
            if budget > 0:
                time.sleep(budget)
            if timing:
                times.append((time.perf_counter() - t0, n))
                rendered += n
            else:
                # Warm phase: wait for the micro-batch ladder to settle
                # (each size change compiles a new program)
                stable = stable + 1 if n == last_n else 0
                last_n = n
                if stable >= 3:
                    timing = True
                    rendered = 0
    finally:
        if pump is not None:
            pump.close()
    per_frame = np.asarray([t / n for t, n in times])
    wall = sum(t for t, _ in times)
    n_final = scene._rt_batch_size(auto_ok=True)
    return {
        "fps_achieved": 1.0 / per_frame.mean(),
        "frame_ms_p95": float(np.percentile(per_frame, 95) * 1e3),
        "missed_pct": float((per_frame > 1.0 / fps * 1.05).mean() * 100),
        "display_fps": displayed / wall if wall > 0 else 0.0,
        "rt_batch": int(n_final),
        "display_decimate": int(pump.decimate) if pump is not None else 0,
    }


def main() -> None:
    import jax
    print(f"device: {jax.devices()[0]}")
    width = int(os.environ.get("BENCH_PREVIEW_WIDTH", 1920))
    height = int(os.environ.get("BENCH_PREVIEW_HEIGHT", 1080))
    frames = int(os.environ.get("BENCH_PREVIEW_FRAMES", 300))

    scene = make_scene(width, height, fps=60.0)
    device_s = bench_device(scene, fps=60.0, frames=frames)
    print(f"device  {width}x{height}: {device_s * 1e3:.1f} ms/frame "
          f"({1.0 / device_s:.1f} fps render ceiling)")

    link_s = bench_link(scene, fps=60.0)
    mb = width * height * 3 / 1e6
    print(f"link    {width}x{height}: {link_s * 1e3:.1f} ms/frame "
          f"({mb / link_s:.1f} MB/s device->host)")

    for display in (False, True):
        label = "display-on " if display else "display-off"
        paced = bench_paced(make_scene(width, height, fps=60.0), 60.0,
                            frames, display=display)
        loop_verdict = "HOLDS 60" if paced["missed_pct"] < 5 else "MISSES 60"
        tail = (f", display {paced['display_fps']:.1f} fps "
                f"(link-bound: one {mb:.1f} MB frame per {link_s * 1e3:.0f} ms), "
                f"display decimate x{paced['display_decimate']}"
                if display else "")
        print(f"paced-60 {label} {width}x{height}: scene loop "
              f"{paced['fps_achieved']:.1f} fps "
              f"(p95 {paced['frame_ms_p95']:.1f} ms, {paced['missed_pct']:.1f}% "
              f"over budget -> {loop_verdict}), "
              f"micro-batch {paced['rt_batch']} frames/launch{tail}",
              flush=True)


if __name__ == "__main__":
    main()
