"""Video-texture throughput at 4K60 (VERDICT r4 #8).

The reference claims "4k60 fluent playback" for its shadertoy/video scene
(/root/reference/examples/basic/shaders/shadertoy.frag:49, decoding inline
in the render loop, video.py:57-66). Here decode runs in the decode-ahead
prefetch thread (shaderflow_tpu/video.py FramePrefetcher) overlapping the
device render. This tool measures, at 3840x2160@60:

  decode   raw decoder throughput (cv2/FFmpeg pipe, no render)
  export   full scene export fps with the video texture streaming per-frame
  verdict  which side is the wall (decode fps vs render-only fps)

A synthetic 4K60 clip is generated once via cv2.VideoWriter (mp4v) into
SHADERFLOW_BENCH_VIDEO (default /tmp/bench4k.mp4, reused when present).
Run serialized on the chip for the export row; the decode row is host-only.
Emits one JSON line per row.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples" / "basic"))

W, H, FPS = 3840, 2160, 60.0
CLIP = Path(os.environ.get("SHADERFLOW_BENCH_VIDEO", "/tmp/bench4k.mp4"))
SECONDS = float(os.environ.get("BENCH_VIDEO_SECONDS", 4.0))


def ensure_clip() -> Path:
    import cv2
    import numpy as np
    frames = round(SECONDS * FPS)
    if CLIP.exists():
        probe = cv2.VideoCapture(str(CLIP))
        ok = (int(probe.get(cv2.CAP_PROP_FRAME_WIDTH)) == W
              and int(probe.get(cv2.CAP_PROP_FRAME_COUNT)) >= frames)
        probe.release()
        if ok:
            return CLIP
    writer = cv2.VideoWriter(str(CLIP), cv2.VideoWriter_fourcc(*"mp4v"),
                             FPS, (W, H))
    assert writer.isOpened(), "cv2.VideoWriter failed (no mp4v encoder?)"
    # Moving gradient: cheap to synthesize, non-trivial to encode/decode
    base_x = np.linspace(0, 255, W, dtype=np.float32)[None, :]
    base_y = np.linspace(0, 255, H, dtype=np.float32)[:, None]
    for i in range(frames):
        frame = np.empty((H, W, 3), np.uint8)
        frame[..., 0] = ((base_x + 3 * i) % 256).astype(np.uint8)
        frame[..., 1] = ((base_y + 2 * i) % 256).astype(np.uint8)
        frame[..., 2] = (i * 5) % 256
        writer.write(frame)
    writer.release()
    return CLIP


def bench_decode(path: Path) -> dict:
    """Raw decode throughput through the same iterator the scene uses."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg
    n = 0
    t0 = time.monotonic()
    for _frame in FFmpeg.iter_video_frames(path):
        n += 1
    wall = time.monotonic() - t0
    return {"metric": "video decode 3840x2160@60 (host)",
            "frames": n, "decode_fps": round(n / wall, 1),
            "holds_60": bool(n / wall >= 60.0)}


def bench_export(path: Path) -> dict:
    """Full scene export with the 4K video texture streaming per frame."""
    from shaderflow_tpu.scene import ShaderScene
    from shaderflow_tpu.video import ShaderVideo

    class VideoScene(ShaderScene):
        def build(self):
            self.video = ShaderVideo(scene=self, name="iVideo", path=path)
            # Axis-aligned full-screen map -> the separable sampler (two 1D
            # interpolations), so the bench measures the video streaming
            # path rather than the sampler
            self.shader.fragment = (
                "def main(sf):\n"
                "    from shaderflow_tpu import ops\n"
                "    from shaderflow_tpu.ops.sampling import sample_separable\n"
                "    tex = sf.tex('iVideo')\n"
                "    rgb = sample_separable(tex, sf.astuv[0, :, 0],\n"
                "                           sf.astuv[:, 0, 1])\n"
                "    return ops.with_alpha(rgb, 1.0)\n")

    def run() -> float:
        scene = VideoScene()
        t0 = time.monotonic()
        scene.main(width=W, height=H, fps=FPS, ssaa=1.0, time=SECONDS,
                   output="null", batch=32)
        return time.monotonic() - t0

    run()                       # compile + warm
    wall = run()
    frames = round(SECONDS * FPS)
    return {"metric": "video scene export 3840x2160@60 ssaa=1 (GPU)",
            "frames": frames, "export_fps": round(frames / wall, 1),
            "realtime_x": round(SECONDS / wall, 2)}


def bench_upload() -> dict:
    """Host→device throughput for one 4K rgb24 frame. Each rep uploads
    FRESH bytes (jax may alias/cache an unchanged host buffer)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    frame = np.random.default_rng(0).integers(
        0, 256, (H, W, 3), dtype=np.uint8)
    jax.block_until_ready(jnp.asarray(frame))   # path setup
    reps, took = 3, 0.0
    for i in range(reps):
        frame[0, 0, 0] = i                      # distinct bytes per rep
        t0 = time.monotonic()
        jax.block_until_ready(jnp.asarray(frame))
        took += time.monotonic() - t0
    per_frame = took / reps
    return {"metric": "video 4k frame upload (host->device)",
            "upload_mbps": round(frame.nbytes / per_frame / 1e6, 1),
            "upload_fps": round(1.0 / per_frame, 1)}


def bench_render_resident(path: Path) -> dict:
    """Render-side throughput with the video frame RESIDENT on device.
    The compiled program is identical to the streaming scene's (the
    texture content is an input buffer either way — only the host-side
    upload differs), so this is the export fps where upload is not the
    wall (locally-attached hardware)."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg
    from shaderflow_tpu.scene import ShaderScene
    from shaderflow_tpu.texture import ShaderTexture

    frame = next(iter(FFmpeg.iter_video_frames(path)))

    class ResidentScene(ShaderScene):
        def build(self):
            self.tex = ShaderTexture(scene=self, name="iVideo",
                                     components=3).from_numpy(frame)
            self.shader.fragment = (
                "def main(sf):\n"
                "    from shaderflow_tpu import ops\n"
                "    from shaderflow_tpu.ops.sampling import sample_separable\n"
                "    tex = sf.tex('iVideo')\n"
                "    rgb = sample_separable(tex, sf.astuv[0, :, 0],\n"
                "                           sf.astuv[:, 0, 1])\n"
                "    return ops.with_alpha(rgb, 1.0)\n")

    def run() -> float:
        scene = ResidentScene()
        t0 = time.monotonic()
        scene.main(width=W, height=H, fps=FPS, ssaa=1.0, time=SECONDS,
                   output="null", batch=32)
        return time.monotonic() - t0

    run()                       # compile + warm
    wall = run()
    frames = round(SECONDS * FPS)
    return {"metric": "video render 3840x2160@60 device-resident frame (chip)",
            "frames": frames, "render_fps": round(frames / wall, 1),
            "realtime_x": round(SECONDS / wall, 2)}


def main() -> None:
    path = ensure_clip()
    decode = bench_decode(path)
    print(json.dumps(decode), flush=True)
    if os.environ.get("BENCH_VIDEO_DECODE_ONLY"):
        return
    upload = bench_upload()
    print(json.dumps(upload), flush=True)
    resident = bench_render_resident(path)
    print(json.dumps(resident), flush=True)
    export = bench_export(path)
    print(json.dumps(export), flush=True)
    sides = {"decode": decode["decode_fps"], "upload": upload["upload_fps"],
             "render": resident["render_fps"]}
    print(json.dumps({"metric": "video 4k60 wall",
                      "wall": min(sides, key=sides.get),
                      **{f"{k}_fps": v for k, v in sides.items()},
                      "export_fps": export["export_fps"]}), flush=True)


if __name__ == "__main__":
    main()
