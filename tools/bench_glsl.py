"""GLSL front-end throughput vs the hand-written python fragments.

Renders the same scenes twice at the graded configs — once with this repo's
python pixel function, once with the reference's own `.frag` source through
the GLSL front-end (shaderflow_tpu/glsl.py) — and reports both fps. The
python fragments use structured fast paths (separable sampling, the tail
stage, preludes) the front-end does not emit, so the delta IS the price of
portability; raymarch isolates the lax.while_loop loop lowering.

Run on the GPU with nothing else on the card. Emits one JSON line per row.
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

REF_SHADERS = Path("/root/reference/examples/basic/shaders")

CONFIGS = [
    # (scene attr, frag file, width, height, fps, ssaa, seconds)
    ("RayMarch", "raymarch.frag", 1920, 1080, 60.0, 1.0, 5.0),
    ("Visualizer", "visualizer.frag", 1920, 1080, 60.0, 2.0, 5.0),
]


def run(scene_cls, seconds, **kw) -> float:
    # ONE scene instance: the warm pass pays compiles + audio precomputes
    # (cached on the instance), the timed pass measures steady export
    # throughput — same protocol as bench.py
    scene = scene_cls()
    scene.main(time=seconds, output="null", **kw)  # warm (compile)
    t0 = time.monotonic()
    scene.main(time=seconds, output="null", **kw)
    return time.monotonic() - t0


def main() -> None:
    import demo
    for name, frag, width, height, fps, ssaa, seconds in CONFIGS:
        base = getattr(demo, name)
        frag_path = REF_SHADERS / frag
        if not frag_path.exists():
            continue

        class Glsl(base):
            def build(self):
                super().build()
                self.shader.fragment = frag_path

        kw = dict(width=width, height=height, fps=fps, ssaa=ssaa, batch=64)
        frames = round(seconds * fps)
        wall_py = run(base, seconds, **kw)
        wall_glsl = run(Glsl, seconds, **kw)
        print(json.dumps({
            "metric": f"glsl-front-end {name} {width}x{height}@{fps:g} ssaa={ssaa:g}",
            "python_fps": round(frames / wall_py, 1),
            "glsl_fps": round(frames / wall_glsl, 1),
            "glsl_over_python": round(wall_py / wall_glsl, 3),
            "frames": frames,
        }), flush=True)


if __name__ == "__main__":
    main()
