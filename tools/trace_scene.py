"""Per-op device profiling of a scene's render program.

Runs one warm batch, then captures a jax.profiler trace of a second batch
and reduces the device events of the trace to:

  * the top HLO ops by total device time;
  * device time per named scope (the engine's `prelude_<name>`,
    `program_<name>`, `tail_final` and `final_pass` scopes, and the
    `escape_iterations` kernel), found through the compiled program's
    op metadata;
  * device busy time (union of op intervals) and idle share over the
    traced batch's host wall time.

XLA runs a scan body on the GPU as one command buffer (a CUDA graph), which
the trace shows as a single op; this tool turns command buffers off (in
XLA_FLAGS, before JAX starts) so every fusion shows as its own op. Run it
as its own process.

Usage:
    python tools/trace_scene.py [scene] [width] [height] [ssaa] [batch]
    scene in {visualizer, bars, basic, raymarch, life, mandelbrot, pianoroll}

Writes the full reduction as JSON to chiprun_out/trace_<scene>.json.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))
if "xla_gpu_enable_command_buffer" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
sys.path.insert(0, str(REPO / "examples"))
sys.path.insert(0, str(REPO / "examples" / "basic"))
sys.path.insert(0, str(REPO / "examples" / "fractals"))

import jax

SCOPES = ("escape_iterations", "tail_final", "final_pass", "prelude_",
          "program_")


def scene_class(which: str):
    import demo
    import fractals
    import piano_roll
    return {
        "visualizer": demo.Visualizer, "bars": demo.MusicBars,
        "basic": demo.Basic, "raymarch": demo.RayMarch, "life": demo.Life,
        "mandelbrot": fractals.Mandelbrot, "pianoroll": piano_roll.PianoRoll,
    }[which]


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the innermost known scope in its op_name."""
    scopes = {}
    pattern = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                         r'op_name="([^"]*)"', re.M)
    for name, op_name in pattern.findall(hlo_text):
        parts = [p for p in op_name.split("/")
                 if any(p.startswith(s) for s in SCOPES)]
        if parts:
            scopes[name] = parts[-1]
    return scopes


def device_events(xplane_path: str):
    """(name, start_ns, duration_ns) of every op on the first GPU plane."""
    from jax.profiler import ProfileData
    data = ProfileData.from_file(xplane_path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [line for line in lines if line.name == "XLA Ops"] or lines
        for line in ops:
            for event in line.events:
                stats = dict(event.stats)
                yield (str(stats.get("hlo_op", event.name)),
                       float(event.start_ns), float(event.duration_ns))
        return


def busy_ns(events) -> float:
    """Length of the union of the event intervals."""
    total, end = 0.0, None
    for _, start, duration in sorted(events, key=lambda e: e[1]):
        stop = start + duration
        if end is None or start > end:
            total += duration
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def trace_scene(which: str, width: int = 1920, height: int = 1080,
                ssaa: float = 2.0, batch: int = 64) -> dict:
    scene = scene_class(which)()
    scene._setup_run(width=width, height=height, fps=60,
                     time=3 * batch / 60, ssaa=ssaa, freewheel=True)
    engine = scene.engine

    def run_batch():
        engine.begin_batch()
        for _ in range(batch):
            scene.next(dt=scene.frametime)
        jax.block_until_ready(engine.flush(batch, pad_to=batch))

    run_batch()  # compile + warm
    jitted = engine._jitted
    captured = {}

    class Spy:
        """Records the traced batch's argument shapes for re-lowering."""

        def __call__(self, *args):
            captured["shapes"] = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
                if hasattr(a, "shape") else a, args)
            return jitted(*args)

        def __getattr__(self, name):
            return getattr(jitted, name)

    engine._jitted = Spy()
    trace_dir = tempfile.mkdtemp(prefix="shaderflow_trace_")
    try:
        with jax.profiler.trace(trace_dir):
            start = time.perf_counter_ns()
            run_batch()
            wall = float(time.perf_counter_ns() - start)
        path = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)[0]
        events = list(device_events(path))
    finally:
        engine._jitted = jitted
        shutil.rmtree(trace_dir, ignore_errors=True)
    scopes = op_scopes(jitted.lower(*captured["shapes"]).compile().as_text())

    per_op = collections.defaultdict(float)
    per_scope = collections.defaultdict(float)
    for name, _, duration in events:
        per_op[name] += duration
        scope = scopes.get(name, "escape_iterations"
                           if "escape_iterations" in name else "other")
        per_scope[scope] += duration
    busy = busy_ns(events)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:25]
    return {
        "scene": which, "width": width, "height": height, "ssaa": ssaa,
        "batch": batch, "device": jax.devices()[0].device_kind,
        "device_ms": sum(per_op.values()) / 1e6,
        "busy_ms": busy / 1e6, "wall_ms": wall / 1e6,
        "idle_share": 1.0 - busy / wall,
        "scopes_ms": {k: v / 1e6 for k, v in sorted(
            per_scope.items(), key=lambda kv: -kv[1])},
        "top_ops_ms": [(name, ms / 1e6, scopes.get(name, ""))
                       for name, ms in top],
    }


def report(result: dict) -> None:
    print(f"\n=== {result['scene']} {result['width']}x{result['height']} "
          f"ssaa={result['ssaa']} batch={result['batch']} on "
          f"{result['device']} (per-batch totals; /{result['batch']} per "
          f"frame) ===")
    print(f"device busy {result['busy_ms']:.3f} ms of the batch's "
          f"{result['wall_ms']:.3f} ms host wall (idle share "
          f"{result['idle_share']:.4f}; host capture of the batch included)")
    for scope, ms in result["scopes_ms"].items():
        print(f"  scope {scope:32s} {ms:10.3f} ms")
    for name, ms, scope in result["top_ops_ms"]:
        print(f"  op {name[:60]:60s} {ms:10.3f} ms  {scope}")


def main() -> None:
    args = sys.argv[1:]
    which = args[0] if args else "visualizer"
    width = int(args[1]) if len(args) > 1 else 1920
    height = int(args[2]) if len(args) > 2 else 1080
    ssaa = float(args[3]) if len(args) > 3 else 2.0
    batch = int(args[4]) if len(args) > 4 else 64
    result = trace_scene(which, width, height, ssaa, batch)
    report(result)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"trace_{which}.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
