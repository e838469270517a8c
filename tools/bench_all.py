"""
Run every graded benchmark config (BASELINE.md) through bench.py on the GPU
and print a table — one subprocess per config, one after another, so
device/jit state is isolated and only one JAX process holds the card.

Usage: python tools/bench_all.py [--quick]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent

CONFIGS = [
    ("basic 512x288@30", dict(BENCH_SCENE="basic", BENCH_WIDTH="512",
                              BENCH_HEIGHT="288", BENCH_FPS="30", BENCH_SSAA="1.0")),
    ("bars 1280x720@30", dict(BENCH_SCENE="bars", BENCH_WIDTH="1280",
                              BENCH_HEIGHT="720", BENCH_FPS="30", BENCH_SSAA="1.0")),
    ("visualizer 1920x1080@60 2xSSAA", dict(BENCH_SCENE="visualizer")),
    ("mandelbrot 1920x1080@60 2xSSAA", dict(BENCH_SCENE="mandelbrot")),
    ("raymarch 1920x1080@60", dict(BENCH_SCENE="raymarch", BENCH_SSAA="1.0")),
    ("pianoroll 3840x2160@60", dict(BENCH_SCENE="pianoroll", BENCH_WIDTH="3840",
                                    BENCH_HEIGHT="2160", BENCH_SSAA="1.0",
                                    BENCH_BATCH="64")),
]


def main() -> None:
    quick = "--quick" in sys.argv
    rows = []
    for name, overrides in CONFIGS:
        env = dict(os.environ, **overrides)
        if quick:
            env.setdefault("BENCH_SECONDS", "3")
        print(f"== {name} ==", file=sys.stderr, flush=True)
        proc = subprocess.run([sys.executable, str(REPO / "bench.py")],
                              env=env, capture_output=True, text=True)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            result = json.loads(line)
        except json.JSONDecodeError:
            print(proc.stderr[-2000:], file=sys.stderr)
            rows.append((name, None))
            continue
        rows.append((name, result))
        print(line, file=sys.stderr, flush=True)

    device = next((r["detail"]["device"] for _, r in rows if r), "?")
    print(f"Export to a null sink, warm, on {device}:\n")
    print("| Config | Export fps | Realtime x |")
    print("|---|---|---|")
    for name, result in rows:
        if result is None:
            print(f"| {name} | FAILED | — |")
            continue
        print(f"| {name} | {result['value']} "
              f"| {result['detail']['realtime_multiple']}x |")
    if any(result is None for _, result in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
