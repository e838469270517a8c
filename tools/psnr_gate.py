"""
PSNR parity gate: the oracle-pinned scenes rendered through the real engine
on the current device, each compared with the independent NumPy GL
transcription (tools/gl_oracle.py).

The bars are those of tests/test_psnr_reference.py: >= 40 dB PSNR, or, for
the binary-output scenes (tetration's int-division k, waveform
thresholds), exact-pixel agreement, where transcendental/matmul ULPs flip
isolated boundary pixels at full amplitude.

All configs run in this one process (one JAX process per card). chip_smoke.py
calls oracle_check() for each config on the GPU.

Usage: python tools/psnr_gate.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "examples" / "basic"))
sys.path.insert(0, str(REPO / "examples" / "fractals"))
sys.path.insert(0, str(REPO / "examples"))

BAR_DB = 40.0

# name -> (scene key, width, height, ssaa, subsample, frames, scene kwargs)
ORACLE_CONFIGS = {
    "default (welcome) ssaa=1": ("basic", 512, 288, 1.0, 1, 3, {}),
    "default (welcome) ssaa=2": ("basic", 512, 288, 2.0, 2, 3, {}),
    "mandelbrot (escape kernel + tail)":
        ("mandelbrot", 320, 180, 2.0, 2, 2, {"quality": 5}),
    "raymarch (camera rays + SDF)": ("raymarch", 320, 180, 1.0, 1, 2, {}),
    "visualizer (flagship, blur level 4)":
        ("visualizer", 320, 180, 1.0, 1, 3, {}),
    "bars": ("bars", 320, 180, 1.0, 1, 3, {}),
    "tetration (binary k)": ("tetration", 320, 180, 1.0, 1, 2, {}),
    "waveform (binary thresholds)": ("waveform", 320, 180, 1.0, 1, 3, {}),
}
# Agreement bars (fraction of pixels, u8 tolerance per channel), as in
# test_tetration_parity and test_waveform_parity. Tetration's flips must
# also hug the oracle's own escape boundary: at most 5% (+3 px) of them
# may land off the 2px-dilated boundary.
AGREEMENT_BARS = {"tetration (binary k)": (0.99, 1),
                  "waveform (binary thresholds)": (0.995, 2)}
CHAOTIC_CONFIGS = {"tetration (binary k)"}


def scene_class(key: str):
    import demo
    import fractals
    import piano_roll
    return {
        "basic": demo.Basic,
        "visualizer": demo.Visualizer,
        "bars": demo.MusicBars,
        "waveform": demo.Waveform,
        "raymarch": demo.RayMarch,
        "mandelbrot": fractals.Mandelbrot,
        "julia": fractals.Julia,
        "tetration": fractals.Tetration,
        "pianoroll": piano_roll.PianoRoll,
    }[key]


def render_frames(key, width, height, ssaa, subsample, frames, kwargs):
    """Render `frames` frames through the real engine pipeline; return
    (frames u8 array, merged per-frame uniform dicts)."""
    scene = scene_class(key)(**kwargs)
    scene._setup_run(fps=10, time=frames / 10, freewheel=True,
                     width=width, height=height, ssaa=ssaa,
                     subsample=subsample)
    engine = scene.engine
    engine.begin_batch()
    for _ in range(frames):
        scene.next(dt=scene.frametime)
    uniforms = []
    for snapshot in engine._frame_uniforms:
        merged = dict(engine._statics)
        merged.update(snapshot)
        uniforms.append(merged)
    out = np.asarray(engine.flush(frames))
    return out, uniforms, scene


def _oracle_textures(engine, uniform) -> dict:
    """Engine texture state -> oracle handoff (engine matrices store
    row 0 = top; the oracle samples GL row-0-bottom storage)."""
    k = int(np.asarray(uniform.get("iFrameIndex", 0)))
    textures = {}
    if "background" in engine._static_tex:
        textures["background"] = np.asarray(
            engine._static_tex["background"])[0, 0][::-1]
    if "iSpectrogram" in engine._sequences:
        seq = np.asarray(engine._sequences["iSpectrogram"])
        textures["spectrogram"] = seq[min(k, len(seq) - 1)][:, 0, :][::-1]
    if "iWaveform" in engine._sequences:
        seq = np.asarray(engine._sequences["iWaveform"])
        textures["waveform"] = seq[min(k, len(seq) - 1)][0]
    return textures


def oracle_check(name: str) -> dict:
    """Render one ORACLE_CONFIGS entry and compare every frame with the
    oracle -> {"name", "metric", "value", "bar", "ok"} (worst frame)."""
    import gl_oracle
    key, w, h, ssaa, sub, n, kwargs = ORACLE_CONFIGS[name]
    frames, uniforms, scene = render_frames(key, w, h, ssaa, sub, n, kwargs)
    plain = {"basic": gl_oracle.default_fragment,
             "mandelbrot": gl_oracle.mandelbrot_fragment,
             "raymarch": gl_oracle.raymarch_fragment,
             "tetration": gl_oracle.tetration_fragment}
    textured = {"visualizer": gl_oracle.visualizer_fragment,
                "bars": gl_oracle.bars_fragment,
                "waveform": gl_oracle.waveform_fragment}
    agree_bar, tolerance = AGREEMENT_BARS.get(name, (None, 0))
    worst_psnr = float("inf")
    worst_agree = 1.0
    confined = True
    for index, uniform in enumerate(uniforms):
        merged = dict(uniform)
        if key == "mandelbrot":
            merged.setdefault("iQuality", merged.get("iQualityS", 0.05))
        if key in plain:
            fragment = plain[key]
        else:
            textures = _oracle_textures(scene.engine, uniform)
            base = textured[key]
            fragment = (lambda b, t: lambda u, ww, hh, a: b(u, ww, hh, a, t))(
                base, textures)
        oracle = gl_oracle.render_scene(
            fragment, merged, *scene.render_resolution,
            w, h, sub, scene.aspect_ratio)
        worst_psnr = min(worst_psnr, gl_oracle.psnr(frames[index], oracle))
        diff = np.abs(frames[index].astype(np.int16) - oracle.astype(np.int16))
        disagree = diff.max(-1) > tolerance
        worst_agree = min(worst_agree, 1.0 - float(disagree.mean()))
        if name in CHAOTIC_CONFIGS:
            k_field = (oracle[..., 0] > 127).astype(np.int16)
            pad = np.pad(k_field, 2, mode="edge")
            stacked = np.stack([pad[dy:dy + h, dx:dx + w]
                                for dy in range(5) for dx in range(5)])
            boundary = stacked.min(0) != stacked.max(0)
            stray = int((disagree & ~boundary).sum())
            confined &= stray <= disagree.sum() * 0.05 + 3
    if agree_bar is not None:
        return {"name": name, "metric": f"agree(<= {tolerance} u8)",
                "value": worst_agree, "bar": agree_bar,
                "ok": worst_agree >= agree_bar and confined}
    return {"name": name, "metric": "psnr_db", "value": worst_psnr,
            "bar": BAR_DB, "ok": worst_psnr >= BAR_DB}


def main() -> None:
    import jax
    device = jax.devices()[0]
    print(f"device: {device.platform} {device.device_kind}")
    failed = []
    for name in ORACLE_CONFIGS:
        result = oracle_check(name)
        print(f"{name}: {result['metric']} {result['value']} "
              f"(bar {result['bar']}) {'ok' if result['ok'] else 'FAILED'}",
              flush=True)
        if not result["ok"]:
            failed.append(name)
    if failed:
        print(f"GATE FAILED: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
