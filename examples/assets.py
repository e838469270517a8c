"""
Procedurally generated example assets.

The reference downloads wallpapers/videos/music at runtime
(/root/reference/examples/basic/demo.py:16-49, pooch URLs); this environment
has zero egress, so equivalent assets are synthesized once into
examples/assets/ — a music-like WAV (chords, bass line, hat/kick
transients) and a MIDI arpeggio — or, for the painterly background image,
computed in memory.
"""

from __future__ import annotations

import functools
import wave
from pathlib import Path

import numpy as np

def _assets_dir() -> Path:
    """Where generated assets land: next to this file in a source tree,
    falling back to the user data dir when this file lives inside a
    read-only install (the wheel bundles examples under
    shaderflow_tpu/resources/examples — site-packages may not be
    writable)."""
    local = Path(__file__).parent / "assets"
    try:
        local.mkdir(parents=True, exist_ok=True)
        probe = local / ".writable"
        probe.touch()
        probe.unlink()
        return local
    except OSError:
        import shaderflow_tpu
        return (shaderflow_tpu.directories.ensure().user_data_path
                / "example-assets")


ASSETS = _assets_dir()


@functools.lru_cache(maxsize=1)
def background_array(size=(1920, 1080)) -> np.ndarray:
    """The painterly background as a read-only (H, W, 3) uint8 array, made
    deterministically from a fixed seed (no image file or decoder needed)."""
    rng = np.random.default_rng(7)
    width, height = size
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = x / width, y / height

    # Layered smooth gradients + sinusoidal "nebula" bands + star field
    r = 0.25 + 0.3 * np.sin(3 * u + 1.5) * np.cos(2 * v) + 0.25 * v
    g = 0.15 + 0.25 * np.sin(2.5 * u + 4.0) * np.sin(3 * v + 1.0) + 0.15 * (1 - v)
    b = 0.35 + 0.3 * np.cos(2 * u * v * 4.0) + 0.25 * np.sin(5 * v + 2.0) * 0.3
    rgb = np.stack([r, g, b], axis=-1)

    for _ in range(4):  # soft blobs
        cx, cy = rng.uniform(0.1, 0.9, 2)
        radius = rng.uniform(0.1, 0.35)
        color = rng.uniform(0.0, 0.5, 3)
        dist = np.sqrt(((u - cx) * (width / height)) ** 2 + (v - cy) ** 2)
        rgb += color * np.exp(-(dist / radius) ** 2)[..., None]

    stars = rng.random((height, width)) > 0.9995
    rgb[stars] = 1.0
    rgb = np.clip(rgb, 0, 1)

    image = (rgb * 255).astype(np.uint8)
    image.flags.writeable = False
    return image


def music_wav(path: Path = ASSETS / "music.wav", seconds: float = 10.0,
              samplerate: int = 44100) -> Path:
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * samplerate)) / samplerate
    audio = np.zeros((len(t), 2), np.float32)

    # Chord progression (Am - F - C - G), one bar each at 120 bpm
    chords = [[220.0, 261.63, 329.63], [174.61, 220.0, 261.63],
              [130.81, 164.81, 196.0], [196.0, 246.94, 293.66]]
    bar = 2.0
    for index, chord in enumerate(chords * int(np.ceil(seconds / (bar * 4)))):
        start = index * bar
        if start >= seconds:
            break
        mask = (t >= start) & (t < start + bar)
        phase = t[mask] - start
        envelope = np.exp(-phase * 0.8) * 0.15
        for j, freq in enumerate(chord):
            tone = envelope * np.sin(2 * np.pi * freq * phase)
            audio[mask, 0] += tone * (0.8 if j % 2 else 1.0)
            audio[mask, 1] += tone * (1.0 if j % 2 else 0.8)

    # Kick every beat, hat on off-beats, bass line
    beat = 0.5
    for k in range(int(seconds / beat)):
        start = k * beat
        mask = (t >= start) & (t < start + 0.15)
        phase = t[mask] - start
        kick = 0.6 * np.exp(-phase * 30) * np.sin(2 * np.pi * (60 + 40 * np.exp(-phase * 50)) * phase)
        audio[mask] += kick[:, None]
        if k % 2 == 1:
            hmask = (t >= start) & (t < start + 0.05)
            noise = 0.08 * np.exp(-(t[hmask] - start) * 80)
            audio[hmask] += (noise * np.random.default_rng(k).uniform(-1, 1, hmask.sum()))[:, None]
    bass_freq = 55.0
    audio[:, 0] += 0.12 * np.sin(2 * np.pi * bass_freq * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t / 4))
    audio[:, 1] += 0.12 * np.sin(2 * np.pi * bass_freq * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t / 4))

    audio = np.clip(audio, -1, 1)
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(2)
        handle.setsampwidth(2)
        handle.setframerate(samplerate)
        handle.writeframes((audio * 32767).astype("<i2").tobytes())
    return path


def video_file(path: Path = ASSETS / "clip.mp4", seconds: float = 2.0,
               size=(320, 180), fps: float = 30.0) -> Path:
    """A small synthetic clip (animated plasma) for the Video texture demo."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    import cv2
    width, height = size
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    for frame in range(int(seconds * fps)):
        t = frame / fps
        r = 0.5 + 0.5 * np.sin(x / 23 + 4 * t)
        g = 0.5 + 0.5 * np.sin(y / 17 - 3 * t + 2)
        b = 0.5 + 0.5 * np.sin((x + y) / 31 + t)
        rgb = (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)  # BGR for cv2
        writer.write(rgb)
    writer.release()
    return path


def midi_file(path: Path = ASSETS / "arpeggio.mid", seconds: float = 10.0) -> Path:
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    from shaderflow_tpu.piano.midi import MidiNote, write_midi

    notes = []
    scale = [57, 60, 64, 67, 69, 72, 76, 79]  # A minor-ish arpeggio
    step = 0.25
    for k in range(int(seconds / step)):
        pitch = scale[k % len(scale)] + (12 if (k // 16) % 2 else 0)
        notes.append(MidiNote(pitch=pitch, start=k * step, end=k * step + step * 0.9,
                              channel=k % 2, velocity=70 + (k * 7) % 50))
    # A sustained bass layer
    for k in range(int(seconds / 2)):
        notes.append(MidiNote(pitch=45 + (k % 3) * 5, start=k * 2.0, end=k * 2.0 + 1.8,
                              channel=2, velocity=90))
    return write_midi(path, notes)
