"""
Piano-roll MIDI visualizer — graded config #5 (BASELINE.md: "MIDI + audio
spectrogram -> 4K60 export, full A/V mux").

Falling-notes piano visualizer in the style the reference's piano module
feeds (the author's Pianola project): the bottom band is a keyboard lit by
the smoothed key-press velocities, above it notes fall through the
roll-time window, colored per MIDI channel; a subtle audio-spectrogram glow
backs the scene. All data arrives through the ShaderPiano textures
(iPianoRoll / iPianoKeys / iPianoChan) and the audio modules.
"""

import sys
from pathlib import Path

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent.parent))
import assets

from shaderflow_tpu import ops
from shaderflow_tpu.ops import clamp, mix, smoothstep, vec2, vec4
from shaderflow_tpu.scene import ShaderScene

CHANNEL_COLORS = [
    (0.95, 0.45, 0.25), (0.30, 0.70, 0.95), (0.55, 0.90, 0.45),
    (0.90, 0.80, 0.30), (0.80, 0.40, 0.90), (0.40, 0.90, 0.80),
]


def piano_roll_frag(sf):
    """Line formulation: every lookup depends on the COLUMN only (the key
    under x) and every time term on the ROW only, so all texture reads are
    1D line gathers (thousands, not millions) — and the 2D image is pure
    broadcast combination in the tail stage (ops/tailfuse.py)."""
    from shaderflow_tpu.ops import tailfuse
    MAX_SLOTS = 8  # simultaneous notes per key checked per pixel

    dynamic = sf.iPianoDynamic                      # smoothed (min, max) note
    extra = sf.iPianoExtra
    lo = dynamic[0] - extra
    hi = dynamic[1] + extra
    span = hi - lo + 1.0

    ax = sf.astuv[0, :, 0]                          # (W,) column line
    key_f = lo + ax * span                          # (W,) fractional note
    key = jnp.floor(key_f).astype(jnp.int32)
    key_frac = key_f - key

    black = ops.is_black_key(key)                   # (W,)
    kb_height = sf.iPianoHeight

    keys_tex = sf.tex("iPianoKeys")
    chan_tex = sf.tex("iPianoChan")
    roll_tex = sf.tex("iPianoRoll")

    zero = jnp.zeros_like(key)
    velocity = sf.texel_fetch(keys_tex, jnp.stack([key, zero], axis=-1))[..., 0]
    channel = sf.texel_fetch(chan_tex, jnp.stack([key, zero], axis=-1))[..., 0]
    pressed = clamp(velocity / 128.0, 0.0, 1.0)     # (W,)

    palette = jnp.array(CHANNEL_COLORS, jnp.float32)
    chan_color = palette[jnp.clip(channel.astype(jnp.int32), 0, len(CHANNEL_COLORS) - 1)]

    # ---- keyboard band line (per-column color; felt strip in-kernel) ----
    white_color = jnp.where(black[..., None], 0.12, 0.92)        # (W, 3)
    border = smoothstep(0.0, 0.08, key_frac) * smoothstep(1.0, 0.92, key_frac)
    kb_line = white_color * border[..., None]
    kb_line = mix(kb_line, chan_color, pressed[..., None] * 0.85)  # (W, 3)

    edge = (smoothstep(0.02, 0.12, key_frac)
            * smoothstep(0.98, 0.88, key_frac))                    # (W,)

    # ---- per-slot note lines: start/end times, masked brightness, color ----
    inputs = {}
    for slot in range(MAX_SLOTS):
        data = sf.texel_fetch(roll_tex, jnp.stack(
            [jnp.full_like(key, slot), key], axis=-1))             # (W, 4)
        start, end = data[..., 0], data[..., 1]
        chan, vel = data[..., 2], data[..., 3]
        color = palette[jnp.clip(chan.astype(jnp.int32), 0, len(CHANNEL_COLORS) - 1)]
        # vel > 0 gating folds into the brightness line (0 = inactive slot)
        brightness = jnp.where(
            vel > 0, 0.55 + 0.45 * clamp(vel / 128.0, 0.0, 1.0), 0.0)
        inputs[f"s{slot}a"] = tailfuse.Col(start)
        inputs[f"s{slot}b"] = tailfuse.Col(end)
        inputs[f"s{slot}v"] = tailfuse.Col(brightness)
        inputs[f"s{slot}r"] = tailfuse.Col(color[:, 0])
        inputs[f"s{slot}g"] = tailfuse.Col(color[:, 1])
        inputs[f"s{slot}c"] = tailfuse.Col(color[:, 2])

    # ---- background glow + octave guide lines ----
    from shaderflow_tpu.ops.sampling import sample_separable
    spec = sample_separable(sf.tex("iSpectrogram"), jnp.full((1,), 0.5), ax)  # (W, 1, C)
    glow = jnp.sqrt(jnp.maximum(spec[:, 0, 0] + spec[:, 0, 1], 0.0) / 1000.0)  # (W,)
    is_c = ((jnp.mod(key, 12) == 0) & (key_frac < 0.06)).astype(jnp.float32)

    def tail(tp):
        def sstep(edge0, edge1, x):
            t = clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
            return t * t * (3.0 - 2.0 * t)

        ay = tp.astuv_y
        kbh = tp.scalar("kbh")
        rolltime = tp.scalar("rolltime")
        t_row = tp.scalar("time") + (ay - kbh) / (1.0 - kbh) * rolltime
        ramp = 0.02 * rolltime
        edge_c = tp.col("edge")

        note = [jnp.zeros_like(ay), jnp.zeros_like(ay), jnp.zeros_like(ay)]
        hit = jnp.zeros_like(ay)
        for slot in range(MAX_SLOTS):
            start = tp.col(f"s{slot}a")
            end = tp.col(f"s{slot}b")
            bright = tp.col(f"s{slot}v")
            active = (bright > 0.0) & (start <= t_row) & (t_row <= end)
            body = edge_c * sstep(0.0, ramp, t_row - start) \
                * sstep(0.0, ramp, end - t_row)
            contrib = jnp.where(active, body * bright, 0.0)
            note[0] = note[0] + tp.col(f"s{slot}r") * contrib
            note[1] = note[1] + tp.col(f"s{slot}g") * contrib
            note[2] = note[2] + tp.col(f"s{slot}c") * contrib
            hit = jnp.maximum(hit, jnp.where(active, body, 0.0))

        glow_term = tp.col("glow") * (1.0 - ay) * 0.5
        bg = [0.02 + 0.05 * (1.0 - ay) + 0.10 * glow_term,
              0.03 + 0.07 * (1.0 - ay) + 0.05 * glow_term,
              0.05 + 0.12 * (1.0 - ay) + 0.20 * glow_term]
        octave = tp.col("isc") * 0.03
        bg = [b + octave for b in bg]

        felt = (sstep(kbh - 0.012, kbh - 0.008, ay)
                * sstep(kbh, kbh - 0.004, ay))
        felt_rgb = (0.8, 0.1, 0.15)
        in_keyboard = ay < kbh
        out = []
        for c in range(3):
            roll_c = jnp.where(hit > 0.0, note[c] + bg[c] * 0.3,
                               bg[c] + note[c])
            kb_c = tp.col(f"kb{c}") * (1.0 - felt) + felt_rgb[c] * felt
            out.append(clamp(jnp.where(in_keyboard, kb_c, roll_c), 0.0, 1.0))
        return out

    return sf.tail(
        tail,
        edge=tailfuse.Col(edge), glow=tailfuse.Col(glow),
        isc=tailfuse.Col(is_c),
        kb0=tailfuse.Col(kb_line[:, 0]), kb1=tailfuse.Col(kb_line[:, 1]),
        kb2=tailfuse.Col(kb_line[:, 2]),
        kbh=kb_height, rolltime=sf.iPianoRollTime, time=sf.iTime,
        **inputs)


class PianoRoll(ShaderScene):
    """Falling-notes MIDI piano visualizer with audio spectrogram glow"""
    midi_file = None
    audio_file = None

    def build(self):
        from shaderflow_tpu.audio import ShaderAudio
        from shaderflow_tpu.audio.spectrogram import ShaderSpectrogram
        from shaderflow_tpu.piano import PianoNote, ShaderPiano

        self.piano = ShaderPiano(scene=self)
        self.piano.load_midi(self.midi_file or assets.midi_file())
        self.audio = ShaderAudio(scene=self, name="iAudio",
                                 file=self.audio_file or assets.music_wav())
        self.spectrogram = ShaderSpectrogram(scene=self, length=0, audio=self.audio,
                                             smooth=True)
        self.spectrogram.from_notes(
            start=PianoNote.from_frequency(20.0),
            end=PianoNote.from_frequency(10000.0),
            piano=True,
        )
        self.shader.fragment = piano_roll_frag


SCENES = [PianoRoll]

if __name__ == "__main__":
    from shaderflow_tpu.cli import launch
    launch(SCENES)
