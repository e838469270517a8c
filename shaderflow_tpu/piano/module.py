"""
ShaderPiano — MIDI piano roll as textures.

Role-equivalent of the reference piano module
(/root/reference/shaderflow/piano/module.py): notes live in an interval
tree keyed note -> second -> bucket; each frame scans notes in
[time, time + roll_time + lookahead] to fill four textures — the rolling
notes texture (MAX_NOTE x MAX_ROLLING RGBA32F of start/end/channel/velocity),
the pressed-keys velocity texture (smoothed by a second-order system), the
channel texture, and the tempo texture — plus a dynamically zooming visible
note range. MIDI loading uses the in-repo parser (piano/midi.py) instead of
pretty_midi; live synthesis hooks (FluidSynth) are kept as optional,
realtime-only stubs.
"""

from __future__ import annotations

import itertools
import shutil
from collections import deque
from pathlib import Path
from typing import Any, Iterable, Optional

import numpy as np

from shaderflow_tpu import logger
from shaderflow_tpu.module import ShaderModule
from shaderflow_tpu.ops.dynamics import DynamicNumber
from shaderflow_tpu.piano.midi import load_midi
from shaderflow_tpu.piano.notes import PianoNote
from shaderflow_tpu.texture import ShaderTexture
from shaderflow_tpu.variable import ShaderVariable, Uniform

MAX_CHANNELS = 32
MAX_ROLLING = 256
MAX_NOTE = 128


class ShaderPiano(ShaderModule):

    name: str = "iPiano"
    precompute: bool = True
    """Freewheel exports precompute the whole run's textures as device
    sequences (no per-frame host streaming); set False to force the
    reference's per-frame streamed path (testing / animated scene.speed)."""
    time_offset: float = 0.0
    roll_time: float = 2.0
    height: float = 0.275
    black_ratio: float = 0.6
    extra_keys: int = 6
    lookahead: float = 2.0
    release_before_end: float = 0.03

    def __init__(self, scene=None, name: str = "iPiano", **kwargs):
        self.tempo: deque[tuple[float, float]] = deque()
        self.tree: dict[int, dict[int, deque[PianoNote]]] = {}
        self.global_minimum_note: int = MAX_NOTE
        self.global_maximum_note: int = 0
        self.key_press_dynamics = DynamicNumber(
            value=np.zeros(MAX_NOTE, np.float32),
            frequency=4, zeta=0.4, response=0, precision=0)
        self.note_range_dynamics = DynamicNumber(
            value=np.zeros(2, np.float32),
            frequency=0.05, zeta=1 / (2 ** 0.5), response=0)
        self._playing_matrix: list[list[Optional[PianoNote]]] = \
            [[None] * MAX_CHANNELS for _ in range(MAX_NOTE)]
        self.fluidsynth: Any = None
        self.soundfont: Any = None
        self.soundfont_file: Any = None  # path to a .sf2 to auto-load live
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        scene = self.scene
        self.keys_texture = ShaderTexture(scene=scene, name=f"{self.name}Keys").from_numpy(
            self._empty_keys())
        self.channel_texture = ShaderTexture(scene=scene, name=f"{self.name}Chan").from_numpy(
            self._empty_keys())
        self.roll_texture = ShaderTexture(scene=scene, name=f"{self.name}Roll").from_numpy(
            self._empty_roll())
        self.tempo_texture = ShaderTexture(scene=scene, name=f"{self.name}Tempo").from_numpy(
            np.zeros((100, 1, 2), np.float32))

    @staticmethod
    def _empty_keys() -> np.ndarray:
        return np.zeros((1, MAX_NOTE), np.float32)

    @staticmethod
    def _empty_roll() -> np.ndarray:
        return np.zeros((MAX_NOTE, MAX_ROLLING, 4), np.float32)

    # -- data structure -------------------------------------------------------

    @property
    def lookup_time(self) -> float:
        return self.roll_time + self.lookahead

    @staticmethod
    def _ranges(start: float, end: float) -> range:
        return range(int(start), int(end) + 1)

    def clear(self) -> None:
        self.tree.clear()

    def add_note(self, note: Optional[PianoNote]) -> None:
        if note is None:
            return
        for index in self._ranges(note.start, note.end):
            self.tree.setdefault(note.note, {}).setdefault(index, deque()).append(note)
        self.update_global_ranges(note.note)

    @property
    def notes(self) -> Iterable[PianoNote]:
        for block in self.tree.values():
            for bucket in block.values():
                yield from bucket

    def __iter__(self):
        return iter(self.notes)

    @property
    def duration(self) -> float:
        return max((note.end for note in self.notes), default=0.0)

    def notes_between(self, index: int, start: float, end: float) -> Iterable[PianoNote]:
        seen = set()
        for second in self._ranges(start, end):
            for note in self.tree.get(index, {}).get(second, ()):
                if note.start > end or id(note) in seen:
                    continue
                seen.add(id(note))
                yield note

    def update_global_ranges(self, note: int) -> None:
        self.global_minimum_note = min(self.global_minimum_note, note)
        self.global_maximum_note = max(self.global_maximum_note, note)

    @property
    def maximum_velocity(self) -> Optional[int]:
        return max((note.velocity for note in self.notes), default=None)

    @property
    def minimum_velocity(self) -> Optional[int]:
        return min((note.velocity for note in self.notes), default=None)

    def normalize_velocities(self, minimum: int = 100, maximum: int = 100) -> None:
        hi, lo = self.maximum_velocity, self.minimum_velocity

        def remap(velocity: int) -> int:
            if hi != lo:
                return int((velocity - lo) / (hi - lo) * (maximum - minimum) + minimum)
            return int((maximum + minimum) / 2)

        for note in self.notes:
            note.velocity = remap(note.velocity)

    def setup(self) -> None:
        self._frame_index = 0
        # Live synthesis boots with realtime sessions only (reference
        # piano/module.py:291-328 gates on scene.realtime); fluid_start is a
        # no-op warning when pyfluidsynth is absent.
        if self.scene.realtime and not self.scene.freewheel and self.fluidsynth is None:
            self.fluid_start()
            if self.fluidsynth is not None and self.soundfont_file is not None:
                self.fluid_load(self.soundfont_file)

    def commands(self) -> None:
        self.register_command(self.midi_stats, "midi-stats")

    def midi_stats(self) -> None:
        """Print note/tempo statistics of the loaded MIDI file."""
        notes = list(self.notes)
        print(f"notes: {len(notes)}")
        print(f"note range: {self.global_minimum_note}-{self.global_maximum_note}")
        print(f"duration: {self.duration:.2f}s")
        print(f"tempo changes: {len(self.tempo)}")

    def load_midi(self, path) -> None:
        path = Path(path)
        if not path.exists():
            logger.warn(f"Input Midi file not found ({path})")
            return
        midi = load_midi(path)
        for note in midi.notes:
            self.add_note(PianoNote(
                note=note.pitch, start=note.start, end=note.end,
                channel=note.channel, velocity=note.velocity))
        for when, bpm in midi.tempo_changes:
            self.tempo.append((when, bpm))

        self.tempo_texture.clear()
        for offset, (when, bpm) in enumerate(self.tempo):
            if offset >= 100:
                break
            self.tempo_texture.write(
                data=np.array([when, bpm], np.float32),
                viewport=(0, offset, 1, 1))

    # -- offline whole-run precompute ------------------------------------------

    def _precompute_sequences(self) -> bool:
        """Freewheel exports: run the whole per-frame note scan up front and
        bind the three per-frame textures as DEVICE SEQUENCES (engine indexes
        them by iFrameIndex inside the render scan). Kills the 512 KB/frame
        roll-texture host stream that made 4K exports transfer-bound (the
        reference re-fills these textures every frame on the GL side,
        piano/module.py:202-277).

        Exact parity with the streamed path: the same scan logic runs at
        t_f = offset + f*speed/fps (the freewheel time series) and both
        dynamics ODEs step with the same dt from their setup() state. The
        smoothed note-range (a per-frame vec2 UNIFORM) is recorded and
        replayed by update(). Assumes constant scene.speed over the export —
        true for the CLI surface (speed is a scalar flag)."""
        scene = self.scene
        total = max(1, round(scene.runtime * scene.fps))
        speed = float(scene.speed)
        key = (total, scene.fps, speed, self.time_offset, self.roll_time,
               self.lookahead, self.release_before_end,
               sum(len(b) for blk in self.tree.values() for b in blk.values()),
               self.global_minimum_note, self.global_maximum_note)
        if getattr(self, "_sequence_key", None) != key:
            dt = abs(speed) / scene.fps
            keys_seq = np.empty((total, 1, MAX_NOTE, 1), np.float32)
            chan_seq = np.empty((total, 1, MAX_NOTE, 1), np.float32)
            roll_seq = np.empty((total, MAX_NOTE, MAX_ROLLING, 4), np.float32)
            ranges = np.empty((total, 2), np.float32)

            # Fresh ODE state, exactly as setup() leaves it
            self.key_press_dynamics.set(np.zeros(MAX_NOTE, np.float32))
            self.note_range_dynamics.set(np.zeros(2, np.float32))
            for f in range(total):
                time = self.time_offset + speed * f / scene.fps
                # scene.dt is set AFTER module updates (frame 0 renders at
                # t=0), so the streamed path steps frame 0 with dt == 0 —
                # replicate exactly
                roll, channels = self._scan_frame(time, dt if f else 0.0)
                # Storage row 0 = top: texture.write() receives GL bottom-up
                # rows, so the streamed matrix holds roll[::-1]
                roll_seq[f] = roll[::-1]
                chan_seq[f, 0, :, 0] = channels[0]
                keys_seq[f, 0, :, 0] = self.key_press_dynamics.value
                ranges[f] = self.note_range_dynamics.value
            self._sequence_key = key
            self._sequence_arrays = (keys_seq, chan_seq, roll_seq, ranges)
        keys_seq, chan_seq, roll_seq, ranges = self._sequence_arrays
        self.keys_texture.set_sequence(keys_seq)
        self.channel_texture.set_sequence(chan_seq)
        self.roll_texture.set_sequence(roll_seq)
        self._range_values = ranges
        logger.info(f"Precomputed {total} piano-roll frames as device "
                    f"sequences ({roll_seq.nbytes / 1e6:.0f} MB roll)")
        return True

    # -- per-frame scan (reference module.py:202-277) --------------------------

    def _scan_frame(self, time: float, dt: float):
        """One frame of the note scan: steps both dynamics, returns the
        (roll, channels) arrays for this frame. Shared by the realtime
        update() and the offline precompute."""
        upcoming: set[int] = set()

        self.key_press_dynamics.target.fill(0)
        roll = self._empty_roll()
        channels = self._empty_keys() - 1  # -1 = not playing

        for midi in range(self.global_minimum_note, self.global_maximum_note + 1):
            simultaneous = 0
            for note in self.notes_between(midi, time, time + self.lookup_time):
                upcoming.add(midi)
                if note.start >= time + self.roll_time:
                    continue
                if simultaneous < MAX_ROLLING:
                    roll[note.note, simultaneous] = (
                        note.start, note.end, note.channel, note.velocity)
                    simultaneous += 1
                if not (note.start <= time <= note.end):
                    continue

                # Shorten the perceived press so adjacent notes read twice
                too_small = (note.end - note.start) < self.release_before_end
                shorter = time < (note.end - self.release_before_end)
                if shorter or too_small:
                    self.key_press_dynamics.target[midi] = note.velocity
                channels[0][midi] = note.channel

                other = self._playing_matrix[midi][note.channel]
                if (other is None) or (other.end > note.end):
                    play_velocity = int(128 * ((note.velocity / 128) ** 0.5))
                    self.fluid_key_down(midi, play_velocity, note.channel)
                    self._playing_matrix[midi][note.channel] = note

            for channel in range(MAX_CHANNELS * self.scene.realtime):
                other = self._playing_matrix[midi][channel]
                if other and other.end < time:
                    self._playing_matrix[midi][channel] = None
                    self.fluid_key_up(midi, other.channel)

        # Dynamic zoom follows the lookahead window
        self.note_range_dynamics.frequency = 0.5 / self.lookup_time
        if self.note_range_dynamics.value.sum() == 0:
            self.note_range_dynamics.value[:] = (
                self.global_minimum_note, self.global_maximum_note)
        self.note_range_dynamics.target = np.array((
            min(upcoming, default=self.global_minimum_note),
            max(upcoming, default=self.global_maximum_note)), np.float32)

        self.note_range_dynamics.next(dt=dt)
        self.key_press_dynamics.next(dt=dt)
        return roll, channels

    def prewarm(self) -> None:
        if (self.scene.freewheel and self.precompute
                and (self.keys_texture.sequence is None
                     or getattr(self, "_range_values", None) is None)):
            self._precompute_sequences()

    def update(self) -> None:
        if self.scene.freewheel and self.precompute:
            if (self.keys_texture.sequence is None
                    or getattr(self, "_range_values", None) is None):
                self._precompute_sequences()
            index = min(self.scene._frame_counter, len(self._range_values) - 1)
            self.note_range_dynamics.value = self._range_values[index]
            return

        self.keys_texture.set_sequence(None)
        self.channel_texture.set_sequence(None)
        self.roll_texture.set_sequence(None)
        roll, channels = self._scan_frame(
            self.scene.time + self.time_offset, abs(self.scene.dt))
        self.keys_texture.write(data=self.key_press_dynamics.value.astype(np.float32))
        self.roll_texture.write(data=roll)
        self.channel_texture.write(data=channels.astype(np.float32))

    def ui(self):
        yield (f"notes {sum(1 for _ in self.notes)}  "
               f"range {self.global_minimum_note}-{self.global_maximum_note}")
        rng = self.note_range_dynamics.value
        yield f"visible {rng[0]:.1f}-{rng[1]:.1f}  roll {self.roll_time:.1f}s"
        yield f"synth: {'live' if self.fluidsynth else 'off'}"

    def pipeline(self) -> Iterable[ShaderVariable]:
        yield Uniform("int", f"{self.name}GlobalMin", self.global_minimum_note)
        yield Uniform("int", f"{self.name}GlobalMax", self.global_maximum_note)
        yield Uniform("vec2", f"{self.name}Dynamic", self.note_range_dynamics.value)
        yield Uniform("float", f"{self.name}RollTime", self.roll_time)
        yield Uniform("float", f"{self.name}Extra", self.extra_keys)
        yield Uniform("float", f"{self.name}Height", self.height)
        yield Uniform("int", f"{self.name}Limit", MAX_ROLLING)
        yield Uniform("float", f"{self.name}BlackRatio", self.black_ratio)

    # -- FluidSynth (optional, realtime only) ----------------------------------

    @staticmethod
    def fluid_install() -> None:
        if not shutil.which("fluidsynth"):
            logger.warn("FluidSynth binary not found; live MIDI synthesis is disabled")

    def fluid_start(self) -> None:
        try:
            import fluidsynth
        except ImportError:
            logger.warn("pyfluidsynth not installed; live MIDI synthesis is disabled")
            return
        self.fluidsynth = fluidsynth.Synth()
        self.fluidsynth.setting("synth.gain", 1.2)
        self.fluidsynth.start()

    def fluid_load(self, soundfont) -> None:
        if self.fluidsynth is not None:
            self.soundfont = self.fluidsynth.sfload(str(soundfont))
            for channel in range(MAX_CHANNELS):
                self.fluid_select(channel, 0, 0)

    def fluid_select(self, channel: int = 0, bank: int = 0, preset: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.program_select(channel, self.soundfont, bank, preset)

    def fluid_key_down(self, note: int, velocity: int = 127, channel: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.noteon(channel, note, velocity)

    def fluid_key_up(self, note: int, channel: int = 0) -> None:
        if self.fluidsynth and self.scene.realtime:
            self.fluidsynth.noteoff(channel, note)

    def fluid_all_notes_off(self) -> None:
        if self.fluidsynth and self.scene.realtime:
            for channel, note in itertools.product(range(MAX_CHANNELS), range(MAX_NOTE)):
                self.fluidsynth.noteoff(channel, note)
