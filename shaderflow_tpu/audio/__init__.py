"""
Audio subsystem: rolling buffers, file streaming, reactive level uniforms.

Role-equivalent of the reference audio module
(/root/reference/shaderflow/audio/module.py): BrokenAudio keeps a rolling
(channels, samples) buffer fed either from a file (FFmpeg/wave PCM stream
chunked by the frame dt) or a soundcard recorder (optional dependency);
ShaderAudio adds smoothed iAudioVolume / iAudioSTD uniforms and reports the
file duration as the scene runtime.

Device-first difference: in offline (freewheel) file mode the whole file is
decoded up front — downstream DSP (spectrogram, waveform) batches the
entire export into single device programs instead of per-frame CPU FFTs
(SURVEY.md §5 "long-context" mapping).
"""

from __future__ import annotations

import math
import os
from enum import Enum
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from shaderflow_tpu import logger
from shaderflow_tpu.dynamics import ShaderDynamics
from shaderflow_tpu.io.ffmpeg import AudioReader, FFmpeg
from shaderflow_tpu.module import ShaderModule


def root_mean_square(data) -> float:
    return float(np.sqrt(np.mean(np.square(data)))) if np.size(data) else 0.0


class AudioMode(Enum):
    Realtime = "realtime"
    File = "file"


class BrokenAudio:
    """Rolling audio buffer + device-independent sources."""

    def __init__(self, *, file=None, mode: AudioMode = AudioMode.Realtime,
                 samplerate: float = 44100, channels: int = 2,
                 buffer_seconds: float = 30.0, dtype=np.float32):
        self.mode = AudioMode(mode)
        self.dtype = np.dtype(dtype)
        self._samplerate = samplerate
        self._channels = channels
        self._buffer_seconds = buffer_seconds
        self.tell: int = 0

        self._file: Optional[Path] = None
        self._file_reader: Optional[AudioReader] = None
        self._file_stream = None
        self.full_data: Optional[np.ndarray] = None  # (C, S) whole file, offline mode

        self.recorder = None
        self.recorder_device = None
        self.speaker = None
        self.speaker_device = None

        self.create_buffer()
        if file is not None:
            self.file = file

    # -- buffer --------------------------------------------------------------

    @property
    def samplerate(self) -> float:
        return self._samplerate or 44100

    @samplerate.setter
    def samplerate(self, value: float) -> None:
        self._samplerate = value
        self.create_buffer()

    @property
    def channels(self) -> int:
        return self._channels or 2

    @channels.setter
    def channels(self, value: int) -> None:
        self._channels = value
        self.create_buffer()

    @property
    def buffer_seconds(self) -> float:
        return self._buffer_seconds

    @buffer_seconds.setter
    def buffer_seconds(self, value: float) -> None:
        self._buffer_seconds = value
        self.create_buffer()

    @property
    def buffer_size(self) -> int:
        return int(self.samplerate * self.buffer_seconds)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.channels, self.buffer_size)

    def create_buffer(self) -> None:
        # Doubled backing store + write cursor: the classic np.roll ring
        # (the reference's add_data, audio/module.py:113-129) memmoves the
        # WHOLE 30 s buffer every chunk (~10 MB -> ~4 ms/frame at 1080p60
        # realtime, a quarter of the frame budget). Appending at a cursor
        # and re-anchoring once per buffer-length of samples makes the
        # amortized cost one chunk copy; `data` stays a zero-copy VIEW of
        # the newest buffer_size samples, so every consumer (negative
        # slicing, waveform reshapes) sees exactly the rolled layout.
        # _ring_size is the store's OWN window size — never recomputed from
        # samplerate/buffer_seconds, so a field assigned between now and the
        # next create_buffer() (e.g. open_recorder setting _samplerate
        # before it rebuilds) cannot desync the view into emptiness.
        self._ring_size = self.buffer_size
        self._store = np.zeros((self.channels, 2 * self._ring_size),
                               dtype=self.dtype)
        self._cursor = self._ring_size

    @property
    def data(self) -> np.ndarray:
        return self._store[:, self._cursor - self._ring_size:self._cursor]

    @data.setter
    def data(self, value) -> None:
        self._store[:, self._cursor - self._ring_size:self._cursor] = value

    def add_data(self, data: np.ndarray) -> Optional[np.ndarray]:
        """Roll-append new (channels, length) samples."""
        data = np.asarray(data, dtype=self.dtype)
        if data.ndim == 1:
            data = np.tile(data, (self.channels, 1))
        if data.shape[0] != self._store.shape[0]:
            self.create_buffer()  # channel count changed without a rebuild
        length = data.shape[1]
        size = self._ring_size
        if length >= size:
            self._store[:, :size] = data[:, -size:]
            self._cursor = size
        else:
            if self._cursor + length > self._store.shape[1]:
                # Re-anchor: slide the live window back to the front
                # (amortized: once per buffer_seconds of audio)
                self._store[:, :size] = \
                    self._store[:, self._cursor - size:self._cursor]
                self._cursor = size
            self._store[:, self._cursor:self._cursor + length] = data
            self._cursor += length
        self.tell += length
        return data

    def get_data_between_samples(self, start: int, end: int) -> np.ndarray:
        return self.data[:, int(start):int(end)]

    def get_data_between_seconds(self, start: float, end: float) -> np.ndarray:
        return self.get_data_between_samples(start * self.samplerate, end * self.samplerate)

    def get_last_n_samples(self, n: int, *, offset: int = 0) -> np.ndarray:
        if self.full_data is not None:
            # Offline mode: window ends at the cursor (same trailing-sample
            # convention as the rolling-buffer slice), zero-filled pre-start
            end = int(self.tell - offset - 1)
            start = end - int(n)
            out = np.zeros((self.channels, int(n)), dtype=self.dtype)
            lo, hi = max(0, start), max(0, min(end, self.full_data.shape[1]))
            if hi > lo:
                out[:, lo - start:hi - start] = self.full_data[:, lo:hi]
            return out
        return self.data[:, -(int(n + offset) + 1):-(int(offset) + 1)]

    def get_last_n_seconds(self, n: float) -> np.ndarray:
        return self.get_last_n_samples(int(n * self.samplerate))

    # -- file source ----------------------------------------------------------

    @property
    def file(self) -> Optional[Path]:
        return self._file

    @file.setter
    def file(self, value) -> None:
        if value is None:
            return
        self._file = Path(value)
        if not self._file.exists():
            logger.warn(f"Audio File doesn't exist ({value})")
            return
        self._samplerate = FFmpeg.get_audio_samplerate(self._file) or 44100
        self._channels = FFmpeg.get_audio_channels(self._file) or 2
        self.create_buffer()
        self._file_reader = AudioReader(path=self._file)
        self._file_stream = self._file_reader.stream
        self.mode = AudioMode.File
        self.close_recorder()

    def load_full_file(self) -> Optional[np.ndarray]:
        """Decode the entire file -> (C, S) float32 (offline exports)."""
        if self.full_data is None and self._file is not None and self._file.exists():
            samples = FFmpeg.get_audio_numpy(self._file)
            if samples is not None:
                self.full_data = np.ascontiguousarray(samples.T)
        return self.full_data

    # -- realtime devices (soundcard when installed, else in-repo SDL) ---------
    #
    # The reference records through the `soundcard` package exclusively
    # (audio/module.py:98-99,354-379). Here that package is the preferred
    # backend, but when it is absent the realtime path does NOT degrade to
    # a warning: shaderflow_tpu.audio.sdlaudio speaks the same API over
    # SDL2 (bundled with pygame, incl. its own libpulse), so capture still
    # flows through a real OS audio stack.

    @staticmethod
    def _backend():
        """The active realtime-audio backend module, or None. Env override:
        SHADERFLOW_AUDIO_BACKEND=soundcard|sdl|none."""
        choice = (os.environ.get("SHADERFLOW_AUDIO_BACKEND") or "").lower()
        if choice == "none":
            return None
        if choice != "sdl":
            try:
                import soundcard
                return soundcard
            except Exception as error:
                if choice == "soundcard":
                    logger.warn(f"soundcard backend requested but unavailable ({error})")
                    return None
        try:
            from shaderflow_tpu.audio import sdlaudio
            sdlaudio._init_sdl_audio()  # probe: raises if pygame/SDL missing
            return sdlaudio
        except Exception as error:
            logger.debug(f"SDL audio backend unavailable: {error}")
            return None

    @staticmethod
    def recorders() -> Iterable:
        backend = BrokenAudio._backend()
        if backend is not None:
            yield from backend.all_microphones(include_loopback=True)

    @staticmethod
    def speakers() -> Iterable:
        backend = BrokenAudio._backend()
        if backend is not None:
            yield from backend.all_speakers()

    def open_recorder(self, name: Optional[str] = None, *, samplerate: float = 44100,
                      channels=None, blocksize: int = 512) -> "BrokenAudio":
        backend = self._backend()
        if backend is None:
            logger.warn("no realtime audio backend (neither 'soundcard' nor "
                        "pygame/SDL importable); recorder not opened")
            return self
        self.close_recorder()
        try:
            if name is None:
                for device in self.recorders():
                    if getattr(device, "isloopback", False):
                        self.recorder_device = device
                        break
                self.recorder_device = self.recorder_device or backend.default_microphone()
            else:
                matches = [d for d in self.recorders()
                           if name.lower() in (d.name or "").lower()]
                self.recorder_device = matches[0] if matches else backend.default_microphone()
            self.recorder = self.recorder_device.recorder(
                samplerate=samplerate, channels=channels,
                blocksize=blocksize).__enter__()
        except Exception as error:
            # Warn-and-degrade, never crash a realtime session: the scene
            # keeps running without capture (reference behavior when the
            # sound server is absent, audio/module.py:29-54)
            logger.warn(f"Could not open recorder "
                        f"{getattr(self.recorder_device, 'name', None)!r}: {error}")
            self.recorder = None
            return self
        self._samplerate = getattr(self.recorder, "_samplerate", samplerate)
        self._channels = getattr(self.recorder_device, "channels", 2)
        self.create_buffer()
        self.mode = AudioMode.Realtime
        return self

    def close_recorder(self) -> "BrokenAudio":
        if self.recorder is not None:
            try:
                self.recorder.__exit__(None, None, None)
            except Exception:
                pass
        self.recorder = None
        return self

    def open_speaker(self, name: Optional[str] = None, *, samplerate=None) -> "BrokenAudio":
        backend = self._backend()
        if backend is None:
            logger.warn("no realtime audio backend (neither 'soundcard' nor "
                        "pygame/SDL importable); speaker not opened")
            return self
        self.close_speaker()
        try:
            self.speaker_device = backend.default_speaker() if name is None else next(
                (d for d in self.speakers()
                 if name.lower() in (d.name or "").lower()),
                backend.default_speaker())
            self.speaker = self.speaker_device.player(
                samplerate=samplerate or self.samplerate).__enter__()
        except Exception as error:
            logger.warn(f"Could not open speaker "
                        f"{getattr(self.speaker_device, 'name', None)!r}: {error}")
            self.speaker = None
        return self

    def close_speaker(self) -> "BrokenAudio":
        if self.speaker is not None:
            try:
                self.speaker.__exit__(None, None, None)
            except Exception:
                pass
        self.speaker = None
        return self

    def record(self, numframes: Optional[int] = None) -> Optional[np.ndarray]:
        if self.recorder is not None:
            return self.add_data(self.recorder.record(numframes=numframes).T)
        return None

    def play(self, data: np.ndarray) -> None:
        if self.speaker is not None:
            try:
                self.speaker.play(np.asarray(data).T)
            except Exception:
                pass

    # -- properties -----------------------------------------------------------

    @property
    def stereo(self) -> bool:
        return self.channels == 2

    @property
    def mono(self) -> bool:
        return self.channels == 1

    @property
    def duration(self) -> float:
        if self.mode == AudioMode.File and self._file is not None:
            return FFmpeg.get_audio_duration(self._file) or 0.0
        return math.inf


class ShaderAudio(BrokenAudio, ShaderModule):
    """Audio as a scene module: iAudioVolume (2*RMS*sqrt2 of the last 0.1 s,
    integrated) and iAudioSTD uniforms, file input hooked into the export
    mux, duration driving the scene runtime."""

    final: bool = True

    def __init__(self, scene=None, name: str = "iAudio", *, file=None, **kwargs):
        BrokenAudio.__init__(self, file=file)
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)
        self.volume = ShaderDynamics(
            scene=self.scene, name=f"{self.name}Volume",
            frequency=2, zeta=1, response=0, value=0, integrate=True)
        self.std = ShaderDynamics(
            scene=self.scene, name=f"{self.name}STD",
            frequency=10, zeta=1, response=0, value=0)

    def ui(self):
        yield f"mode {self.mode.name}  {self.samplerate:.0f} Hz x{self.channels}"
        if self._file is not None:
            yield f"file {self._file.name}  {self.duration:.1f}s"
        yield (f"volume {float(self.volume.value):.3f}  "
               f"std {float(self.std.value):.3f}")

    def commands(self) -> None:
        # Reference audio/module.py:423-428: device listing commands
        self.register_command(self.print_recorders)
        self.register_command(self.print_speakers)

    def print_recorders(self) -> None:
        """List available audio capture devices."""
        try:
            for device in self.recorders():
                print(f"recorder: {device.name}")
        except Exception as error:
            print(f"no audio backend available ({error})")

    def print_speakers(self) -> None:
        """List available audio playback devices."""
        try:
            for device in self.speakers():
                print(f"speaker: {device.name}")
        except Exception as error:
            print(f"no audio backend available ({error})")

    @property
    def duration(self) -> float:
        if self._file is None:
            return 0.0
        return FFmpeg.get_audio_duration(self._file) or 0.0

    def setup(self) -> None:
        if self._file is not None:
            self.file = self._file  # re-open the stream for a fresh run
            if self.scene.freewheel:
                self.load_full_file()
        if self.final and self.scene.realtime:
            if self.mode == AudioMode.File:
                self.open_speaker()
            else:
                self.open_recorder()

    def ffhook(self, ffmpeg: FFmpeg) -> None:
        if self._file is not None and self._file.exists():
            ffmpeg.input(path=self._file)
            ffmpeg.shortest = True

    def update(self) -> None:
        # Offline fast path: the whole file is in memory — advance the
        # cursor directly instead of shifting the 30 s rolling buffer
        # (a ~10 MB memmove per frame on the host hot loop)
        if self.full_data is not None and self.scene.freewheel:
            self.tell = min(int(round(self.scene.time * self.samplerate)),
                            self.full_data.shape[1])
            start = max(0, self.tell - int(0.1 * self.samplerate))
            window = self.full_data[:, start:self.tell]
        else:
            # File mode: consume exactly rdt seconds (time-accurate reader)
            if self._file_stream is not None:
                try:
                    self._file_reader.chunk = self.scene.rdt
                    data = next(self._file_stream).T
                    self.add_data(data)
                    if self.scene.realtime:
                        self.play(data)
                except StopIteration:
                    self._file_stream = None
            elif self.mode == AudioMode.Realtime and self.recorder is not None:
                self.record()
            window = self.get_last_n_seconds(0.1)

        self.volume.target = 2 * root_mean_square(window) * (2 ** 0.5)
        self.std.target = float(np.std(window)) if np.size(window) else 0.0
