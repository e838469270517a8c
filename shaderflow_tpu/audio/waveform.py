"""
Waveform oscilloscope bars.

Role-equivalent of the reference waveform module
(/root/reference/shaderflow/audio/waveform.py): the last `length` seconds of
audio reduced into `length * samplerate` bars (Average / RMS / STD chunk
reducers) written as a (points, 1, channels) texture.

Device-first: offline exports precompute all frames' bars in one batched device
reduction (ops/spectral.waveform_batch); realtime reduces the rolling buffer
per frame on the host.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from shaderflow_tpu import logger
from shaderflow_tpu.audio import BrokenAudio
from shaderflow_tpu.module import ShaderModule
from shaderflow_tpu.ops import spectral
from shaderflow_tpu.texture import ShaderTexture
from shaderflow_tpu.variable import Uniform


class WaveformReducer(Enum):
    Average = "average"
    RMS = "rms"
    STD = "std"

    @property
    def fn(self):
        return {
            WaveformReducer.Average: spectral.waveform_average,
            WaveformReducer.RMS: spectral.waveform_rms,
            WaveformReducer.STD: spectral.waveform_std,
        }[self]


class ShaderWaveform(ShaderModule):

    def __init__(self, scene=None, name: str = "iWaveform", *,
                 audio: Optional[BrokenAudio] = None, length: float = 3,
                 samplerate: float = 60, reducer: WaveformReducer = WaveformReducer.Average,
                 smooth: bool = True, **kwargs):
        self.audio = audio
        self.length = length
        self.samplerate = samplerate
        self.reducer = WaveformReducer(reducer)
        self.smooth = smooth
        self.texture: Optional[ShaderTexture] = None
        self._precomputed: Optional[np.ndarray] = None  # (F, 1, points, C)
        self._frame_index = 0
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.texture = ShaderTexture(
            scene=self.scene,
            name=self.name,
            filter=("linear" if self.smooth else "nearest"),
            components=self.audio.channels,
            width=self._points,
            height=1,
            dtype=np.float32,
        ).repeat(False)

    @property
    def length_samples(self) -> int:
        return int(max(1, self.length * self.scene.fps))

    @property
    def _points(self) -> int:
        return int(self.length * self.samplerate)

    @property
    def chunk_size(self) -> int:
        return max(1, int(self.length * self.audio.samplerate / self._points))

    @property
    def _offset(self) -> int:
        return self.audio.tell % self.chunk_size

    def setup(self) -> None:
        self._precomputed = None
        self._frame_index = 0
        self.texture.set_sequence(None)

    def _precompute(self):
        """Whole-export bars on device: (F, 1, points, C) texture layout,
        stays in HBM."""
        full = getattr(self.audio, "full_data", None)
        if full is None and hasattr(self.audio, "load_full_file"):
            full = self.audio.load_full_file()
        if full is None:
            return None
        fps = self.scene.fps
        total = max(1, round(self.scene.runtime * fps))
        sr = self.audio.samplerate
        chunk = self.chunk_size
        tells = np.round(np.arange(total) * sr / fps).astype(np.int64)
        ends = tells - (tells % chunk)  # chunk-aligned cursor, as the reference

        @jax.jit
        def compute(audio, ends):
            bars = spectral.waveform_batch(audio, ends, self._points, chunk,
                                           self.reducer.fn)
            # Texture layout (F, H=1, W=points, C) INSIDE the jit: the
            # cached value is bind-ready, so repeat runs re-bind the same
            # object with zero eager device ops (texture.set_sequence)
            return bars[:, None, :, :]

        import time
        audio_j = jnp.asarray(full)
        ends_j = jnp.asarray(ends.astype(np.int32))
        t0 = time.perf_counter()
        compiled = compute.lower(audio_j, ends_j).compile()
        t1 = time.perf_counter()
        result = jax.block_until_ready(compiled(audio_j, ends_j))
        t2 = time.perf_counter()
        self.precompute_timings = {"compile": t1 - t0, "run": t2 - t1}
        if t2 - t0 > 2.0:
            logger.info(f"Waveform precompute: compile {t1 - t0:.1f}s + "
                        f"run {t2 - t1:.1f}s")
        return result

    def _precompute_cached(self):
        """Survive setup() across repeat runs (see spectrogram counterpart)."""
        key = (getattr(self.audio, "file", None), self.audio.samplerate,
               round(self.scene.runtime * self.scene.fps), self._points,
               self.chunk_size, self.reducer)
        if (getattr(self, "_precompute_key", None) == key
                and getattr(self, "_precompute_value", None) is not None):
            return self._precompute_value
        value = self._precompute()
        self._precompute_key = key
        self._precompute_value = value
        return value

    def prewarm(self) -> None:
        if self.scene.freewheel:
            self._precompute_cached()

    def update(self) -> None:
        self.texture.components = self.audio.channels

        if self.scene.freewheel and self._precomputed is None:
            bars = self._precompute_cached()
            if bars is not None:
                # Already (F, H=1, W=points, C) device-resident, bind-ready
                self.texture.set_sequence(bars)
                self._precomputed = bars

        self._frame_index += 1
        if self.texture.sequence is not None:
            return

        # Realtime path: reduce the rolling buffer on the host
        start = -int(self.chunk_size * self._points + self._offset + 1)
        end = -int(self._offset + 1)
        chunks = self.audio.data[:, start:end]
        chunks = chunks.reshape(self.audio.channels, -1, self.chunk_size)
        bars = np.ascontiguousarray(np.asarray(self.reducer.fn(chunks)).T)
        self.texture.write(bars.reshape(1, self._points, self.audio.channels))

    def pipeline(self):
        yield Uniform("int", f"{self.name}Length", self.length_samples)
