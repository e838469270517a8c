"""
Batched audio DSP: windows, STFT, natural-scale band matrices, waveform bars.

Device-first restructuring of the reference's per-frame audio math
(/root/reference/shaderflow/audio/spectrogram.py, audio/waveform.py): where
the realtime reference computes one windowed rFFT + sparse band matmul per
frame on the CPU, the offline export path here knows all samples up front and
computes the whole export's spectrogram in a single batched program — a
(F, fft_size) windowed rFFT and one dense (bins x fft_bins) matmul
(sparsity is unnecessary for a matmul this small; see SURVEY.md §2.9's
scipy row).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# --------------------------------------------------------------------------- #
# Windows (reference audio/spectrogram.py:90-108)

@lru_cache
def hanning(size: int) -> np.ndarray:
    return np.hanning(size)

@lru_cache
def hann_poisson(size: int, alpha: float = 2.0) -> np.ndarray:
    n = np.arange(size)
    a = 0.5 * (1 - np.cos(2 * np.pi * n / size))
    b = np.exp(-alpha * np.abs(size - 2 * n) / size)
    return a * b

@lru_cache
def no_window(size: int) -> np.ndarray:
    return np.ones(size)


# --------------------------------------------------------------------------- #
# Magnitude / volume mappings (audio/spectrogram.py:20-41)

def _xp(x):
    """numpy in -> numpy out: the realtime per-frame CPU path must not
    bounce through the device (one dispatch per frame for a few hundred
    samples); jax in -> jax out for the jitted batch path."""
    return np if isinstance(x, np.ndarray) else jnp

def magnitude_amplitude(x: Array) -> Array:
    return _xp(x).abs(x)

def magnitude_power(x: Array) -> Array:
    xp = _xp(x)
    return (x * xp.conjugate(x)).real

def volume_dbfs(x: Array) -> Array:
    return 10.0 * _xp(x).log10(x)

def volume_sqrt(x: Array) -> Array:
    return _xp(x).sqrt(x)

def volume_linear(x: Array) -> Array:
    return x

def volume_dbfs_tremx(x: Array) -> Array:
    return 10.0 * (_xp(x).log10(x + 0.1) + 1.0) / 1.0414


# --------------------------------------------------------------------------- #
# Frequency scales (audio/spectrogram.py:73-88)

SCALE_OCTAVE = (lambda x: np.log2(x), lambda x: 2.0 ** x)
SCALE_MEL = (
    lambda x: 2595.0 * np.log10(1.0 + x / 700.0),
    lambda x: 700.0 * (10.0 ** (x / 2595.0) - 1.0),
)

def scale_frequencies(minimum: float, maximum: float, bins: int, scale=SCALE_OCTAVE) -> np.ndarray:
    """Center frequencies T^-1(linspace(T(min), T(max), bins)) in a custom scale."""
    forward, inverse = scale
    return inverse(np.linspace(forward(minimum), forward(maximum), bins))


# --------------------------------------------------------------------------- #
# Whittaker-Shannon band-pass interpolation matrix (audio/spectrogram.py:194-224)

def interpolation_euler(end: float = 1.2) -> Callable[[np.ndarray], np.ndarray]:
    return lambda x: np.exp(-((2.0 * x / end) ** 2)) / (end * math.sqrt(math.pi))

def interpolation_dirac(x: np.ndarray) -> np.ndarray:
    dirac = np.zeros(x.shape)
    dirac[np.round(x) == 0] = 1
    return dirac

def interpolation_sinc(x: np.ndarray) -> np.ndarray:
    return np.abs(np.sinc(x))


def band_matrix(
    center_frequencies: np.ndarray,
    fft_bins: int,
    fft_df: float,
    interpolation: Callable[[np.ndarray], np.ndarray] | None = None,
    epsilon: float = 1e-5,
) -> np.ndarray:
    """(bins, fft_bins) dense matrix; row b is a band-pass filter centered at
    center_frequencies[b], built by treating FFT bins as a one-hertz-spaced
    function interpolated at the (fractional) center bin index."""
    interpolation = interpolation or interpolation_euler()
    index = np.asarray(center_frequencies) / fft_df
    matrix = np.stack([interpolation(i - np.arange(fft_bins)) for i in index])
    matrix[np.abs(matrix) < epsilon] = 0.0
    return matrix.astype(np.float32)


# --------------------------------------------------------------------------- #
# Batched STFT

def stft_frames(audio: Array, offsets: Array, fft_size: int,
                window: Array | None) -> Array:
    """Gather + window frames: audio (C, S), offsets (F,) start samples of
    each frame's window -> (F, C, fft_size) windowed slices (window=None
    skips the taper — used when the caller upsamples before windowing).

    Offsets may exceed bounds; samples are taken with clamping at the edges
    (leading silence is the caller's concern — the rolling-buffer semantics
    of the reference zero-fill before playback starts)."""
    idx = offsets[:, None] + jnp.arange(fft_size)[None, :]          # (F, N)
    valid = (idx >= 0) & (idx < audio.shape[1])
    idx = jnp.clip(idx, 0, audio.shape[1] - 1)
    frames = audio[:, idx]                                          # (C, F, N)
    frames = jnp.where(valid[None], frames, 0.0)
    frames = jnp.transpose(frames, (1, 0, 2))
    return frames if window is None else frames * window[None, None, :]


# --------------------------------------------------------------------------- #
# Windowed-sinc polyphase upsampling
#
# The reference shells out to libsamplerate's sinc converter when
# sample_rateio != 1 (/root/reference/shaderflow/audio/spectrogram.py:160-167).
# Here the same job is a small FIR convolution — zero-stuff by the factor and
# low-pass with a Kaiser-windowed sinc — which is ideal VPU/MXU work on the
# batched device path (lax.conv with lhs dilation) and a single np.convolve
# on the realtime per-frame path.

@lru_cache
def sinc_kernel(factor: int, taps_per_phase: int = 16,
                beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for integer-factor upsampling: cutoff
    at the INPUT Nyquist (1/factor of the output rate), odd length
    2*taps_per_phase*factor + 1, DC gain `factor` (so the zero-stuffed
    signal keeps its amplitude). beta=8.555 ~ 90 dB stopband (the same
    design point as scipy.signal.resample_poly's default)."""
    half = taps_per_phase * factor
    m = np.arange(-half, half + 1, dtype=np.float64)
    h = np.sinc(m / factor) * np.kaiser(2 * half + 1, beta)
    return (factor * h / h.sum()).astype(np.float32)


def sinc_upsample(x, factor: int, taps_per_phase: int = 16):
    """Integer-factor upsample of the last axis: (..., N) -> (..., N*factor).

    Polyphase windowed-sinc, centered (output j sits at input time
    j/factor), zero edge handling — same contract as
    scipy.signal.resample_poly(x, factor, 1) and pinned against it in
    tests/test_spectral.py. numpy in -> numpy out (the realtime per-frame
    CPU path must not bounce through the device); jax in -> jax out (the
    jitted precompute path, lowered to a dilated conv)."""
    if factor == 1:
        return x
    h = sinc_kernel(int(factor), taps_per_phase)
    half = (h.size - 1) // 2
    lead, n = x.shape[:-1], x.shape[-1]
    if isinstance(x, np.ndarray):
        flat = np.ascontiguousarray(x, np.float32).reshape(-1, n)
        out = np.empty((flat.shape[0], n * factor), np.float32)
        stuffed = np.zeros(n * factor, np.float32)
        for row in range(flat.shape[0]):
            stuffed[::factor] = flat[row]
            out[row] = np.convolve(stuffed, h)[half:half + n * factor]
        return out.reshape(*lead, n * factor)
    flat = x.astype(jnp.float32).reshape(-1, 1, n)
    # lax.conv is cross-correlation; the kernel is symmetric so no flip.
    # Dilated length (n-1)*factor + 1; pad out to n*factor + 2*half so the
    # valid conv returns exactly n*factor centered samples.
    out = jax.lax.conv_general_dilated(
        flat, h[None, None, :].astype(jnp.float32),
        window_strides=(1,),
        padding=[(half, half + factor - 1)],
        lhs_dilation=(factor,),
        dimension_numbers=("NCH", "OIH", "NCH"))
    return out.reshape(*lead, n * factor)


def spectrogram_batch(
    audio: Array,
    offsets: Array,
    fft_size: int,
    window: Array,
    matrix: Array,
    magnitude: Callable[[Array], Array] = magnitude_power,
    volume: Callable[[Array], Array] | None = None,
    upsample: int = 1,
) -> Array:
    """Whole-trajectory spectrogram: (F, C, bins) = volume(M @ |rfft|).

    One rFFT over the frame batch + one MXU matmul, replacing the reference's
    per-frame fft() + sparse dot (audio/spectrogram.py:155-176). With
    upsample=r (sample_rateio), each frame reads fft_size//r raw samples and
    sinc-upsamples them to fft_size before the taper — the reference's
    libsamplerate step as one batched dilated conv."""
    if upsample > 1:
        frames = stft_frames(audio, offsets, fft_size // upsample, None)
        frames = sinc_upsample(frames, upsample) * window[None, None, :]
    else:
        frames = stft_frames(audio, offsets, fft_size, window)      # (F, C, N)
    spectrum = magnitude(jnp.fft.rfft(frames, axis=-1))             # (F, C, N/2+1)
    banded = jnp.einsum("bn,fcn->fcb", matrix, spectrum.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    if volume is not None:
        banded = volume(banded)
    return banded


# --------------------------------------------------------------------------- #
# Waveform bar reduction (audio/waveform.py:14-22)

def waveform_average(x: Array) -> Array:
    xp = _xp(x)
    return xp.sqrt(xp.mean(xp.abs(x), axis=-1))

def waveform_rms(x: Array) -> Array:
    xp = _xp(x)
    return xp.sqrt(xp.sqrt(xp.mean(xp.square(x), axis=-1)) * (2.0 ** 0.5))

def waveform_std(x: Array) -> Array:
    xp = _xp(x)
    return xp.sqrt(xp.std(x, axis=-1))


def waveform_batch(
    audio: Array,
    ends: Array,
    points: int,
    chunk_size: int,
    reducer: Callable[[Array], Array] = waveform_average,
) -> Array:
    """Batched oscilloscope bars: audio (C, S), ends (F,) exclusive end sample
    of each frame's window (CHUNK-ALIGNED, as audio/waveform.py produces) ->
    (F, points, C) reduced chunks.

    Functional form of ShaderWaveform.update (audio/waveform.py:80-87): the
    last `points*chunk_size` samples before each frame's cursor, reduced per
    chunk. Consecutive frames' windows overlap almost entirely, so the
    per-chunk reductions are computed ONCE over the whole track (a contiguous
    reshape — no gather) and each frame gathers its `points` chunk indices:
    O(S) work + a (F, points) gather, instead of materializing (C, F,
    points*chunk) sample windows through a pointwise gather (a 20 GB
    allocation at a 300-frame 15-min-track config)."""
    C, S = audio.shape
    n_chunks = max(1, S // chunk_size)
    if S < n_chunks * chunk_size:
        # Track shorter than one chunk (corrupt/near-empty decode): treat
        # the tail as silence instead of failing the whole-export reshape
        audio = jnp.pad(audio, ((0, 0), (0, n_chunks * chunk_size - S)))
    chunked = audio[:, :n_chunks * chunk_size].reshape(C, n_chunks, chunk_size)
    reduced = reducer(chunked)                                      # (C, n_chunks)
    end_chunk = ends // chunk_size
    idx = end_chunk[:, None] - points + jnp.arange(points)[None, :]  # (F, points)
    valid = (idx >= 0) & (idx < n_chunks)
    gathered = jnp.take(reduced, jnp.clip(idx, 0, n_chunks - 1), axis=1)
    # Out-of-range chunks reduce a zero window (the old sample-level
    # zero-fill), exact for any reducer
    zero = reducer(jnp.zeros((1, 1, chunk_size), jnp.asarray(audio).dtype))[0, 0]
    gathered = jnp.where(valid[None], gathered, zero)               # (C, F, points)
    return jnp.transpose(gathered, (1, 2, 0))


# --------------------------------------------------------------------------- #
# Rolling volume / std (audio/module.py:447-458)

def rolling_levels(audio: Array, ends: Array, window_samples: int) -> tuple[Array, Array]:
    """Per-frame (volume_target, std_target): volume = 2*RMS(last window)*sqrt(2),
    std = standard deviation of the same window."""
    starts = ends - window_samples
    idx = starts[:, None] + jnp.arange(window_samples)[None, :]
    valid = (idx >= 0) & (idx < audio.shape[1])
    idx = jnp.clip(idx, 0, audio.shape[1] - 1)
    windows = jnp.where(valid[None], audio[:, idx], 0.0)            # (C, F, W)
    rms = jnp.sqrt(jnp.mean(jnp.square(windows), axis=(0, 2)))
    volume = 2.0 * rms * (2.0 ** 0.5)
    std = jnp.std(windows, axis=(0, 2))
    return volume, std
