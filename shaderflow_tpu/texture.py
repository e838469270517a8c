"""
ShaderTexture — a temporal x layers matrix of images.

Role-equivalent of the reference texture system
(/root/reference/shaderflow/texture.py): every texture owns a matrix of
`temporal` previous frames x `layers` multipass layers, can auto-track the
scene's render resolution (track factor, `final` flag tracks the post-SSAA
resolution), exposes filter/repeat sampling state, and supports CPU writes
(full, viewport sub-rect) plus image/numpy uploads.

Device mapping: the matrix is one (T, L, H, W, C) float32 array. For textures
rendered by a ShaderProgram the live copy is device-resident and carried
through the batched lax.scan (rolling = jnp.roll on the temporal axis, the
functional form of deque.rotate at texture.py:305-308). For CPU-written
textures (images, audio, piano roll, video) the host copy here is the source
of truth; the engine uploads on version change, and snapshots textures
written during the per-frame update sweep into (F, ...) streamed batches.

Convention: arrays store row 0 = top of the image; the GL bottom-left
v-origin is folded into the sampler (ops/sampling.py), so no data flips
leak into user code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from shaderflow_tpu.message import ShaderMessage
from shaderflow_tpu.module import ShaderModule
from shaderflow_tpu.variable import ShaderVariable, StaticUniform, Uniform


class ShaderTexture(ShaderModule):

    def __init__(
        self,
        scene=None,
        name: Optional[str] = None,
        *,
        width: int = 1,
        height: int = 1,
        components: int = 4,
        dtype=np.uint8,
        temporal: int = 1,
        layers: int = 1,
        filter: str = "linear",
        repeat_x: bool = True,
        repeat_y: bool = True,
        mipmaps: bool = False,
        anisotropy: Optional[int] = None,
        track: Union[bool, float] = 0.0,
        final: bool = False,
        **kwargs,
    ):
        self._width = int(width)
        self._height = int(height)
        self._components = int(components)
        self._dtype = np.dtype(dtype)
        self._temporal = int(temporal)
        self._layers = int(layers)
        self._filter = filter
        self.repeat_x = bool(repeat_x)
        self.repeat_y = bool(repeat_y)
        # mipmaps=True is honored: Frag.tex() builds the pyramid in-jit and
        # samples trilinearly with derivative-driven LOD (ops/sampling.py
        # MipSampler) — the reference delegates the same duty to the GL
        # driver (/root/reference/shaderflow/texture.py:82-137).
        self.mipmaps = bool(mipmaps)
        # Anisotropic filtering (default x16, reference texture.py:110-137)
        # is honored for mipmapped textures: MipSampler takes ray-aligned
        # trilinear taps along the footprint's major axis with minor-axis
        # LOD (ops/sampling.py sample_mip_aniso). Without mipmaps there is
        # no minification pyramid to filter against — warn only when the
        # user EXPLICITLY asked for anisotropy on a mipless texture.
        self.anisotropy = int(anisotropy) if anisotropy is not None else 16
        # Filtering engages only on an EXPLICIT request: GL's x16 default is
        # free fixed-function sampler state, but ours is taps x levels real
        # samples per pixel — defaulting it on would multiply every
        # mipmapped texture's sampling cost ~16x for footprints that are
        # usually isotropic anyway. The attribute still reads 16 (parity).
        self._aniso_explicit = anisotropy is not None
        if anisotropy is not None and self.anisotropy > 1 and not self.mipmaps:
            from shaderflow_tpu import logger
            logger.warn(
                f"Texture {name!r}: anisotropy=x{self.anisotropy} requested "
                "without mipmaps=True — anisotropic filtering needs the mip "
                "pyramid and is ignored on a single-level texture")
        self._track = float(track)
        self.final = bool(final)

        self._matrix: Optional[np.ndarray] = None  # (T, L, H, W, C) float32, row 0 = top
        self._matrix_stale: bool = False  # wire_u8 is newer than _matrix
        self.version: int = 0     # bumped on every host write (device cache key)
        self.dirty: bool = False  # set by write(); engine clears after snapshot
        self.empty: bool = True
        self.wire_u8: Optional[np.ndarray] = None
        """u8 twin of the matrix for streamed delivery: when the last write
        was a full-box uint8 upload (video frames), the engine streams THESE
        bytes host->device (1 byte/channel instead of 4 — 4K batch 32 drops
        3.19 GB -> 0.80 GB per flush) and normalizes to f32 inside the jit.
        Invalidated by any f32 / partial / multi-box write."""
        self.sequence = None      # optional DEVICE (F_total, H, W, C) per-frame content
        """Device-resident per-frame texture sequence: when set (offline
        audio paths), the render scan indexes it by the absolute frame
        number instead of streaming host snapshots — zero per-batch
        host->device traffic for per-frame textures (set_sequence())."""
        self.sequence_window: Optional[int] = None  # ring window L (set_sequence)

        super().__init__(scene=scene, name=name, **kwargs)

    @property
    def matrix(self) -> Optional[np.ndarray]:
        """The (T, L, H, W, C) float32 content. A full-box uint8 write only
        records wire_u8 and marks the f32 matrix stale (the /255 normalize
        of a 4K frame costs ~100 ms of host time per frame and the streamed
        path never reads it); the first matrix READ materializes it."""
        if self._matrix_stale:
            self._matrix[0, 0] = self.wire_u8[0, 0].astype(np.float32) / 255.0
            self._matrix_stale = False
        return self._matrix

    @matrix.setter
    def matrix(self, value: Optional[np.ndarray]) -> None:
        self._matrix = value
        self._matrix_stale = False

    def build(self) -> None:
        self.make()

    # -- sampling state -----------------------------------------------------

    @property
    def filter(self) -> str:
        return self._filter

    @filter.setter
    def filter(self, value: str) -> None:
        value = getattr(value, "value", value)  # accept enum-likes
        if value not in ("linear", "nearest"):
            raise ValueError(f"Unknown texture filter {value!r}")
        self._filter = value

    @property
    def linear(self) -> bool:
        return self._filter == "linear"

    def repeat(self, value: bool) -> "ShaderTexture":
        self.repeat_x = self.repeat_y = bool(value)
        return self

    # -- geometry -----------------------------------------------------------

    @property
    def track(self) -> float:
        return self._track

    @track.setter
    def track(self, value: Union[bool, float]) -> None:
        self._track = float(value)
        self.make()

    @property
    def resolution(self) -> tuple[int, int]:
        """(width, height); tracking textures follow the scene resolution
        (render resolution, or the post-SSAA output when final)."""
        if not self._track:
            return (self._width, self._height)
        base = self.scene.resolution if self.final else self.scene.render_resolution
        return tuple(max(1, int(x * self._track)) for x in base)

    @resolution.setter
    def resolution(self, value: tuple[int, int]) -> None:
        if not self._track:
            width, height = value
            changed = (self._width, self._height) != (int(width), int(height))
            self._width, self._height = int(width), int(height)
            if changed:
                self.make()

    @property
    def width(self) -> int:
        return self.resolution[0]

    @width.setter
    def width(self, value: int) -> None:
        self.resolution = (value, self.height)

    @property
    def height(self) -> int:
        return self.resolution[1]

    @height.setter
    def height(self, value: int) -> None:
        self.resolution = (self.width, value)

    @property
    def size(self) -> tuple[int, int]:
        return self.resolution

    @size.setter
    def size(self, value: tuple[int, int]) -> None:
        self.resolution = value

    @property
    def aspect_ratio(self) -> float:
        return self.width / (self.height or 1)

    @property
    def components(self) -> int:
        return self._components

    @components.setter
    def components(self, value: int) -> None:
        if self._components != int(value):
            self._components = int(value)
            self.make()

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @dtype.setter
    def dtype(self, value) -> None:
        if isinstance(value, str) and value in ("f1", "u1"):
            value = np.uint8
        elif isinstance(value, str) and value in ("f2",):
            value = np.float16
        elif isinstance(value, str) and value in ("f4",):
            value = np.float32
        value = np.dtype(value)
        if self._dtype != value:
            self._dtype = value
            self.make()

    @property
    def temporal(self) -> int:
        return self._temporal

    @temporal.setter
    def temporal(self, value: int) -> None:
        if self._temporal != int(value):
            self._temporal = int(value)
            self.make()

    @property
    def layers(self) -> int:
        return self._layers

    @layers.setter
    def layers(self, value: int) -> None:
        if self._layers != int(value):
            self._layers = int(value)
            self.make()

    # -- storage ------------------------------------------------------------

    def make(self) -> "ShaderTexture":
        """(Re)allocate the matrix, preserving previous content where shapes
        still match (the reference rewrites box.data after resize,
        texture.py:268-270)."""
        width, height = self.resolution
        shape = (self._temporal, self._layers, height, width, self._components)
        old = self._matrix  # shape check must not materialize a stale matrix
        if old is not None and old.shape == shape:
            # Same storage shape: content is preserved by definition — skip
            # the 100+ MB realloc/copy a redundant RecreateTextures relay
            # would otherwise pay at supersampled resolutions
            self.version += 1
            return self
        self.matrix = np.zeros(shape, dtype=np.float32)
        self.wire_u8 = None
        self.version += 1
        return self

    @property
    def zeros(self) -> np.ndarray:
        return np.zeros((self.height, self.width, self._components), dtype=np.float32)

    @property
    def bytes_per_pixel(self) -> int:
        return self._dtype.itemsize * self._components

    @property
    def size_t(self) -> int:
        return self.width * self.height * self.bytes_per_pixel

    def _normalize(self, data: np.ndarray) -> np.ndarray:
        """Convert incoming data to sample space (float32; u8 -> [0,1])."""
        data = np.asarray(data)
        if data.dtype == np.uint8:
            return data.astype(np.float32) / 255.0
        return data.astype(np.float32)

    # -- input / output -----------------------------------------------------

    def write(
        self,
        data=None,
        *,
        temporal: int = 0,
        layer: int = -1,
        viewport: Optional[tuple[int, int, int, int]] = None,
    ) -> "ShaderTexture":
        """Write pixel data into one (temporal, layer) box.

        viewport=(x, y, w, h) uses GL conventions: x from the left, y from
        the BOTTOM. data is (h, w, c), (h, w) or anything reshapeable;
        row 0 of data is the bottom row of the region (GL write order).
        """
        if self._matrix is None:
            self.make()
        height, width = self._matrix.shape[2], self._matrix.shape[3]

        if viewport is None:
            raw = np.asarray(data)
            if (raw.dtype == np.uint8 and self._temporal == 1
                    and self._layers == 1 and temporal == 0
                    and layer in (0, -1)):
                # The single box IS the whole matrix: keep the exact u8
                # bytes (storage row order) for u8-on-the-wire streaming and
                # DEFER the f32 normalize (the matrix property materializes
                # on first read — streamed textures never pay it per frame)
                self.wire_u8 = np.ascontiguousarray(
                    raw.reshape(height, width, self._components)[::-1]
                )[None, None]
                self._matrix_stale = True
            else:
                self.wire_u8 = None
                data = self._normalize(raw).reshape(
                    height, width, self._components)
                # GL write order: data row 0 is the BOTTOM row (v=0); our
                # storage is top-down, so flip. from_numpy pre-flips so
                # images stay top-down (texture.py:327-335 flipud parity).
                self._matrix_stale = False
                self._matrix[temporal, layer] = data[::-1]
        else:
            # Partial write overlays the CURRENT content: the property read
            # materializes a stale u8 frame first
            target = self.matrix[temporal, layer]
            self.wire_u8 = None
            x, y, w, h = viewport
            data = self._normalize(data).reshape(h, w, self._components)
            # GL region rows are bottom-up: flip into our top-down storage
            target[height - y - h: height - y, x: x + w] = data[::-1]

        self.version += 1
        self.dirty = True
        self.empty = False
        return self

    def read(self, temporal: int = 0, layer: int = -1) -> np.ndarray:
        """A read-only view of one box. Writes go through write(), which
        keeps wire_u8 (the streamed copy) in step with the matrix."""
        view = self.matrix[temporal, layer]
        view.flags.writeable = False
        return view

    def from_numpy(self, data: np.ndarray) -> "ShaderTexture":
        """Size the texture to an image array (H, W, C) and upload it."""
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[..., None]
        height, width, components = data.shape
        self._width, self._height = width, height
        self._components = components
        self._dtype = data.dtype if data.dtype == np.uint8 else np.dtype(np.float32)
        self.make()
        self.write(np.flipud(data))  # net effect: image row 0 stays the top
        return self

    def from_image(self, image) -> "ShaderTexture":
        from PIL import Image
        if isinstance(image, (str, Path)):
            image = Image.open(image)
        return self.from_numpy(np.array(image))

    def clear(self, temporal: int = 0, layer: int = -1) -> "ShaderTexture":
        return self.write(self.zeros, temporal=temporal, layer=layer)

    def is_empty(self) -> bool:
        return self.empty

    def set_sequence(self, array, quantize: int = 256,
                     window: Optional[int] = None) -> "ShaderTexture":
        """Bind a device-resident (F_total, H, W, C) per-frame content
        sequence (row 0 = top, same storage convention as the matrix).
        Pass None to return to host-written content.

        The frame axis is edge-padded up to a multiple of `quantize` so
        exports of different durations share compiled programs (the engine
        clips its index to the last real frame either way).

        `window=L` declares a RING sequence: `array` is one (H, 1, C)
        column per frame, and the per-frame texture content is the ring of
        the last L columns, (H, L, C), synthesized on device inside the
        render scan with the same ring-offset layout the host write path
        produces (scrolling spectrogram, reference
        audio/spectrogram.py:320-330, without streaming L columns per
        frame over the host link)."""
        if array is not None and quantize:
            import jax.numpy as jnp
            # Re-binding the same source (cached module precomputes on a
            # repeat run) must cost zero device work: the eager pad / upload
            # ops below are each a dispatch round-trip, and for host arrays (piano-roll
            # sequences, hundreds of MB at 4K) a full re-upload.
            cache = getattr(self, "_sequence_bind_cache", None)
            if cache is not None and cache[0] is array and cache[1] == quantize:
                array = cache[2]
            else:
                source = array
                frames = int(array.shape[0])
                target = -(-frames // quantize) * quantize
                array = jnp.asarray(array)
                if target != frames:
                    pad = jnp.broadcast_to(array[-1:],
                                           (target - frames,) + array.shape[1:])
                    array = jnp.concatenate([array, pad], axis=0)
                self._sequence_bind_cache = (source, quantize, array)
        self.sequence = array
        self.sequence_window = int(window) if (array is not None and window) else None
        if array is not None:
            height, width = int(array.shape[1]), int(array.shape[2])
            self._components = int(array.shape[3])
            if not self._track:
                self._width = self.sequence_window or width
                self._height = height
        self.version += 1
        return self

    def roll(self, n: int = 1) -> "ShaderTexture":
        """Rotate the temporal ring (host copy). Program textures roll on
        device inside the render scan; CPU textures (e.g. video) roll here."""
        self.matrix = np.roll(self.matrix, n, axis=0)
        self.version += 1
        return self

    # -- module hooks -------------------------------------------------------

    def handle(self, message) -> None:
        if self._track and isinstance(message, ShaderMessage.Shader.RecreateTextures):
            self.make()

    def pipeline(self):
        if not self.name:
            return
        yield self.uniform("vec2", f"{self.name}Size", self.resolution)
        yield StaticUniform("int", f"{self.name}Layers", self._layers)
        yield StaticUniform("int", f"{self.name}Temporal", self._temporal)
        # The texture arrays themselves are bound by the render engine, which
        # exposes them to pixel programs as samplers by name (shader.py).

    def sampler_names(self):
        """All '<name><T>x<L>' box names (GLSL parity naming, texture.py:351)."""
        for t in range(self._temporal):
            for l in range(self._layers):
                yield (t, l, f"{self.name}{t}x{l}")
