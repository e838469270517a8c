"""
ShaderScene — the root module, time model, and batched event loop.

Role-equivalent of the reference scene
(/root/reference/shaderflow/scene.py): the scene IS a module (first in its
own module list), owns the default frametimer/keyboard/camera modules, the
main "iScreen" program and the SSAA final program, the virtual time model
(time/speed/runtime/fps/dt/rdt, tau, frame), the resolution model with
fractional SSAA, the message relays, and the single `main()` entry point
with the reference's full flag surface.

Redesign of the hot loop: instead of one GL draw + readback per
scheduler tick (scene.py:622-639), `main()` advances module state per frame
on the host, captures uniform pytrees, and renders B frames per device
launch through the jitted engine (engine.py). Device compute for batch k
overlaps the host transfer/encode of batch k-1.
"""

from __future__ import annotations

import math
import os
import sys
import time
from enum import Enum
from pathlib import Path
from typing import Any, Iterable, Optional, Union

import numpy as np

from shaderflow_tpu import logger
from shaderflow_tpu.engine import RenderEngine
from shaderflow_tpu.engine import fetch_frame as engine_fetch_frame
from shaderflow_tpu.engine import to_wire as engine_to_wire
from shaderflow_tpu.exporting import ExportingHelper
from shaderflow_tpu.frametimer import ShaderFrametimer
from shaderflow_tpu.io.ffmpeg import FFmpeg
from shaderflow_tpu.keyboard import ShaderKeyboard
from shaderflow_tpu.message import ShaderMessage
from shaderflow_tpu.module import ShaderModule
from shaderflow_tpu.resolution import Resolution
from shaderflow_tpu.scheduler import Scheduler
from shaderflow_tpu.shader import ShaderProgram
from shaderflow_tpu.variable import ShaderVariable, Uniform


def _parse_ratio(value: str) -> Optional[float]:
    """Parse '16:9', '16/9', '1.777' or 'none' without eval() (the reference
    evals these CLI strings — arbitrary code execution from flag values)."""
    text = value.strip().lower()
    if text in ("", "none", "null"):
        return None
    for sep in (":", "/"):
        if sep in text:
            num, _, den = text.partition(sep)
            return float(num) / float(den)
    return float(text)


def _parse_duration(value: str) -> Optional[float]:
    """Parse a duration: plain seconds, 'MM:SS'/'HH:MM:SS', or a simple
    product/quotient like '30*60' (no general expression eval)."""
    text = value.strip().lower().removesuffix("s")
    if not text or text in ("none", "null"):
        return None
    if ":" in text:
        total = 0.0
        for part in text.split(":"):
            total = total * 60.0 + float(part)
        return total
    if "*" in text:
        result = 1.0
        for factor in text.split("*"):
            result *= float(factor)
        return result
    if "/" in text:
        num, _, den = text.partition("/")
        return float(num) / float(den)
    return float(text)


class WindowBackend(Enum):
    Headless = "headless"
    Preview = "preview"   # cv2-based live preview when a display exists

    @classmethod
    def infer(cls) -> "WindowBackend":
        if (option := os.getenv("WINDOW_BACKEND")):
            return cls(option)
        if ("main" in sys.argv) and any(x in sys.argv for x in ("--output", "-o")):
            return cls.Headless
        if os.getenv("DISPLAY"):
            return cls.Preview
        return cls.Headless


class ShaderScene(ShaderModule):

    def __init__(self, backend: Optional[WindowBackend] = None, **kwargs):
        # The scene is its own first module; the registry must exist before
        # ShaderModule.__init__ appends self to it.
        self.modules: list[ShaderModule] = []
        self.backend = WindowBackend(backend) if backend else WindowBackend.infer()

        # Temporal model
        self.time: float = 0.0
        self._frame_counter: int = 0
        self.speed: float = 1.0
        self.runtime: float = 10.0
        self.fps: float = 60.0
        self.dt: float = 0.0
        self.rdt: float = 0.0

        # Resolution model
        self._width: int = 1920
        self._height: int = 1080
        self._ssaa: float = 1.0
        self._aspect_ratio: Optional[float] = None
        self.quality: float = 50.0
        self.subsample: int = 2

        # Run state
        self.realtime: bool = True
        self.exporting: bool = False
        self.freewheel: bool = False
        self.headless: bool = False
        self.quit: bool = False
        self.title: str = "ShaderFlow"
        self.fullscreen: bool = False
        self.exclusive: bool = False
        self.visible: bool = False

        # Interaction state
        self.mouse_gluv: tuple[float, float] = (0.0, 0.0)
        self.mouse_inside: bool = False
        self.mouse_buttons: dict[int, bool] = {k: False for k in range(1, 6)}
        self.render_ui: bool = False

        self.scheduler = Scheduler()
        self.vsync = None
        self.ffmpeg = FFmpeg()
        self.engine: Optional[RenderEngine] = None
        # Batch-level precompute hooks: name -> fn(PreludeCtx) -> (B, ...)
        # array or None, run once per flush outside the render scan
        # (engine.PreludeCtx); frames read slices via Frag.prelude(name)
        self.batch_preludes: dict[str, Any] = {}
        # Module-registered CLI commands (module.register_command)
        self._commands: dict[str, Any] = {}
        # HUD panel navigation ([ / ] select the expanded module panel,
        # , / . select an editable field, - / + nudge it)
        self._ui_index: int = 0
        self._ui_field_index: int = 0

        self.frametimer: Optional[ShaderFrametimer] = None
        self.keyboard: Optional[ShaderKeyboard] = None
        self.camera = None
        self.shader: Optional[ShaderProgram] = None
        self._final: Optional[ShaderProgram] = None
        self._initialized = False

        super().__init__(scene=None, **kwargs)
        self.name = self.name or type(self).__name__

    # ------------------------------------------------------------------ #
    # Initialization (reference scene.py:128-195)

    def initialize(self) -> None:
        if self._initialized:
            return
        from shaderflow_tpu.camera import ShaderCamera

        logger.info(f"Initializing scene {self.name} with backend {self.backend}")
        self.frametimer = ShaderFrametimer(scene=self)
        self.keyboard = ShaderKeyboard(scene=self)
        self.camera = ShaderCamera(scene=self)

        # SSAA downsampler target (u8 RGB at the output resolution) and the
        # main screen program, in this order — the engine renders reversed.
        self._final = ShaderProgram(scene=self, name="iFinal")
        self._final.texture.components = 3
        self._final.texture.dtype = np.uint8
        self._final.texture.final = True
        self._final.texture.track = 1.0
        self.shader = ShaderProgram(scene=self, name="iScreen")
        self.shader.texture.repeat(False)
        self.shader.texture.track = 1.0

        self.engine = RenderEngine(self)
        self._initialized = True
        self.build()

    def invalidate_engine(self) -> None:
        if self.engine is not None:
            self.engine.invalidate()

    # ------------------------------------------------------------------ #
    # Temporal model (reference scene.py:220-281)

    @property
    def tau(self) -> float:
        return (self.time / self.runtime) % 1.0

    @property
    def cycle(self) -> float:
        return self.tau * math.tau

    @property
    def frametime(self) -> float:
        return 1.0 / self.fps

    @frametime.setter
    def frametime(self, value: float) -> None:
        self.fps = 1.0 / value

    @property
    def frame(self) -> int:
        return round(self.time * self.fps)

    @frame.setter
    def frame(self, value: int) -> None:
        self.time = value / self.fps

    @property
    def duration(self) -> float:
        return self.runtime

    @property
    def max_duration(self) -> float:
        return max((module.duration or 0.0) for module in self.modules)

    def set_duration(self, override: Optional[float] = None) -> float:
        self.runtime = (override or self.max_duration or self.runtime)
        self.runtime /= self.speed
        return self.runtime

    # ------------------------------------------------------------------ #
    # Resolution model (reference scene.py:316-437)

    @property
    def width(self) -> int:
        return self._width

    @width.setter
    def width(self, value: int) -> None:
        self.resize(width=value)

    @property
    def height(self) -> int:
        return self._height

    @height.setter
    def height(self, value: int) -> None:
        self.resize(height=value)

    @property
    def resolution(self) -> tuple[int, int]:
        return (self._width, self._height)

    @resolution.setter
    def resolution(self, value: tuple[int, int]) -> None:
        self.resize(*value)

    @property
    def ssaa(self) -> float:
        """Fractional supersampling factor; O(N^2) device cost."""
        return self._ssaa

    @ssaa.setter
    def ssaa(self, value: float) -> None:
        self._ssaa = max(0.01, float(value))
        self.relay(ShaderMessage.Shader.RecreateTextures)
        self.invalidate_engine()

    @property
    def render_resolution(self) -> tuple[int, int]:
        return (int(self._width * self._ssaa), int(self._height * self._ssaa))

    @property
    def aspect_ratio(self) -> float:
        return self._aspect_ratio or (self._width / self._height)

    @aspect_ratio.setter
    def aspect_ratio(self, value: Optional[Union[float, str]]) -> None:
        if isinstance(value, str):
            value = _parse_ratio(value)
        if self._aspect_ratio == value:
            return
        self._aspect_ratio = value

    @property
    def components(self) -> int:
        return self._final.texture.components

    def resize(
        self,
        width: Optional[int] = None,
        height: Optional[int] = None,
        ratio: Optional[Union[float, str]] = None,
        bounds: Optional[tuple[int, int]] = None,
        ssaa: Optional[float] = None,
        scale: float = 1.0,
    ) -> tuple[int, int]:
        self.aspect_ratio = (ratio or self._aspect_ratio)
        self._ssaa = (ssaa or self._ssaa)

        resolution = Resolution.fit(
            old=(self._width, self._height),
            new=(width, height),
            max=bounds,
            ar=self._aspect_ratio,
            scale=scale,
        )
        if resolution != (self._width, self._height):
            self._width, self._height = resolution
            self.relay(ShaderMessage.Shader.RecreateTextures)
            self.invalidate_engine()
            logger.info(f"Resized Scene to {self.resolution}")
        return self.resolution

    # ------------------------------------------------------------------ #
    # Frame stepping

    def next(self, dt: float = 0.0) -> None:
        """Advance one frame of host state: run every module's update() (the
        pipeline may change), let the engine capture the frame, integrate
        time last so frame zero renders at t=0 (scene.py:456-479)."""
        for module in self.modules:
            if not isinstance(module, ShaderProgram):
                module.update()
        # ShaderPrograms have no host-side work; rendering happens in the
        # batched device program. Hot reload is polled in realtime mode only.
        if self.realtime:
            for module in self.modules:
                if isinstance(module, ShaderProgram):
                    module.poll_hot_reload()
            self.scheduler.all_once()

        if self.engine is not None and getattr(self, "_capture_enabled", True):
            self.engine.capture_frame()

        if self.vsync is not None:
            # Track live fps edits (HUD slider); one realtime launch covers
            # _rt_batch_active frame periods, so the launch task paces at
            # fps/N (see _realtime_frame's micro-batching)
            self.vsync.fps = self.fps / max(1, getattr(
                self, "_rt_batch_active", 1))
        self.dt = dt * self.speed
        self.rdt = dt
        self.time += self.dt
        self._frame_counter += 1

    def screenshot(self) -> np.ndarray:
        """Render the current frame once; (H, W, 3) uint8."""
        self.engine.begin_batch()
        # _frame_counter must be restored too: device-resident sequence
        # textures index by iFrameIndex and would skip a column otherwise.
        saved = (self.time, self.dt, self.rdt, self._frame_counter)
        self.next(dt=0.0)
        self.time, self.dt, self.rdt, self._frame_counter = saved
        frames = self.engine.flush(1)
        return engine_fetch_frame(frames[0])

    # ------------------------------------------------------------------ #
    # Main entry point (reference scene.py:493-639 flag surface)

    def main(
        self,
        *,
        width: Optional[int] = 1920,
        height: Optional[int] = 1080,
        scale: float = 1.0,
        ratio: Optional[Union[float, str]] = None,
        fps: float = 60.0,
        frameskip: bool = True,
        fullscreen: bool = False,
        quality: float = 50.0,
        ssaa: float = 1.0,
        subsample: int = 2,
        output: Optional[Union[Path, str]] = None,
        time: Optional[Union[float, str]] = None,
        speed: float = 1.0,
        freewheel: bool = False,
        raw: bool = False,
        turbo: bool = True,
        buffers: int = 5,
        batch: Optional[int] = None,
        start: float = 0.0,
        devices: Optional[int] = None,
    ) -> Optional[Union[Path, bytes]]:
        """Render the scene: realtime preview, or export when output is set.

        `start` resumes an export at a content time (seconds): freewheel
        time is deterministic, so frame k is exactly reproducible — the
        segment [start, duration) is rendered to the output and can be
        concatenated after a crash (FFmpeg.concat_segments).

        `devices` shards each frame batch over that many chips of a 1D
        jax mesh (frame-parallel SPMD, parallel/mesh.py) — exact only for
        feedback-free scenes; temporal-feedback scenes fall back to one
        chip with a warning."""
        final_width, final_height = self._setup_run(
            width=width, height=height, scale=scale, ratio=ratio, fps=fps,
            fullscreen=fullscreen, quality=quality, ssaa=ssaa,
            subsample=subsample, output=output, time=time, speed=speed,
            freewheel=freewheel, raw=raw)

        export = ExportingHelper(self)
        if self.freewheel:
            export.make_sink(output, width=final_width, height=final_height,
                             turbo=turbo, buffers=buffers)
        if self.freewheel:
            export.open_bar()

        if self.realtime:
            return self._realtime_loop(frameskip)
        return self._export_loop(export, batch, start_frame=round(start * self.fps),
                                 devices=devices)

    def _setup_run(self, *, width=1920, height=1080, scale=1.0, ratio=None,
                   fps=60.0, fullscreen=False, quality=50.0, ssaa=1.0,
                   subsample=2, output=None, time=None, speed=1.0,
                   freewheel=False, raw=False) -> tuple[int, int]:
        """Everything main() does before the loops: flags, compile relay,
        resize, module setup, duration, SSAA/raw resolution policy. Also the
        entry point for benchmarking/graft-entry code that drives the engine
        directly."""
        self.initialize()
        self.exporting = bool(output)
        self.freewheel = (self.exporting or freewheel)
        self.headless = self.freewheel
        self.realtime = not self.headless
        self.title = f"ShaderFlow • {self.name}"
        self.subsample = int(subsample)
        self.quality = float(quality)
        self.fullscreen = fullscreen
        self.speed = float(speed)
        self.fps = float(fps)
        self.time = 0.0
        self.dt = 0.0
        self.rdt = 0.0
        self._frame_counter = 0
        self.relay(ShaderMessage.Shader.Compile)
        self.scheduler.clear()

        final_width, final_height = self.resize(
            width=width, height=height, ratio=ratio, scale=scale)

        for module in self.modules:
            module.setup()

        self.set_duration(_parse_duration(time) if isinstance(time, str) else time)

        # Raw mode (or downscale SSAA): export native render-resolution
        # frames and skip the device downsample (scene.py:591-594 behavior:
        # the encoder rescales instead)
        if self.freewheel and (raw or ssaa < 1):
            self._ssaa = float(ssaa)
            self.resize(*self.render_resolution, scale=1, ssaa=1)
        else:
            self.ssaa = ssaa
        return (final_width, final_height)

    # -- export (freewheel) hot loop ----------------------------------------

    def _prewarm_modules(self) -> None:
        """Run every overridden module.prewarm() before the first frame:
        the whole-file spectrogram STFT, waveform bars and piano note-scan
        are each an independent device compile (tools/coldstart.py
        breakdown; VERDICT r4 #2).

        SEQUENTIAL by default; SHADERFLOW_PARALLEL_PREWARM=1 runs them on
        threads so their compiles can overlap. Which default is faster on
        the GPU is not measured yet."""
        import threading
        warmers = [m for m in self.modules
                   if type(m).prewarm is not ShaderModule.prewarm]
        if not warmers:
            return
        if (len(warmers) == 1
                or os.environ.get("SHADERFLOW_PARALLEL_PREWARM") != "1"):
            for module in warmers:
                module.prewarm()
            return
        failures: list = []

        def run(module: ShaderModule) -> None:
            try:
                module.prewarm()
            except BaseException as error:  # re-raised on the main thread
                failures.append(error)

        threads = [threading.Thread(target=run, args=(m,), daemon=True,
                                    name=f"prewarm-{type(m).__name__}")
                   for m in warmers]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if failures:
            raise failures[0]

    def default_batch_size(self) -> int:
        """Frames per device launch: larger batches amortize per-launch
        dispatch/transfer latency; bounded by output size so frame buffers
        + streamed texture stacks stay modest (~0.75 GB of u8 output per
        batch). 128 frames at 1080p, 32 at 4K."""
        pixels = self._width * self._height
        return int(np.clip(2 ** 28 // max(1, pixels), 4, 128))

    def _export_loop(self, export: ExportingHelper, batch: Optional[int],
                     start_frame: int = 0, devices: Optional[int] = None):
        total = export.total_frames
        size = int(batch or self.default_batch_size())
        self._prewarm_modules()

        self.engine.mesh = None
        if devices and devices > 1:
            from shaderflow_tpu.parallel.mesh import frame_mesh, supports_frame_sharding
            import jax
            available = len(jax.devices())
            if available < devices:
                raise RuntimeError(f"Requested {devices} devices, only "
                                   f"{available} available")
            if supports_frame_sharding(self):
                # Each flush pads to `size`, so sizing the batch to a
                # multiple of the mesh keeps every launch shardable.
                size = max(size, devices) // devices * devices
                self.engine.mesh = frame_mesh(devices)
                logger.info(f"Frame-sharded export over {devices} devices "
                            f"(batch {size}, {size // devices}/chip)")
            elif self.height % devices == 0:
                # Temporal feedback serializes frames; shard pixel rows
                # instead (engine.flush row path, exact by construction)
                self.engine.mesh = frame_mesh(devices)
                logger.info(f"Row-sharded export over {devices} devices "
                            f"(temporal feedback; {self.height // devices} "
                            f"rows/chip)")
            else:
                raise ValueError(f"Scene has temporal feedback and height "
                                 f"{self.height} does not divide into "
                                 f"{devices} row shards")

        # Resume: fast-forward module state to start_frame. Stateless scenes
        # (no temporal feedback) replay host updates only; feedback scenes
        # must render to rebuild their texture history (frames discarded).
        if start_frame:
            from shaderflow_tpu.parallel.mesh import supports_frame_sharding
            stateless = supports_frame_sharding(self)
            logger.info(f"Resuming export at frame {start_frame} "
                        f"({'host replay' if stateless else 'render replay'})")
            replayed = 0
            while replayed < min(start_frame, total):
                if stateless:
                    self._capture_enabled = False
                    self.next(dt=self.frametime)
                    self._capture_enabled = True
                    replayed += 1
                else:
                    count = min(size, start_frame - replayed)
                    self.engine.begin_batch()
                    for _ in range(count):
                        self.next(dt=self.frametime)
                    # No padding: padded frames would advance the temporal
                    # carry past the resume point (a one-time retrace for the
                    # remainder batch is fine)
                    self.engine.flush(count)
                    replayed += count
            if export.bar is not None:
                export.bar.total = max(1, total - start_frame)
            export.frame = 0
            total = total - start_frame

        # In-flight batch queue: the host only synchronizes on a batch once
        # `depth` newer ones are dispatched, so the device always has >= 1
        # queued launch when one finishes — the per-batch dispatch latency
        # hides behind the previous batch's compute instead of gapping the
        # stream. depth=1
        # is the old capture-ahead behavior; each extra level holds one
        # more (F, H, W, 3) u8 batch on device (~796 MB at the default
        # batch sizes: 1080p batch 128 / 4K batch 32 — default_batch_size
        # targets ~0.75 GB of frames). Budget: up to depth+1 batches can be
        # pinned at once (depth in flight + one being filled); cap that at
        # ~2.5 GB of device memory (render intermediates are per-frame
        # inside the scan, so u8 outputs dominate pinned state).
        # depth 2 while 3 batches fit, else 1 — an explicit batch= above
        # ~850 MB (e.g. 4K batch 64 = 1.6 GB) degrades to depth 1.
        batch_bytes = size * self._width * self._height * 3
        default_depth = 2 if 3 * batch_bytes <= (5 << 29) else 1
        depth = max(1, int(os.environ.get("SHADERFLOW_PIPELINE_DEPTH",
                                          str(default_depth))))
        trace = os.environ.get("SHADERFLOW_BATCH_TRACE") == "1"
        in_flight: list = []
        frame_index = 0
        while frame_index < total and not self.quit:
            t0 = time.perf_counter() if trace else 0.0
            count = min(size, total - frame_index)
            self.engine.begin_batch()
            for _ in range(count):
                self.next(dt=self.frametime)
            t1 = time.perf_counter() if trace else 0.0
            frames = self.engine.flush(count, pad_to=size)
            t2 = time.perf_counter() if trace else 0.0
            if export.wants_host_frames:
                # Stage for delivery: flatten to the unpadded wire layout on
                # device (engine.WireBatch — a padded (F,H,W,3) u8 fetch is
                # 5-20x slower than the same bytes flat), then enqueue the
                # device->host copy right behind the compute on the device
                # stream: the transfer overlaps the NEXT batch's host
                # capture + compute. (Never for NullSink: it measures pure
                # render throughput and must not pay the link.)
                frames = engine_to_wire(frames)
                try:
                    frames.copy_to_host_async()
                except Exception:
                    pass
            in_flight.append(frames)
            # Fetch/encode the oldest batch while newer ones render
            while len(in_flight) > depth:
                export.pipe_batch(in_flight.pop(0))
            if trace:
                t3 = time.perf_counter()
                print(f"BATCH_TRACE frames={frame_index}+{count} "
                      f"capture={1e3 * (t1 - t0):.1f}ms "
                      f"dispatch={1e3 * (t2 - t1):.1f}ms "
                      f"drain={1e3 * (t3 - t2):.1f}ms", file=sys.stderr,
                      flush=True)
            frame_index += count

        for frames in in_flight:
            export.pipe_batch(frames)

        result = export.finish()
        export.log_stats(output=result)
        return result

    # -- realtime loop -------------------------------------------------------

    def _realtime_loop(self, frameskip: bool) -> None:
        preview = None
        window = None
        if self.backend == WindowBackend.Preview:
            choice = os.environ.get("SHADERFLOW_PREVIEW", "").lower()
            if choice != "cv2":
                # Preferred: a real SDL window (io/sdlwindow.py) — native
                # focused-window event queue with exact KeyDown/KeyUp +
                # modifiers, unicode, wheel, resize, file drop and close,
                # the reference's glfw event surface (scene.py:708-841).
                try:
                    from shaderflow_tpu.io.sdlwindow import SDLWindow
                    window = SDLWindow(self.title, *self.resolution)
                except Exception as error:
                    logger.debug(f"SDL window unavailable ({error}); "
                                 "falling back to cv2 preview")
            if window is None and choice != "sdl":
                try:
                    import cv2
                    preview = cv2
                    cv2.namedWindow(self.title, cv2.WINDOW_NORMAL)
                    cv2.setMouseCallback(self.title, self._cv2_mouse_event)
                except Exception:
                    preview = None
        if preview is not None:
            # cv2 fallback key source: the X11 keymap poller where an X
            # server exists (exact transitions incl. Shift/Ctrl/Alt — cv2's
            # waitKey cannot express releases); AutoReleaseKeys otherwise.
            from shaderflow_tpu.io.x11keys import AutoReleaseKeys, X11Keymap
            self._keymap = X11Keymap()
            self._autorelease = AutoReleaseKeys()

        # A forced micro-batch (SHADERFLOW_RT_BATCH=N) covers N frame
        # periods per launch, so the launch task paces at fps/N; auto mode
        # starts per-frame and _rt_batch_feedback retunes the frequency.
        setting = os.environ.get("SHADERFLOW_RT_BATCH", "auto")
        forced = int(setting) if setting.isdigit() else 0
        self.vsync = self.scheduler.new(
            task=self._realtime_frame,
            frequency=self.fps / max(1, forced),
            frameskip=frameskip,
            precise=True,
        )
        self._preview = preview
        self._window = window
        self._pending_preview = None
        try:
            while self.scheduler.next() is not None:
                if self.quit:
                    break
        finally:
            pump = getattr(self, "_display_pump", None)
            if pump is not None:
                pump.close()
                self._display_pump = None
                self._inflight_rt = []
            if window is not None:
                window.close()
            if preview is not None:
                preview.destroyAllWindows()

    frame_limit: Optional[int] = None
    """Stop the realtime loop after N frames (tests / timed demos)."""

    def _realtime_frame(self, dt: float = 0.0) -> None:
        if self.frame_limit is not None and self.frame >= self.frame_limit:
            self.quit = True
            return
        has_display = (getattr(self, "_window", None) is not None
                       or getattr(self, "_preview", None) is not None)
        async_display = (has_display
                         and os.environ.get("SHADERFLOW_SYNC_DISPLAY") != "1")
        n = self._rt_batch_size(auto_ok=async_display)
        if self.frame_limit is not None:
            n = max(1, min(n, self.frame_limit - self.frame))
        self._rt_batch_active = n
        t0 = time.perf_counter()
        self.engine.begin_batch()
        for _ in range(n):
            self.next(dt=dt / n)
        dispatched = self.engine.flush(n)
        if async_display:
            self._async_display_frame(dispatched)
            # A launch that (re)compiled measures XLA compile time, not
            # loop cost: feeding it into the controller's EMA sent the
            # auto size climbing through EVERY intermediate batch size,
            # paying a 3-7 s engine compile per step (observed 08-19)
            if not getattr(self.engine, "last_flush_retraced", False):
                self._rt_batch_feedback(time.perf_counter() - t0, n)
            return
        # Synchronous display (SHADERFLOW_SYNC_DISPLAY=1, and headless):
        # show frame k-depth while the device renders frame k; the loop
        # blocks on frame k-depth's device->host transfer — every frame is
        # shown, at the cost of pacing at the link rate. Depth 1 is the
        # reference's GL swapchain double-buffer (scene.py:461-462);
        # SHADERFLOW_PREVIEW_DEPTH raises it.
        depth = max(1, int(os.environ.get("SHADERFLOW_PREVIEW_DEPTH", "1")))
        queue = getattr(self, "_pending_preview", None)
        if queue is None:
            queue = self._pending_preview = []
        queue.append(dispatched)
        if len(queue) <= depth:
            return
        frames = queue.pop(0)
        if getattr(self, "_window", None) is not None:
            frame = engine_fetch_frame(frames[-1])
            if self.render_ui:
                frame = self._draw_hud(frame.copy())
            self._window.show(frame)
            self._dispatch_window_events(self._window.poll())
        elif getattr(self, "_preview", None) is not None:
            cv2 = self._preview
            frame = engine_fetch_frame(frames[-1])
            if self.render_ui:
                frame = self._draw_hud(frame.copy())
            cv2.imshow(self.title, frame[..., ::-1])
            self._poll_input(cv2.waitKey(1) & 0xFF)
        else:
            np.asarray(frames)  # realize the computation for honest pacing

    # ------------------------------------------------------------------ #
    # Realtime micro-batching: when the per-launch cost (dispatch + display
    # offer) exceeds the frame budget on its own, rendering N frames per
    # launch amortizes it — the same trade the export path makes, scaled
    # down to keep input latency interactive (input is polled once per
    # launch, so N=4 at 60 fps samples input at 15 Hz).
    # SHADERFLOW_RT_BATCH=N forces a size; "auto" (default) starts at 1 and
    # doubles only while the measured per-frame loop cost misses the frame
    # budget.

    _RT_BATCH_MAX = 8

    def _rt_batch_size(self, auto_ok: bool) -> int:
        setting = os.environ.get("SHADERFLOW_RT_BATCH", "auto")
        if setting.isdigit():
            return max(1, int(setting))
        if not auto_ok:
            return 1
        return max(1, getattr(self, "_rt_batch_n", 1))

    def _rt_batch_feedback(self, call_seconds: float, n: int) -> None:
        """Adapt the auto micro-batch size from the measured loop cost
        (dispatch + display offer; transfers never block the loop). Three
        consecutive over-budget ticks double N; three consecutive ticks
        under 35% of budget halve it (hysteresis against oscillation)."""
        if not os.environ.get("SHADERFLOW_RT_BATCH", "auto") == "auto":
            return
        per_frame = call_seconds / max(1, n)
        period = 1.0 / max(1e-6, self.fps)
        ema = getattr(self, "_rt_cost_ema", per_frame)
        ema += 0.25 * (per_frame - ema)
        self._rt_cost_ema = ema
        streak = getattr(self, "_rt_streak", 0)
        if ema > 1.05 * period:
            streak = max(1, streak + 1)
        elif ema < 0.35 * period:
            streak = min(-1, streak - 1)
        else:
            streak = 0
        self._rt_streak = streak
        current = max(1, getattr(self, "_rt_batch_n", 1))
        new = current
        if streak >= 3 and current < self._RT_BATCH_MAX:
            # Jump to the PREDICTED size in one step: each size change
            # compiles a new engine program (seconds), so
            # stepping 1->2->4->8 pays three compiles where one suffices.
            # Launch cost is dispatch-dominated when over budget, so the
            # needed size scales with the miss ratio (next power of two).
            miss = ema / period
            factor = 2 ** max(1, math.ceil(math.log2(miss)))
            new = min(self._RT_BATCH_MAX, current * int(factor))
        elif streak <= -3 and current > 1:
            new = current // 2
        if new != current:
            self._rt_batch_n = new
            self._rt_streak = 0
            if self.vsync is not None:
                # One launch now covers `new` frames: the scheduler task
                # paces launches, so its frequency drops to fps/new while
                # each next() still steps dt/new per frame.
                self.vsync.frequency = self.fps / new
            logger.info(f"Realtime micro-batch -> {new} frames/launch "
                        f"(loop {ema * 1e3:.1f} ms/frame vs "
                        f"{period * 1e3:.1f} ms budget)")

    def _async_display_frame(self, dispatched) -> None:
        """Default windowed-display path: never block the loop on the
        device->host frame transfer (io/displaypump.py — latest-frame-wins).
        Scene time, input, audio and dynamics pace at the scheduler's fps
        even when the device->host link is slow; input
        is polled EVERY tick so interaction stays live between displayed
        frames. Device backpressure: at most 3 undrained launches before
        the loop blocks on the oldest — the swapchain-depth analogue
        (frameskip then stretches dt, like the reference when the GPU
        can't hold fps)."""
        pump = getattr(self, "_display_pump", None)
        if pump is None:
            from shaderflow_tpu.io.displaypump import DisplayPump
            pump = self._display_pump = DisplayPump()
            self._inflight_rt = []
        self._inflight_rt.append(dispatched)
        while len(self._inflight_rt) > 3:
            self._inflight_rt.pop(0)[0].block_until_ready()
        pump.offer(dispatched)
        frame = pump.take()
        if frame is not None:
            # The pump may transfer a device-decimated frame on slow links;
            # the window blits scaled, and the HUD hit map must translate
            # window pixels into THIS frame's pixel space (frame_xy)
            self._shown_frame_size = (frame.shape[1], frame.shape[0])
        if getattr(self, "_window", None) is not None:
            if frame is not None:
                if self.render_ui:
                    frame = self._draw_hud(frame.copy())
                self._window.show(frame)
            self._dispatch_window_events(self._window.poll())
        elif getattr(self, "_preview", None) is not None:
            cv2 = self._preview
            if frame is not None:
                if self.render_ui:
                    frame = self._draw_hud(frame.copy())
                cv2.imshow(self.title, frame[..., ::-1])
            self._poll_input(cv2.waitKey(1) & 0xFF)

    def _dispatch_window_events(self, events: list) -> None:
        """SDL window events -> message-bus relays (the reference's glfw
        callback surface, scene.py:708-841: key press/release with
        modifiers, unicode, mouse move/press/release/wheel with the
        Ctrl/Alt/exclusive drag intercepts, resize, file drop, close)."""
        Mouse = ShaderMessage.Mouse
        Keyboard = ShaderMessage.Keyboard

        def frame_xy(x: int, y: int) -> tuple[int, int]:
            # Window pixels -> SHOWN-frame pixels (the window may be
            # resized, and the display pump may decimate frames on slow
            # links; the frame blits scaled either way). The HUD hit map
            # lives in the shown frame's pixel space.
            window = getattr(self, "_window", None)
            if window is None:
                return x, y
            ww, wh = window.size
            fw, fh = (getattr(self, "_shown_frame_size", None)
                      or self.resolution)
            return (int(x * fw / max(1, ww)), int(y * fh / max(1, wh)))

        for event in events:
            kind = event[0]
            if kind == "keydown":
                key = event[1]
                if key == ShaderKeyboard.Keys.ESCAPE:
                    self.quit = True
                self.relay(Keyboard.KeyDown(key=key))
            elif kind == "keyup":
                self.relay(Keyboard.KeyUp(key=event[1]))
            elif kind == "unicode":
                self.relay(Keyboard.Unicode(char=event[1]))
            elif kind == "mousemove":
                _, x, y, dx, dy, held = event
                self._mouse_xy = (x, y)
                u, v = self._pixel_to_gluv(x, y)
                du = u - self.mouse_gluv[0]
                dv = v - self.mouse_gluv[1]
                self.mouse_inside = True
                if getattr(self, "_hud_dragging", False) and held:
                    self._hud_mouse("drag", *frame_xy(x, y), dx=dx, dy=dy)
                elif 1 in held or 2 in held:
                    self._handle_drag(x=x, y=y, dx=dx, dy=dy,
                                      u=u, v=v, du=du, dv=dv)
                else:
                    self.relay(Mouse.Position(x=x, y=y, dx=dx, dy=dy,
                                              u=u, v=v, du=du, dv=dv))
            elif kind in ("mousedown", "mouseup"):
                _, button, x, y = event
                state = kind == "mousedown"
                if state and button == 1 and self._hud_mouse(
                        "press", *frame_xy(x, y)):
                    self._hud_dragging = True
                    continue
                if (not state and button == 1
                        and getattr(self, "_hud_dragging", False)):
                    # Only the LEFT release ends (and is consumed by) a HUD
                    # drag; other buttons' releases must still relay, or
                    # their pressed state sticks and fakes a camera drag
                    self._hud_dragging = False
                    continue
                self.mouse_buttons[button] = state
                u, v = self._pixel_to_gluv(x, y)
                cls = Mouse.Press if state else Mouse.Release
                self.relay(cls(button=button, x=x, y=y, u=u, v=v))
            elif kind == "wheel":
                step = float(event[1])
                mx, my = getattr(self, "_mouse_xy", (-1, -1))
                if mx >= 0 and self._hud_mouse("wheel", *frame_xy(mx, my),
                                               dy=int(step)):
                    continue
                self.relay(Mouse.Scroll(dy=int(step), dv=step / 10))
            elif kind == "resize":
                _, width, height = event
                self.resize(width=width, height=height)
                self.relay(ShaderMessage.Window.Resize(width=width,
                                                       height=height))
            elif kind == "drop":
                self.relay(ShaderMessage.Window.FileDrop(files=[event[1]]))
            elif kind == "enter":
                self.mouse_inside = bool(event[1])
                self.relay(Mouse.Enter(state=bool(event[1])))
            elif kind == "iconify":
                self.relay(ShaderMessage.Window.Iconify(state=bool(event[1])))
            elif kind == "close":
                self.relay(ShaderMessage.Window.Close())

    def _poll_input(self, waitkey_code: int, now: float = None) -> None:
        """Per-frame keyboard input for the preview (reference event
        fidelity: glfw key callbacks deliver press AND release with
        modifiers, /root/reference/shaderflow/scene.py key events +
        camera.py:240-278 held-key navigation).

        Primary source: the X11 keymap poller (exact transitions, incl.
        Shift/Ctrl/Alt). Fallback (no X server): cv2 waitKey autorepeat
        codes — lowercase letters normalized to the key table, repeats
        suppressed, releases synthesized when the repeat train goes quiet,
        modifiers unavailable (see io/x11keys.py)."""
        Keyboard = ShaderMessage.Keyboard
        keymap = getattr(self, "_keymap", None)
        if keymap is not None and keymap.active:
            downs, ups = keymap.poll()
            for code in downs:
                if code == ShaderKeyboard.Keys.ESCAPE:
                    self.quit = True
                self.relay(Keyboard.KeyDown(key=code))
            for code in ups:
                self.relay(Keyboard.KeyUp(key=code))
            return
        import time as _time
        now = _time.monotonic() if now is None else now
        auto = getattr(self, "_autorelease", None)
        if auto is None:
            from shaderflow_tpu.io.x11keys import AutoReleaseKeys
            auto = self._autorelease = AutoReleaseKeys()
        key = waitkey_code
        if key == 27:  # ESC
            self.quit = True
        elif key != 255:
            if ord("a") <= key <= ord("z"):
                key -= 32  # key table is uppercase; waitKey yields ASCII
            if auto.feed(key, now):
                self.relay(Keyboard.KeyDown(key=key))
        for code in auto.poll(now):
            self.relay(Keyboard.KeyUp(key=code))

    def _ui_panels(self) -> list:
        """HUD panel order: every module, the scene's own panel last (the
        reference's imgui main-menu sliders — speed/quality/ssaa — live on
        the scene module itself)."""
        return [m for m in self.modules if m is not self] + [self]

    def _ui_selected_module(self):
        panels = self._ui_panels()
        return panels[self._ui_index % len(panels)] if panels else None

    def ui(self) -> list[str]:
        return [f"backend={self.backend.value}  quality={self.quality:.0f}",
                f"exclusive={self.exclusive}  fullscreen={self.fullscreen}"]

    def ui_fields(self) -> list:
        from shaderflow_tpu.module import UIField
        return [
            UIField("speed", lambda: self.speed,
                    lambda v: setattr(self, "speed", v),
                    step=0.1, fmt="{:+.2f}"),
            UIField("quality", lambda: self.quality,
                    lambda v: setattr(self, "quality", v),
                    step=5.0, minimum=0.0, maximum=100.0, fmt="{:.0f}"),
            # The ssaa PROPERTY setter (not resize(ssaa=)): it relays
            # RecreateTextures + invalidates the engine, which resize()
            # skips when the output resolution is unchanged
            UIField("ssaa", lambda: self.ssaa,
                    lambda v: setattr(self, "ssaa", v),
                    step=0.25, minimum=0.25, maximum=4.0, fmt="{:.2f}"),
        ]

    def _ui_nudge(self, direction: float) -> None:
        module = self._ui_selected_module()
        fields = module.ui_fields() if module is not None else []
        if not fields:
            return
        field = fields[self._ui_field_index % len(fields)]
        scale = 1.0
        if self.keyboard(ShaderKeyboard.Keys.LEFT_SHIFT):
            scale = 10.0
        elif self.keyboard(ShaderKeyboard.Keys.LEFT_CTRL):
            scale = 0.1
        value = field.nudge(direction, scale)
        logger.info(f"(-/+) {type(module).__name__} {field.label} -> {value:g}")

    _mouse_drag_time_factor: float = 4.0
    """Seconds scrubbed when an Alt+drag travels the full window height."""

    def _handle_drag(self, *, x: int, y: int, dx: int, dy: int,
                     u: float, v: float, du: float, dv: float) -> None:
        """Mouse-drag dispatch with the reference's modifier intercepts
        (scene.py:815-841): Ctrl+drag rolls the camera around its forward
        axis, exclusive mode free-looks (zoom + roll), Alt+drag scrubs
        time; otherwise the Drag message relays to every module."""
        import math as _math
        width, height = self.resolution
        if self.keyboard(ShaderKeyboard.Keys.LEFT_CTRL):
            cx, cy = (x - width / 2), (y - height / 2)
            angle = _math.atan2(cy + dy, cx + dx) - _math.atan2(cy, cx)
            if abs(angle) > _math.pi:
                angle -= 2 * _math.pi
            self.camera.rotate(self.camera.forward, degrees=_math.degrees(angle))
            return
        if self.exclusive:
            self.camera.apply_zoom(dy / 500)
            self.camera.rotate(self.camera.forward, degrees=-dx / 10)
            return
        if self.keyboard(ShaderKeyboard.Keys.LEFT_ALT):
            self.time -= self._mouse_drag_time_factor * (dy / max(1, height))
            return
        self.relay(ShaderMessage.Mouse.Drag(x=x, y=y, dx=dx, dy=dy,
                                            u=u, v=v, du=du, dv=dv))

    def _pixel_to_gluv(self, x: int, y: int) -> tuple[float, float]:
        """Window pixel -> gluv: x in [-aspect, aspect], y in [-1, 1], v up
        (reference scene.py pixel-to-uv conversions)."""
        width, height = self.resolution
        u = (2.0 * ((x + 0.5) / max(1, width)) - 1.0) * self.aspect_ratio
        v = 1.0 - 2.0 * ((y + 0.5) / max(1, height))
        return (u, v)

    def _cv2_mouse_event(self, event: int, x: int, y: int, flags: int,
                         param=None) -> None:
        """cv2 preview mouse callback -> message-bus relay (the headless
        stand-in for the reference's glfw mouse events; feeds the camera's
        Drag/Scroll navigation and the iMouse* uniforms)."""
        cv2 = getattr(self, "_preview", None)
        if cv2 is None:
            return
        u, v = self._pixel_to_gluv(x, y)
        du, dv = u - self.mouse_gluv[0], v - self.mouse_gluv[1]
        Mouse = ShaderMessage.Mouse
        self.mouse_inside = True
        buttons = {cv2.EVENT_LBUTTONDOWN: (1, True), cv2.EVENT_LBUTTONUP: (1, False),
                   cv2.EVENT_RBUTTONDOWN: (2, True), cv2.EVENT_RBUTTONUP: (2, False),
                   cv2.EVENT_MBUTTONDOWN: (3, True), cv2.EVENT_MBUTTONUP: (3, False)}
        if event in buttons:
            button, state = buttons[event]
            if state and button == 1 and self._hud_mouse("press", x, y):
                self._hud_dragging = True
                return
            if (not state and button == 1
                    and getattr(self, "_hud_dragging", False)):
                self._hud_dragging = False
                return
            self.mouse_buttons[button] = state
            cls = Mouse.Press if state else Mouse.Release
            self.relay(cls(button=button, x=x, y=y, u=u, v=v))
        elif event == cv2.EVENT_MOUSEMOVE:
            if getattr(self, "_hud_dragging", False):
                dx = int(round((du / 2 / max(1e-9, self.aspect_ratio)) * self.resolution[0]))
                self._hud_mouse("drag", x, y, dx=dx)
            elif self.mouse_buttons.get(1) or self.mouse_buttons.get(2):
                dx = int(round((du / 2 / max(1e-9, self.aspect_ratio)) * self.resolution[0]))
                dy = int(round((-dv / 2) * self.resolution[1]))
                self._handle_drag(x=x, y=y, dx=dx, dy=dy, u=u, v=v, du=du, dv=dv)
            else:
                self.relay(Mouse.Position(x=x, y=y, u=u, v=v, du=du, dv=dv))
        elif event == getattr(cv2, "EVENT_MOUSEWHEEL", -1):
            step = 1.0 if flags > 0 else -1.0
            self.relay(Mouse.Scroll(dy=int(step), dv=step / 10))

    def _draw_hud(self, frame: np.ndarray) -> np.ndarray:
        """Minimal stats overlay for the realtime preview (TAB toggles) —
        the headless-friendly stand-in for the reference's imgui panels
        (scene.py:856-932): per-module lines + frametimer stats. Text
        rasterizes via cv2 when installed, else pygame.font — independent
        of which window backend displays the frame."""
        lines = [
            (f"{self.name}  {self.render_resolution} -> {self.resolution} "
             f"@ {self.ssaa:.2f}x SSAA", None),
            (f"t={self.time:6.2f}s  frame={self.frame}  speed={self.speed:.2f}",
             None),
            (f"fps avg {self.frametimer.framerate_average():6.1f}  "
             f"min {self.frametimer.framerate_minimum:6.1f}  target {self.fps:.0f}",
             None),
        ]
        # Module list with the selected panel expanded ([ and ] navigate,
        # or click a row; each line carries its mouse action). The scene's
        # own panel (speed/quality/ssaa) comes last.
        panels = self._ui_panels()
        selected = panels[self._ui_index % len(panels)] if panels else None
        plot_strips: list[tuple] = []  # (first row, values, lo, hi)
        for module_index, module in enumerate(panels):
            marker = ">" if module is selected else " "
            label = "Scene" if module is self else type(module).__name__
            lines.append((f" {marker}{module.uuid:>2} {label}"
                          + (f" ({module.name})" if module.name else ""),
                          ("module", module_index)))
            if module is selected:
                try:
                    for panel_line in module.ui() or []:
                        lines.append((f"      {panel_line}", None))
                    fields = module.ui_fields()
                    for index, field in enumerate(fields):
                        edit = "*" if index == self._ui_field_index % len(fields) else " "
                        lines.append((f"     {edit}{field.render()}"
                                      "   (-/+ or drag)",
                                      ("field", index)))
                    # Sparkline plots (imgui PlotLines): label row + a
                    # reserved 3-row strip rasterized after the text pass
                    for plot in module.ui_plots() or []:
                        values = np.asarray(list(plot.values), np.float32)
                        if values.size < 2:
                            continue
                        lo = plot.lo if plot.lo is not None else float(values.min())
                        hi = plot.hi if plot.hi is not None else float(values.max())
                        lines.append((f"      {plot.label}  "
                                      f"[{values[-1]:.3g}]  {lo:.3g}..{hi:.3g}",
                                      None))
                        plot_strips.append((len(lines), values, lo, hi))
                        lines.extend([("", None)] * self._HUD_PLOT_ROWS)
                except Exception as error:
                    lines.append((f"      ui() error: {error}", None))
        lines = lines[:28]
        plot_strips = [(row, v, lo, hi) for row, v, lo, hi in plot_strips
                       if row + self._HUD_PLOT_ROWS <= len(lines)]
        # Row hit map for mouse interaction: row i spans y in
        # [6 + 16 i, 6 + 16 (i+1)) at x < _HUD_WIDTH (see _hud_mouse)
        self._hud_rows = [action for _, action in lines]
        # Panel backdrop (imgui-style darkened box) for legibility
        y1 = min(frame.shape[0], self._HUD_ROW0 + self._HUD_ROWH * len(lines) + 6)
        x1 = min(frame.shape[1], self._HUD_WIDTH)
        frame[:y1, :x1] = frame[:y1, :x1] // 2
        try:
            import cv2
            for index, (text, _) in enumerate(lines):
                cv2.putText(frame, text, (8, 18 + 16 * index),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.42, (0, 0, 0), 2, cv2.LINE_AA)
                cv2.putText(frame, text, (8, 18 + 16 * index),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.42, (255, 255, 255), 1, cv2.LINE_AA)
        except ImportError:
            # cv2 is an optional extra; the SDL preview must not crash on
            # TAB without it — pygame.font rasterizes the same rows
            from shaderflow_tpu.io.sdlwindow import SDLWindow
            SDLWindow.draw_text(frame, [text for text, _ in lines],
                                origin=(8, self._HUD_ROW0),
                                pitch=self._HUD_ROWH)
        for row, values, lo, hi in plot_strips:
            self._raster_plot(frame, row, values, lo, hi)
        return frame

    def _raster_plot(self, frame: np.ndarray, row: int,
                     values: np.ndarray, lo: float, hi: float) -> None:
        """Rasterize one sparkline strip into the HUD (pure numpy: works
        under every window backend, no cv2/pygame dependency)."""
        y0 = self._HUD_ROW0 + self._HUD_ROWH * row + 2
        height = self._HUD_ROWH * self._HUD_PLOT_ROWS - 6
        x0, width = 14, min(self._HUD_WIDTH - 28, frame.shape[1] - 14)
        if y0 + height > frame.shape[0] or width < 8:
            return
        strip = frame[y0:y0 + height, x0:x0 + width]
        strip //= 2  # darken twice: the plot bed reads against the backdrop
        columns = np.interp(np.linspace(0, values.size - 1, width),
                            np.arange(values.size), values)
        span = (hi - lo) or 1.0
        ys = np.clip(((hi - columns) / span) * (height - 1), 0,
                     height - 1).astype(np.int32)
        xs = np.arange(width)
        strip[ys, xs] = 255
        strip[np.clip(ys + 1, 0, height - 1), xs] = 255

    _HUD_WIDTH = 420      # panel hit width, frame pixels
    _HUD_ROW0 = 6         # first row's top edge
    _HUD_ROWH = 16        # row pitch (matches putText layout above)
    _HUD_PLOT_ROWS = 3    # text rows one sparkline strip occupies

    def _hud_mouse(self, kind: str, x: int, y: int,
                   dx: int = 0, dy: int = 0) -> bool:
        """Mouse interaction with the HUD panel (the imgui-class surface:
        click a module row to open its panel, click a field row to select
        it, drag horizontally on a field to scrub its value, wheel to
        nudge). Returns True when the event was consumed by the panel —
        callers then skip the scene-level relay, exactly like imgui's
        want_capture_mouse (/root/reference/shaderflow/scene.py:728-735).
        Coordinates are FRAME pixels (callers map from window pixels)."""
        rows = getattr(self, "_hud_rows", None)
        if not self.render_ui or not rows:
            return False
        if x >= self._HUD_WIDTH or y < self._HUD_ROW0:
            return False
        row = (y - self._HUD_ROW0) // self._HUD_ROWH
        if row >= len(rows):
            return False
        action = rows[row]
        if kind == "press":
            if action is None:
                return True   # clicks on panel text never leak to the scene
            what, index = action
            if what == "module":
                self._ui_index = index
                self._ui_field_index = 0
            else:
                self._ui_field_index = index
            return True
        if kind == "drag":
            if action is not None and action[0] == "field":
                self._ui_field_index = action[1]
            if dx:
                self._ui_nudge(1.0 if dx > 0 else -1.0)
            return True
        if kind == "wheel":
            self._ui_nudge(1.0 if dy > 0 else -1.0)
            return True
        return False

    # ------------------------------------------------------------------ #
    # Module protocol

    def handle(self, message: Any) -> None:
        if isinstance(message, ShaderMessage.Window.Close):
            self.quit = True

        elif isinstance(message, ShaderMessage.Keyboard.KeyDown):
            if message.key == ShaderKeyboard.Keys.O:
                logger.info("(O  ) Resetting the scene")
                for module in self.modules:
                    module.setup()
                self.time = 0
                if self.engine is not None:
                    self.engine.reset_carry()
            elif message.key == ShaderKeyboard.Keys.R:
                logger.info("(R  ) Reloading shaders")
                self.relay(ShaderMessage.Shader.Compile)
            elif message.key == ShaderKeyboard.Keys.TAB:
                self.render_ui = not self.render_ui
            elif message.key == ShaderKeyboard.Keys.BRACKET_LEFT:
                self._ui_index -= 1
                self._ui_field_index = 0
            elif message.key == ShaderKeyboard.Keys.BRACKET_RIGHT:
                self._ui_index += 1
                self._ui_field_index = 0
            elif message.key == ShaderKeyboard.Keys.COMMA:
                self._ui_field_index -= 1
            elif message.key == ShaderKeyboard.Keys.PERIOD:
                self._ui_field_index += 1
            elif message.key in (ShaderKeyboard.Keys.MINUS,
                                 ShaderKeyboard.Keys.EQUAL,
                                 ShaderKeyboard.Keys.PLUS):
                # Live parameter editing on the selected panel field (the
                # reference's imgui drag-floats, scene.py:856-932): -/+
                # nudge by the field's step; Shift x10, Ctrl x0.1
                self._ui_nudge(-1.0 if message.key == ShaderKeyboard.Keys.MINUS
                               else +1.0)
            elif message.key == ShaderKeyboard.Keys.F1:
                logger.info("(F1 ) Toggling exclusive mode")
                self.exclusive = not self.exclusive
                if getattr(self, "_window", None) is not None:
                    # Grab + hide the cursor for free-look (reference glfw
                    # cursor-disabled mode, scene.py:651-682)
                    self._window.set_exclusive(self.exclusive)
            elif message.key == ShaderKeyboard.Keys.F2:
                from datetime import datetime
                import shaderflow_tpu
                from PIL import Image
                stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
                path = (shaderflow_tpu.directories.ensure().user_data_path
                        / "screenshots" / f"({stamp}) {self.name}.png")
                path.parent.mkdir(parents=True, exist_ok=True)
                logger.info(f"(F2 ) Saving screenshot to ({path})")
                Image.fromarray(self.screenshot()).save(path)
            elif message.key == ShaderKeyboard.Keys.F11:
                logger.info("(F11) Toggling fullscreen")
                self.fullscreen = not self.fullscreen
                if getattr(self, "_window", None) is not None:
                    self._window.set_fullscreen(self.fullscreen)
                elif getattr(self, "_preview", None) is not None:
                    cv2 = self._preview
                    cv2.setWindowProperty(
                        self.title, cv2.WND_PROP_FULLSCREEN,
                        cv2.WINDOW_FULLSCREEN if self.fullscreen else cv2.WINDOW_NORMAL)

        elif isinstance(message, (ShaderMessage.Mouse.Drag, ShaderMessage.Mouse.Position)):
            self.mouse_gluv = (message.u, message.v)

    def pipeline(self) -> Iterable[ShaderVariable]:
        """Global uniforms every shader sees (scene.py:687-703 set)."""
        u = self.uniform  # cached objects (module.uniform) — host hot path
        yield u("int", "iLayer", None)  # injected per layer by the engine
        yield u("float", "iTime", self.time)
        yield u("float", "iTau", self.tau)
        yield u("float", "iDuration", self.duration)
        yield u("float", "iDeltatime", self.dt)
        yield u("vec2", "iResolution", self.resolution)
        yield u("float", "iWantAspect", self.aspect_ratio)
        yield u("float", "iQuality", self.quality / 100)
        # Static twin of iQuality for shaders that derive loop trip counts
        # from it (e.g. fractal escape iterations): changing quality
        # re-specializes the program instead of tracing a dynamic bound
        from shaderflow_tpu.variable import StaticUniform
        yield StaticUniform("float", "iQualityS", self.quality / 100)
        yield u("float", "iSSAA", self.ssaa)
        yield u("float", "iFramerate", self.fps)
        yield u("int", "iFrame", self.frame)
        # True stepped-frame counter (== iFrame only when speed == 1); the
        # engine indexes device-resident texture sequences with it
        yield u("int", "iFrameIndex", self._frame_counter)
        yield u("bool", "iRealtime", self.realtime)
        yield u("vec2", "iMouse", self.mouse_gluv)
        yield u("bool", "iMouseInside", self.mouse_inside)
        for i in range(1, 3):
            yield u("bool", f"iMouse{i}", self.mouse_buttons[i])

    # ------------------------------------------------------------------ #

    def destroy(self) -> None:
        for module in self.modules:
            if module is not self:
                module.destroy()
