"""
Export orchestration: configure the encoder, move frame batches, track stats.

Role-equivalent of the reference exporting helper
(/root/reference/shaderflow/exporting.py): output type selection
(file/pipe), tqdm progress with optional relay callback, FFmpeg pipe-input
configuration at the scene size, per-module ffhook mutation of the encoder
command, the frame transport (here: device batches -> VideoSink -> C++
frame pump), crash detection, and the closing "Took Xs at Yfps | Zx
Realtime" stats log.

Differences: frames arrive as (F, H, W, 3) uint8 device batches already
downsampled and quantized on the device; no vflip filter is needed (frames leave
the device top-down); when no ffmpeg binary exists the sink falls back to
OpenCV/raw writers (io/sinks.py) and audio is written as a sidecar WAV.
"""

from __future__ import annotations

import time
import wave
from datetime import datetime
from enum import Enum
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Optional, Union

import numpy as np

from shaderflow_tpu import logger
from shaderflow_tpu.io.ffmpeg import FFmpeg
from shaderflow_tpu.io.sinks import (
    CV2Sink, FFmpegSink, ImageSink, NullSink, PipeSink, RawSink, VideoSink,
)

if TYPE_CHECKING:
    from shaderflow_tpu.scene import ShaderScene


class OutputType(str, Enum):
    PATH = "file"
    PIPE = "pipe"
    TCP = "tcp"
    NULL = "null"


class ExportingHelper:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.type: Optional[OutputType] = None
        self.sink: Optional[VideoSink] = None
        self.frame = 0
        self.start = time.monotonic()
        self.relay: Optional[Callable[[int, int], None]] = None
        self.bar = None
        self.took: Optional[float] = None
        self._sidecar_audio: Optional[Path] = None

    @property
    def ffmpeg(self) -> FFmpeg:
        return self.scene.ffmpeg

    @property
    def total_frames(self) -> int:
        return max(1, round(self.scene.runtime * self.scene.fps))

    @property
    def finished(self) -> bool:
        return self.frame >= self.total_frames

    # -- progress -----------------------------------------------------------

    def open_bar(self) -> None:
        import tqdm
        self.bar = tqdm.tqdm(
            total=self.total_frames,
            disable=((self.relay is False) or bool(self.relay) or self.scene.realtime),
            desc=f"Scene ({self.scene.name}) → Video",
            unit=" frames",
            dynamic_ncols=True,
            mininterval=1 / 30,
            maxinterval=0.5,
            smoothing=0.1,
            leave=False,
        )

    def update(self, count: int = 1) -> None:
        if self.relay:
            self.relay(self.frame, self.total_frames)
        if self.bar:
            self.bar.update(count)
        self.frame += count

    # -- FFmpeg command configuration ----------------------------------------

    def ffmpeg_clean(self) -> None:
        # User-composed filters (CLI chained `scale`/`vflip`, build() hooks)
        # survive across exports; only the exporter's OWN size adapter is
        # dropped (it re-derives per export below)
        self.ffmpeg.filters = [f for f in self.ffmpeg.filters
                               if not getattr(f, "_exporter_added", False)]
        self.ffmpeg.clear(video_codec=False, audio_codec=False, filters=False)

    def ffmpeg_sizes(self, width: int, height: int) -> None:
        """Pipe rawvideo at the scene output size; scale only if the encode
        target differs (raw mode exports at render resolution)."""
        scene = self.scene
        self.ffmpeg.time = scene.runtime
        self.ffmpeg.pipe_input(
            pixel_format="rgb24",
            width=scene.width,
            height=scene.height,
            framerate=scene.fps,
        )
        if (width, height) != (scene.width, scene.height):
            self.ffmpeg.scale(width=width, height=height)
            self.ffmpeg.filters[-1]._exporter_added = True

    def ffmpeg_output(self, output: Union[Path, str]) -> None:
        if output in ("pipe", "-", bytes):
            self.type = OutputType.PIPE
            self.ffmpeg.pipe_output(format="matroska")
        else:
            self.type = OutputType.PATH
            output = Path(output).expanduser().absolute()
            if not output.name:
                stamp = datetime.now().strftime("%Y-%m-%d %H-%M-%S")
                output = output / f"({stamp}) {self.scene.name}.mp4"
            output.parent.mkdir(parents=True, exist_ok=True)
            self.ffmpeg.output(path=output)

    def ffhook(self) -> None:
        for module in self.scene.modules:
            module.ffhook(self.ffmpeg)

    # -- sink selection ------------------------------------------------------

    def make_sink(self, output: Union[Path, str, None], *, width: int, height: int,
                  turbo: bool = True, buffers: int = 5) -> VideoSink:
        scene = self.scene
        frame_bytes = scene.width * scene.height * 3

        if output is None or str(output) in ("null", "null://", "/dev/null"):
            self.type = OutputType.NULL
            self.sink = NullSink()
            return self.sink

        if output in ("pipe", "-", bytes):
            self.type = OutputType.PIPE
            if FFmpeg.available():
                self.ffmpeg_clean()
                self.ffmpeg_sizes(width, height)
                self.ffmpeg_output(output)
                self._default_codecs()
                self.ffhook()
                self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo, pipe_output=True)
            else:
                logger.warn("No ffmpeg binary: pipe output returns raw rgb24 bytes")
                self.sink = PipeSink()
            return self.sink

        if isinstance(output, str) and output.startswith("tcp://"):
            # Reference exporting.py:24-27 TCP output: with an encoder the
            # FFmpeg process connects to the URL (mpegts); binary-free, we
            # stream raw rgb24 over the socket ourselves.
            self.type = OutputType.TCP
            if FFmpeg.available():
                self.ffmpeg_clean()
                self.ffmpeg_sizes(width, height)
                self.ffmpeg.output(path=output, options={"f": "mpegts"})
                self._default_codecs()
                self.ffhook()
                self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo)
            else:
                from shaderflow_tpu.io.sinks import TCPSink
                logger.warn("No ffmpeg binary: streaming raw rgb24 over TCP")
                self.sink = TCPSink(output)
            return self.sink

        path = Path(output).expanduser().absolute()
        suffix = path.suffix.lower()

        # CV2Sink/RawSink receive the piped frames verbatim (no encoder-side
        # rescale exists): size them from the actual frame size. In raw or
        # ssaa<1 exports scene.resolution is the render resolution, not the
        # requested output size — FFmpegSink handles that via a scale filter,
        # these sinks cannot.
        pipe_w, pipe_h = scene.width, scene.height

        def warn_no_rescale():
            if (pipe_w, pipe_h) != (width, height):
                logger.warn(
                    f"Output rescale {pipe_w}x{pipe_h} -> {width}x{height} needs "
                    f"an ffmpeg binary; writing {pipe_w}x{pipe_h} frames as-is")

        if suffix in (".rgb", ".raw"):
            warn_no_rescale()
            self.type = OutputType.PATH
            self.sink = RawSink(path, pipe_w, pipe_h, scene.fps)
        elif suffix in ("", ".png") or path.is_dir():
            self.type = OutputType.PATH
            self.sink = ImageSink(path if suffix == "" else path.parent)
        elif FFmpeg.available():
            self.ffmpeg_clean()
            self.ffmpeg_sizes(width, height)
            self.ffmpeg_output(path)
            self._default_codecs()
            self.ffhook()
            self.type = OutputType.PATH
            self.sink = FFmpegSink(self.ffmpeg, frame_bytes, buffers, turbo)
        else:
            logger.warn(f"No ffmpeg binary: encoding {path.name} with OpenCV "
                        f"(audio, if any, becomes a sidecar .wav)")
            warn_no_rescale()
            self.type = OutputType.PATH
            self.sink = CV2Sink(path, pipe_w, pipe_h, scene.fps)
            self._write_sidecar_audio(path)
        return self.sink

    def _default_codecs(self) -> None:
        """Reference defaults: x264 slow crf20 video, AAC audio when an
        audio input was hooked (ffmpeg.py:163,188 defaults)."""
        if self.ffmpeg.vcodec is None:
            self.ffmpeg.h264(preset="slow", crf=20)
        if self.ffmpeg.acodec is None:
            self.ffmpeg.aac()

    def _write_sidecar_audio(self, video_path: Path) -> None:
        """Without ffmpeg we cannot mux; persist the scene's audio track as
        '<output>.wav' so nothing is lost."""
        for module in self.scene.modules:
            audio_file = getattr(module, "file", None)
            data = getattr(module, "data", None)
            samplerate = getattr(module, "samplerate", None)
            if audio_file is None or data is None or samplerate is None:
                continue
            target = video_path.with_suffix(video_path.suffix + ".wav")
            try:
                from shaderflow_tpu.io.ffmpeg import FFmpeg as FF
                samples = FF.get_audio_numpy(audio_file)
                if samples is None:
                    continue
                limit = int(self.scene.runtime * samplerate)
                samples = samples[:limit]
                with wave.open(str(target), "wb") as handle:
                    handle.setnchannels(samples.shape[1])
                    handle.setsampwidth(2)
                    handle.setframerate(int(samplerate))
                    handle.writeframes(
                        (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
                self._sidecar_audio = target
                logger.info(f"Wrote sidecar audio {target}")
            except Exception as error:
                logger.warn(f"Could not write sidecar audio: {error}")
            return

    # -- frame transport -----------------------------------------------------

    @property
    def wants_host_frames(self) -> bool:
        """True when the sink consumes frame bytes on the host (everything
        except NullSink / no sink) — gates the export loop's early async
        device->host copies."""
        return self.sink is not None and not isinstance(self.sink, NullSink)

    def pipe_batch(self, frames) -> None:
        """Send one uint8 (F, H, W, 3) batch to the sink. Accepts device
        arrays or engine.WireBatch (flat-on-the-wire delivery, reshaped
        back here for free); the host copy happens here (and is skipped
        entirely for NullSink, which measures pure render throughput)."""
        count = int(frames.shape[0])
        if self.sink is None:
            self.update(count)
            return
        if isinstance(self.sink, NullSink):
            import jax
            from shaderflow_tpu.engine import WireBatch
            jax.block_until_ready(
                frames.flat if isinstance(frames, WireBatch) else frames)
            self.sink.frames += count
            self.sink.bytes += int(np.prod(frames.shape))
        else:
            from shaderflow_tpu.engine import WireBatch
            if isinstance(frames, WireBatch):
                self.sink.write_batch(frames.fetch())
            else:
                self.sink.write_batch(np.asarray(frames))
        self.update(count)

    # -- finish --------------------------------------------------------------

    def finish(self) -> Optional[Union[Path, bytes]]:
        result = self.sink.finish() if self.sink is not None else None
        if self.bar is not None:
            self.bar.close()
        self.took = time.monotonic() - self.start
        return result

    def log_stats(self, output=None) -> None:
        if self.scene.exporting and output is not None:
            logger.info(f"Finished rendering ({output})")
        took = self.took or (time.monotonic() - self.start)
        logger.info(
            f"• Stats: (Took {took:.2f}s) at "
            f"({self.frame / took:.2f}fps | "
            f"{self.scene.runtime / took:.2f}x Realtime) with "
            f"({self.frame} Total Frames)")
