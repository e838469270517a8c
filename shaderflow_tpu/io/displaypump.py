"""Latest-frame-wins device->host transfer worker for the realtime preview.

The reference's realtime loop blocks on the GL swapchain (double-buffered
vsync, reference scene.py:461-462) — the GPU-to-screen path is free there.
Here the displayed frame must cross device->host first. Blocking the render
loop on that transfer caps the whole scene — input, dynamics, audio — at
the link rate whenever the link is slower than the frame period.

This pump decouples them: the loop offers every dispatched frame handle and
picks up the newest COMPLETED host frame, never blocking. Transfers slower
than the frame period drop frames (latest wins) instead of stalling scene
time — the standard game-engine behavior when presentation can't keep up.

Two additional defenses for slow links, where back-to-back display
transfers could starve the dispatch stream:

- **Duty cycling**: after each transfer the worker idles so transfers
  occupy at most SHADERFLOW_DISPLAY_DUTY (default 0.35) of the channel,
  leaving the rest for render dispatches. Fast links (transfer < 5 ms)
  never idle.
- **Adaptive decimation**: when a full-resolution transfer exceeds
  SHADERFLOW_DISPLAY_MS (default 150 ms), the worker strided-slices the
  frame ON DEVICE to the smallest power-of-2 decimation (<= 8) that fits
  the budget, shrinking the bytes that cross the link. The window blits
  scaled, so a decimated preview frame displays at the same size; the
  scene's HUD hit map tracks the shown frame's true pixel size
  (scene._shown_frame_size).

On locally-attached hardware (PCIe, ~ms transfers) both defenses are
no-ops: the pump keeps up with every frame at full resolution and overlaps
the transfer with the next frame's render.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

import numpy as np


class DisplayPump:
    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._handle: Any = None          # newest dispatched device frames
        self._result: Optional[np.ndarray] = None  # newest completed host frame
        self._stop = False
        self._duty = float(os.environ.get("SHADERFLOW_DISPLAY_DUTY", "0.35"))
        self._target_s = float(os.environ.get("SHADERFLOW_DISPLAY_MS",
                                              "150")) / 1e3
        self.decimate = 1                 # current device-side stride
        self._warm_sig = None             # last (decimate, shape) fetched
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="shaderflow-display")
        self._thread.start()

    def offer(self, frames: Any) -> None:
        """Hand the newest dispatched (N, H, W, 3) device batch to the pump.
        Replaces any not-yet-started handle (latest wins); never blocks."""
        with self._cv:
            self._handle = frames
            self._cv.notify()

    def take(self) -> Optional[np.ndarray]:
        """The newest completed host frame, or None if the transfer in
        flight hasn't finished since the last take. Never blocks."""
        with self._cv:
            result, self._result = self._result, None
            return result

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _fetch(self, frames: Any) -> np.ndarray:
        """Transfer the newest frame of the batch, decimated on device when
        the link can't move a full frame within the budget."""
        k = self.decimate
        frame = frames[-1]
        if k > 1:
            try:
                frame = frame[::k, ::k, :]
            except Exception:
                pass  # non-sliceable input: transfer full
        # Unpadded wire layout: flatten on device first (engine.fetch_frame)
        from shaderflow_tpu.engine import fetch_frame
        return fetch_frame(frame)

    def _adapt(self, seconds: float, host: np.ndarray) -> None:
        """Pick the next transfer's decimation from this one's measured
        rate: smallest power-of-2 stride whose FULL-frame cost estimate
        fits the budget (full cost = measured cost x current k^2)."""
        if seconds <= 0 or host.nbytes == 0:
            return
        full_s = seconds * (self.decimate ** 2)
        k = 1
        while k < 8 and full_s / (k * k) > self._target_s:
            k *= 2
        self.decimate = k

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._handle is None and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                frames, self._handle = self._handle, None
            # Wait for the render to COMPLETE before timing: the adaptive
            # decimation must see pure link cost, not device compute (a
            # cold-compile wait would otherwise read as a slow link and
            # needlessly decimate the preview)
            try:
                frames.block_until_ready()
            except Exception:
                pass
            sig = (self.decimate, getattr(frames, "shape", None))
            t0 = time.perf_counter()
            host = self._fetch(frames)    # blocks THIS thread only
            took = time.perf_counter() - t0
            with self._cv:
                self._result = host
            if sig == self._warm_sig:
                self._adapt(took, host)
            else:
                # First fetch in this (decimate, shape) config pays the
                # one-time jit compile of the slice/index op — not a link
                # measurement; never adapt on it
                self._warm_sig = sig
            # Duty cycle: idle so transfers leave the shared RPC channel
            # free for render dispatches (interruptible by close())
            if took > 5e-3 and 0.0 < self._duty < 1.0:
                idle = took * (1.0 / self._duty - 1.0)
                deadline = time.perf_counter() + idle
                with self._cv:
                    while not self._stop:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                    if self._stop:
                        return
