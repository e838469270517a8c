"""Async latest-frame-wins display path (io/displaypump.py).

The realtime loop must never block on the device->host frame transfer
(a slow link can take longer than a frame period), scene pacing and
input stay live between displayed frames, and slow transfers drop frames
latest-wins instead of queueing. Reference behavior being replaced: the GL
swapchain blit, reference scene.py:461-462 (free on-GPU; not free here)."""

import time

import numpy as np
import pytest

from shaderflow_tpu.io.displaypump import DisplayPump


def test_pump_transfers_latest_and_never_blocks():
    pump = DisplayPump()
    try:
        a = np.full((1, 4, 4, 3), 1, np.uint8)
        b = np.full((1, 4, 4, 3), 2, np.uint8)
        pump.offer(a)
        deadline = time.time() + 5.0
        got = None
        while got is None and time.time() < deadline:
            got = pump.take()
            time.sleep(0.001)
        assert got is not None and got[0, 0, 0] == 1
        # take() drained it; nothing new -> None, and it returns immediately
        t0 = time.perf_counter()
        assert pump.take() is None
        assert time.perf_counter() - t0 < 0.1
        # Two offers before the worker wakes: only the LATEST must win when
        # the first hasn't started (replace-in-slot semantics)
        pump.offer(a)
        pump.offer(b)
        seen = []
        deadline = time.time() + 5.0
        while time.time() < deadline and len(seen) < 2:
            got = pump.take()
            if got is not None:
                seen.append(int(got[0, 0, 0]))
            time.sleep(0.001)
        assert seen[-1] == 2  # the newest frame always arrives
    finally:
        pump.close()


def test_pump_close_is_idempotent_and_fast():
    pump = DisplayPump()
    t0 = time.perf_counter()
    pump.close()
    assert time.perf_counter() - t0 < 5.0


class _SlowFrames:
    """Device-batch stand-in whose transfer takes `delay` seconds."""

    def __init__(self, value: int, delay: float, log: list):
        self._value = value
        self._delay = delay
        self._log = log

    def __getitem__(self, index):
        return self

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay)
        self._log.append(self._value)
        return np.full((4, 4, 3), self._value, np.uint8)


def test_slow_transfers_drop_frames_latest_wins():
    log = []
    pump = DisplayPump()
    try:
        # Offer 10 frames faster than the 30 ms "link" can drain
        for k in range(10):
            pump.offer(_SlowFrames(k, 0.03, log))
            time.sleep(0.005)
        deadline = time.time() + 5.0
        last = None
        while time.time() < deadline:
            got = pump.take()
            if got is not None:
                last = int(got[0, 0, 0])
                if last == 9:
                    break
            time.sleep(0.005)
        assert last == 9          # newest eventually shown
        assert len(log) < 10      # intermediate frames were DROPPED
    finally:
        pump.close()


def test_realtime_async_display_defaults_on(monkeypatch):
    """The windowed realtime loop uses the pump by default and still shows
    frames + dispatches events (SDL dummy driver)."""
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_PREVIEW", "sdl")
    from shaderflow_tpu.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 8
    pygame.display.init()
    scene.main(width=32, height=16, fps=60)
    assert scene.frame >= 1
    # Pump was created (async path taken) and torn down at loop exit
    assert getattr(scene, "_display_pump", None) is None


def test_realtime_sync_display_flag(monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_PREVIEW", "sdl")
    monkeypatch.setenv("SHADERFLOW_SYNC_DISPLAY", "1")
    from shaderflow_tpu.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 6
    pygame.display.init()
    scene.main(width=32, height=16, fps=60)
    assert scene.frame >= 1
    assert getattr(scene, "_display_pump", None) is None  # never created


def test_pump_adaptive_decimation_and_duty(monkeypatch):
    """Slow transfers pick a power-of-2 device-side decimation that fits
    the budget, and fast ones return to full resolution."""
    pump = DisplayPump.__new__(DisplayPump)  # controller logic only
    pump.decimate = 1
    pump._duty = 0.35
    pump._target_s = 0.150
    host = np.zeros((8, 8, 3), np.uint8)
    # 600 ms full-frame transfer -> needs /2/2 = x4 area reduction... the
    # smallest k with 0.6/k^2 <= 0.15 is k=2; a 2.5 s one needs k=8 (cap)
    pump._adapt(0.600, host)
    assert pump.decimate == 2
    pump.decimate = 1
    pump._adapt(2.5, host)
    assert pump.decimate == 8
    # From a decimated measurement the FULL cost is extrapolated: a 40 ms
    # transfer at k=4 means full ~640 ms -> 640/16 <= 150 keeps k=4
    pump.decimate = 4
    pump._adapt(0.040, host)
    assert pump.decimate == 4
    # Fast link: back to full resolution
    pump.decimate = 4
    pump._adapt(0.0001, host)
    assert pump.decimate == 1


def test_pump_fetch_decimates_and_takes_newest():
    pump = DisplayPump()
    try:
        pump.close()  # only using _fetch directly
        batch = np.stack([np.full((8, 8, 3), k, np.uint8) for k in (1, 2)])
        pump.decimate = 2
        got = pump._fetch(batch)
        assert got.shape == (4, 4, 3)
        assert got[0, 0, 0] == 2  # the NEWEST frame of the batch
        pump.decimate = 1
        assert pump._fetch(batch).shape == (8, 8, 3)
    finally:
        pump.close()


def test_pump_duty_cycle_close_is_fast(monkeypatch):
    """A pump idling in its duty-cycle window must close immediately."""
    monkeypatch.setenv("SHADERFLOW_DISPLAY_DUTY", "0.01")  # long idles
    log = []
    pump = DisplayPump()
    try:
        pump.offer(_SlowFrames(1, 0.05, log))  # 50 ms transfer -> ~5 s idle
        deadline = time.time() + 5.0
        while not log and time.time() < deadline:
            time.sleep(0.005)
        assert log  # transfer completed, worker now in its idle window
        t0 = time.perf_counter()
        pump.close()
        assert time.perf_counter() - t0 < 2.0
    finally:
        pump.close()


def test_rt_micro_batch_controller(monkeypatch):
    """The auto controller doubles after sustained over-budget frames,
    halves after sustained idle ones, and a forced env size wins."""
    monkeypatch.delenv("SHADERFLOW_RT_BATCH", raising=False)
    from shaderflow_tpu.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Headless)
    scene.fps = 60.0
    assert scene._rt_batch_size(auto_ok=True) == 1
    # 30 ms/frame against a 16.7 ms budget: doubles after 3 streak ticks
    # (EMA needs a couple of ticks to cross the 1.05x threshold)
    for _ in range(8):
        n = scene._rt_batch_size(auto_ok=True)
        scene._rt_batch_feedback(0.030 * n, n)
    assert scene._rt_batch_size(auto_ok=True) >= 2
    # Fast frames walk it back down to 1
    for _ in range(40):
        n = scene._rt_batch_size(auto_ok=True)
        scene._rt_batch_feedback(0.001 * n, n)
    assert scene._rt_batch_size(auto_ok=True) == 1
    # auto never batches on paths that can't display asynchronously
    scene._rt_batch_n = 4
    assert scene._rt_batch_size(auto_ok=False) == 1
    monkeypatch.setenv("SHADERFLOW_RT_BATCH", "3")
    assert scene._rt_batch_size(auto_ok=False) == 3
    scene._rt_batch_feedback(1.0, 3)  # forced: feedback is a no-op
    assert scene._rt_batch_size(auto_ok=True) == 3


def test_realtime_forced_micro_batch_frame_count(monkeypatch):
    """SHADERFLOW_RT_BATCH=2 renders 2 frames per launch through the real
    windowed loop (the engine traces a batch=2 program) and the loop still
    terminates on frame_limit. (The frame counter is time-derived, so the
    exact count depends on wall dt — only the floor is asserted.)"""
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SHADERFLOW_PREVIEW", "sdl")
    monkeypatch.setenv("SHADERFLOW_RT_BATCH", "2")
    from shaderflow_tpu.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Preview)
    scene.frame_limit = 7
    pygame.display.init()
    scene.initialize()  # idempotent; main() would do the same
    calls = []
    orig = scene.engine.flush
    scene.engine.flush = lambda *a, **k: (calls.append(a), orig(*a, **k))[1]
    scene.main(width=32, height=16, fps=60)
    assert scene.frame >= 7
    assert calls and all(a[0] in (1, 2) for a in calls)
    assert any(a[0] == 2 for a in calls)  # micro-batched launches happened
    # The launch task paced at fps/2 (one launch covers two frame periods)
    assert scene.vsync.frequency == pytest.approx(30.0)


def test_rt_micro_batch_predictive_jump(monkeypatch):
    """A big budget miss jumps the auto size in ONE step (each size change
    compiles a new engine program — stepping through every power of two
    pays seconds of compile per step)."""
    monkeypatch.delenv("SHADERFLOW_RT_BATCH", raising=False)
    from shaderflow_tpu.scene import ShaderScene, WindowBackend

    scene = ShaderScene(backend=WindowBackend.Headless)
    scene.fps = 60.0
    # A fixed ~67 ms per-launch dispatch cost (4x the 16.7 ms budget):
    # the controller should go straight to 8, not visit 2 and 4
    sizes = []
    for _ in range(8):
        n = scene._rt_batch_size(auto_ok=True)
        sizes.append(n)
        scene._rt_batch_feedback(0.067, n)
    assert scene._rt_batch_size(auto_ok=True) == 8
    assert 2 not in sizes and 4 not in sizes
