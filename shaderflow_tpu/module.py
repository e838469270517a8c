"""
ShaderModule — the lifecycle trait everything in a scene implements.

Same object model as the reference module system
(/root/reference/shaderflow/module.py): a module registers itself into its
scene on construction, exposes build/setup/update/pipeline/handle/ffhook/
duration/destroy hooks, can relay() messages to every module, and
full_pipeline() concatenates every module's uniforms. The scene itself is a
module (the first one).

Differences driven by the batched engine:
  * pipeline() values are batched per frame and fed to jitted programs, so
    uniforms are numpy-coercible values, not GL handles.
  * Modules that stream per-frame texture data declare it by writing through
    ShaderTexture.write() during update(); the engine snapshots dirty
    textures into the frame batch.
"""

from __future__ import annotations

import itertools
import weakref
from typing import TYPE_CHECKING, Any, Iterable, Optional

from shaderflow_tpu import logger
from shaderflow_tpu.variable import ShaderVariable

if TYPE_CHECKING:
    from shaderflow_tpu.io.ffmpeg import FFmpeg
    from shaderflow_tpu.scene import ShaderScene

_uuid_counter = itertools.count(1)


class ShaderModule:

    scene: "ShaderScene"
    name: Optional[str] = None

    def __init__(self, scene: Optional["ShaderScene"] = None, name: Optional[str] = None, **kwargs):
        from shaderflow_tpu.scene import ShaderScene  # circular at import time

        self.uuid: int = next(_uuid_counter)
        if name is not None:
            self.name = name

        # The first module constructed is the scene itself
        target = scene if scene is not None else self
        if not isinstance(target, weakref.ProxyTypes):
            self.scene = weakref.proxy(target)
        else:
            self.scene = target

        if not isinstance(self.scene, ShaderScene):
            raise RuntimeError(
                f"Module of type {type(self).__name__!r} must be constructed with "
                f"{type(self).__name__}(scene=<ShaderScene instance>, ...)")

        for key, value in kwargs.items():
            setattr(self, key, value)

        self.scene.modules.append(self)
        self.commands()

        if not isinstance(self, ShaderScene):
            self.build()

    # -- lifecycle hooks ----------------------------------------------------

    def build(self) -> None:
        """Called once when the module is added to a scene."""

    def setup(self) -> None:
        """Called before every run of the main event loop (and on scene reset)."""

    def update(self) -> None:
        """Called once per frame on the host, before the batch renders."""

    def prewarm(self) -> None:
        """Export-time precompute hook: modules overriding this are called
        CONCURRENTLY (worker threads, one per module) before the export
        loop's first frame, so expensive device precomputes/compiles overlap
        instead of serializing inside the first update(). Must be idempotent
        and touch only this module's own state; update() re-checks and
        reuses the cached result."""

    def pipeline(self) -> Iterable[ShaderVariable]:
        """Yield this module's uniforms for the current frame."""
        return []

    def handle(self, message: Any) -> None:
        """React to a relayed message."""

    def ffhook(self, ffmpeg: "FFmpeg") -> None:
        """Mutate the export FFmpeg command (e.g. add an audio input)."""

    def commands(self) -> None:
        """Register CLI commands on the scene launcher (reference
        module.py:108-111): override and call self.register_command(fn)."""

    def register_command(self, fn, name: Optional[str] = None) -> None:
        """Expose `fn` as `<Scene> <command>` on the CLI (cli.py dispatches
        non-'main' commands here). Keyword parameters become flags."""
        command = (name or fn.__name__).replace("_", "-")
        self.scene._commands[command] = fn

    def destroy(self) -> None:
        """Release resources; called when the scene is destroyed."""

    @property
    def duration(self) -> float:
        """Self-reported content duration (scene runtime = max over modules)."""
        return 0.0

    # -- scene-wide operations ----------------------------------------------

    def uniform(self, type: str, name: str, value: Any) -> ShaderVariable:
        """Cached Uniform for pipeline() hot paths: one object per
        (module, name), mutated in place each frame. The capture loop reads
        .value immediately per yield, so mutation is safe — and ~100 object
        constructions per frame vanish from the host hot loop. Falls back to
        a fresh object when the declared type changes."""
        from shaderflow_tpu.variable import Uniform
        cache = self.__dict__.setdefault("_uniform_objects", {})
        variable = cache.get(name)
        if variable is None or variable.type != type:
            variable = Uniform(type, name, value)
            cache[name] = variable
        else:
            variable.value = value
        return variable

    def full_pipeline(self) -> Iterable[ShaderVariable]:
        for module in self.scene.modules:
            yield from module.pipeline()

    def relay(self, message: Any) -> "ShaderModule":
        if isinstance(message, type):
            message = message()
        for module in self.scene.modules:
            module.handle(message)
        return self

    def find(self, kind: type) -> Iterable["ShaderModule"]:
        for module in self.scene.modules:
            if isinstance(module, kind):
                yield module

    # -- logging ------------------------------------------------------------

    @property
    def who(self) -> str:
        return f"(Module {self.uuid:>2} • {type(self).__name__[:14]:<14})"

    def log_info(self, *args) -> str:
        return logger.info(self.who, *args)

    def log_warn(self, *args) -> str:
        return logger.warn(self.who, *args)

    def log_error(self, *args) -> str:
        return logger.error(self.who, *args)

    def log_debug(self, *args) -> str:
        return logger.debug(self.who, *args)

    def log_minor(self, *args) -> str:
        return logger.minor(self.who, *args)

    # -- optional UI hook (realtime preview) ---------------------------------

    def ui(self) -> Iterable[str]:
        """Yield panel lines for this module's interactive debug panel
        (realtime preview, TAB toggles the HUD, [ and ] cycle modules) —
        the headless equivalent of the reference's per-module imgui __ui__
        panels (reference scene.py:856-932, module.py:156-166)."""
        return []

    def ui_fields(self) -> list["UIField"]:
        """Editable HUD fields for this module's panel — the interactive
        half of the reference's imgui sliders (reference module.py:156-166,
        e.g. DynamicNumber's f/zeta/r drag-floats). With this module's
        panel selected ([ / ]), ',' / '.' select a field and '-' / '+'
        nudge it by `step` (Shift: x10, Ctrl: x0.1)."""
        return []

    def ui_plots(self) -> list["UIPlot"]:
        """Sparkline series for this module's panel — the imgui PlotLines
        half of the reference's __ui__ widgets (its frametimer/dynamics
        panels plot histories the same way). Rendered as rasterized line
        plots under the panel's fields when the module is selected."""
        return []


class UIField:
    """One editable scalar on a module's HUD panel."""

    def __init__(self, label: str, get, set, step: float = 0.1,
                 minimum: float = None, maximum: float = None,
                 fmt: str = "{:+.3f}"):
        self.label = label
        self.get = get
        self.set = set
        self.step = float(step)
        self.minimum = minimum
        self.maximum = maximum
        self.fmt = fmt

    def nudge(self, direction: float, scale: float = 1.0) -> float:
        value = float(self.get()) + direction * self.step * scale
        if self.minimum is not None:
            value = max(self.minimum, value)
        if self.maximum is not None:
            value = min(self.maximum, value)
        self.set(value)
        return value

    def render(self) -> str:
        return f"{self.label} " + self.fmt.format(float(self.get()))


class UIPlot:
    """One sparkline on a module's HUD panel (imgui PlotLines equivalent).

    `values` is any 1D sequence sampled oldest -> newest; `lo`/`hi` pin the
    y-range (None = auto from the current window)."""

    def __init__(self, label: str, values, lo: float = None, hi: float = None):
        self.label = label
        self.values = values
        self.lo = lo
        self.hi = hi
