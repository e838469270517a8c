"""
ShaderProgram — pixel programs compiled by XLA instead of a GL driver.

Role-equivalent of the reference shader module
(/root/reference/shaderflow/shader.py), redesigned for the batched JAX
execution model: a "fragment shader" is a pure Python function `main(sf) -> rgba`
operating on whole (H, W) coordinate arrays through the `Frag` context —
the same vocabulary the reference's GLSL metaprogrammer injects (coordinate
flavors, uniforms, samplers, camera) — and the engine traces it into the
scene's single jitted frame-batch program (scene.py). What the reference
does with GLSL source assembly + driver compilation (shader.py:190-239,324)
becomes function composition + jax tracing; hot reload swaps the function
and re-jits (shader.py:243-262); compile errors fall back to the animated
"missing texture" program (shader.py:325-340) after dumping a report.

A program owns a ShaderTexture (temporal x layers) it renders into; layer L
can sample layers < L written this frame, programs can sample their own
previous frames, and the temporal ring rolls after each program's render —
bit-matching the reference's GL binding/rotation order.
"""

from __future__ import annotations

import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Union

import jax.numpy as jnp
import numpy as np

import shaderflow_tpu
from shaderflow_tpu import logger
from shaderflow_tpu import ops
from shaderflow_tpu.message import ShaderMessage
from shaderflow_tpu.module import ShaderModule
from shaderflow_tpu.ops import cameralib
from shaderflow_tpu.ops.sampling import Sampler2D
from shaderflow_tpu.texture import ShaderTexture

PixelFunction = Callable[["Frag"], Any]


# --------------------------------------------------------------------------- #
# Frag: everything a pixel program sees

class Frag:
    """The per-draw context handed to pixel programs.

    Mirrors the variables the reference vertex shader + metaprogrammer give
    every fragment shader (vertex/default.glsl:4-16 and the injected uniform
    declarations): coordinate flavors as (H, W, 2) arrays, every pipeline
    uniform by name, every texture as a named sampler, and the camera.
    """

    def __init__(
        self,
        coords: dict[str, Any],
        uniforms: dict[str, Any],
        statics: dict[str, Any],
        textures: dict[str, Any],     # name -> (T, L, H, W, C) array
        texture_meta: dict[str, Any],  # name -> ShaderTexture (sampling state)
        layer: int = 0,
        instance: int = 0,
        preludes: dict[str, Any] = None,  # name -> this frame's prelude slice
        prelude_stacks: dict[str, Any] = None,  # name -> full (B, ...) array
        prelude_step: Any = None,               # this frame's batch position
    ):
        self._coords = coords
        self._uniforms = uniforms
        self._statics = statics
        self._textures = textures
        self._texture_meta = texture_meta
        self._preludes = preludes or {}
        self._prelude_stacks = prelude_stacks or {}
        self._prelude_step = prelude_step
        self.layer = layer
        self.instance = instance
        self._discard = None  # (H, W) bool mask set via discard()
        self._camera_cache: dict[str, cameralib.CameraRays] = {}

    def discard(self, mask) -> None:
        """GLSL `discard` equivalent: pixels where `mask` is true keep the
        underlying framebuffer content instead of this draw's output (used
        with instanced rendering so earlier instances show through).
        Multiple calls OR together."""
        mask = jnp.asarray(mask)
        self._discard = mask if self._discard is None else (self._discard | mask)

    # -- coordinates --------------------------------------------------------

    @property
    def astuv(self): return self._coords["astuv"]
    @property
    def agluv(self): return self._coords["agluv"]
    @property
    def stuv(self): return self._coords["stuv"]
    @property
    def gluv(self): return self._coords["gluv"]
    @property
    def stxy(self): return self._coords["stxy"]
    @property
    def glxy(self): return self._coords["glxy"]
    @property
    def fragcoord(self): return self._coords["stxy"]

    @property
    def resolution(self):
        return self._uniforms["iResolution"]

    @property
    def aspect_ratio(self):
        """iAspectRatio: iResolution.x / iResolution.y (shaderflow.glsl:16)."""
        res = self._uniforms["iResolution"]
        return res[..., 0] / res[..., 1]

    # -- uniforms -----------------------------------------------------------

    def uniform(self, name: str, default=None):
        if name in self._uniforms:
            return self._uniforms[name]
        if name in self._statics:
            return self._statics[name]
        if default is not None:
            return default
        raise KeyError(f"Unknown uniform {name!r}; known: {sorted(self._uniforms)}")

    def __getattr__(self, name: str):
        # Fallback attribute access: uniforms then textures (iTime, iAudioVolume, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._uniforms:
            return self._uniforms[name]
        if name in self._statics:
            return self._statics[name]
        if name in self._textures:
            return self.tex(name)
        raise AttributeError(f"Frag has no uniform/texture {name!r}")

    # -- textures -----------------------------------------------------------

    def tex(self, name: str, temporal: int = 0, layer: int = -1) -> Sampler2D:
        """Sampler for one texture box. tex('iScreen') is the newest box
        (<name><T>x<L> naming parity: texture.py:354-368)."""
        if name not in self._textures:
            raise KeyError(f"Unknown texture {name!r}; known: {sorted(self._textures)}")
        array = self._textures[name]
        meta = self._texture_meta[name]
        sampler = Sampler2D(
            array[temporal, layer],
            linear=meta.linear,
            repeat_x=meta.repeat_x,
            repeat_y=meta.repeat_y,
        )
        if getattr(meta, "mipmaps", False):
            # Honors texture(mipmaps=True): pyramid built in-jit (XLA hoists
            # it out of the frame scan for batch-invariant textures); every
            # accessor then samples trilinearly with derivative-driven LOD,
            # anisotropically when the texture asks for it (ops/sampling.py
            # MipSampler / sample_mip_aniso). Reference delegates the same
            # duty to the GL driver (texture.py:82-137).
            # Anisotropy only on explicit request (texture.py: software
            # aniso costs taps x levels samples; GL's default x16 is free
            # sampler state — see ShaderTexture._aniso_explicit)
            aniso = (getattr(meta, "anisotropy", 1)
                     if getattr(meta, "_aniso_explicit", False) else 1)
            return ops.mip_pyramid(sampler, anisotropy=aniso)
        return sampler

    def texture(self, sampler, uv):
        """GLSL texture(): accepts a Sampler2D or a texture name."""
        if isinstance(sampler, str):
            sampler = self.tex(sampler)
        return ops.sample(sampler, uv)

    def texel_fetch(self, sampler, xy):
        if isinstance(sampler, str):
            sampler = self.tex(sampler)
        return ops.texel_fetch(sampler, xy)

    def _sampler(self, tex) -> Sampler2D:
        return self.tex(tex) if isinstance(tex, str) else tex

    def astexture(self, tex, astuv):
        return ops.astexture(self._sampler(tex), astuv)

    def stexture(self, tex, stuv):
        return ops.stexture(self._sampler(tex), stuv)

    def gtexture(self, tex, gluv, mirror: bool = False):
        return ops.gtexture(self._sampler(tex), gluv, mirror)

    def agtexture(self, tex, agluv, mirror: bool = False):
        return ops.agtexture(self._sampler(tex), agluv, self.uniform("iWantAspect"), mirror)

    # -- batch preludes -------------------------------------------------------

    def prelude(self, name: str):
        """This frame's slice of a batch-level prelude (engine.py): a value
        the scene precomputed for the WHOLE batch outside the render scan
        (scene.batch_preludes[name]); None when the prelude is inactive
        (realtime/streamed mode, CPU fallback) — callers branch to their
        per-frame formulation."""
        return self._preludes.get(name)

    def has_prelude(self, name: str) -> bool:
        return name in self._preludes

    def prelude_indexed(self, name: str):
        """The FULL (B, ...) prelude stack plus this frame's batch position
        — for feeding ops.tailfuse.Indexed, which selects the frame's
        plane inside the tail stage. None when the prelude is inactive."""
        stack = self._prelude_stacks.get(name)
        if stack is None or self._prelude_step is None:
            return None
        return stack, self._prelude_step

    # -- fused tail stage -----------------------------------------------------

    def tail(self, fn, **inputs):
        """Defer the remaining per-pixel math to the tail stage
        (ops/tailfuse.py): `fn(tp)` runs in the PLANE dialect together
        with the SSAA downsample + u8 quantize when this is the scene's
        main program (as one kernel on the GPU in the exact-pooling
        regime).
        Only valid as the RETURN value of a pixel program."""
        from shaderflow_tpu.ops import tailfuse
        height, width = self._coords["astuv"].shape[:2]
        return tailfuse.make_spec(fn, height, width, **inputs)

    # -- camera -------------------------------------------------------------

    def get_camera(self, name: str = "iCamera") -> cameralib.CameraRays:
        """GetCamera(name) equivalent (camera.glsl:132-155): wire the camera
        module's uniforms into per-pixel ray generation."""
        if name in self._camera_cache:
            return self._camera_cache[name]
        u, s = self._uniforms, self._statics

        if s.get(f"{name}Trivial") and "u_line" in self._coords:
            aspect = self._coords["aspect"]
            rays = cameralib.project_trivial(
                gluv_x=(self._coords["u_line"] * 2.0 - 1.0) * aspect,
                gluv_y=self._coords["v_line"] * 2.0 - 1.0,
                position=u[f"{name}Position"],
                zoom=u[f"{name}Zoom"],
                isometric=u[f"{name}Isometric"],
                orbital=u[f"{name}Orbital"],
                dolly=u[f"{name}Dolly"],
                focal_length=u[f"{name}FocalLength"],
                aspect=self.aspect_ratio,
                want_aspect=u["iWantAspect"],
                resolution=u["iResolution"],
            )
            self._camera_cache[name] = rays
            return rays

        rays = cameralib.project(
            gluv=self.gluv,
            agluv=self.agluv,
            mode=int(s.get(f"{name}Mode", cameralib.MODE_2D)),
            projection=int(s.get(f"{name}Projection", cameralib.PROJECTION_PERSPECTIVE)),
            position=u[f"{name}Position"],
            right=u[f"{name}Right"],
            up=u[f"{name}Upward"],
            forward=u[f"{name}Forward"],
            zoom=u[f"{name}Zoom"],
            isometric=u[f"{name}Isometric"],
            orbital=u[f"{name}Orbital"],
            dolly=u[f"{name}Dolly"],
            focal_length=u[f"{name}FocalLength"],
            separation=u[f"{name}Separation"],
            aspect=self.aspect_ratio,
            want_aspect=u["iWantAspect"],
            resolution=u["iResolution"],
        )
        self._camera_cache[name] = rays
        return rays

    @property
    def camera(self) -> cameralib.CameraRays:
        return self.get_camera()


def make_coords(render_height: int, render_width: int, aspect: float) -> dict[str, jnp.ndarray]:
    """Pixel-center coordinate grids over the render resolution, matching the
    interpolated vertex outputs (vertex/default.glsl:8-16). Row 0 = top."""
    x = (jnp.arange(render_width, dtype=jnp.float32) + 0.5) / render_width
    y = 1.0 - (jnp.arange(render_height, dtype=jnp.float32) + 0.5) / render_height
    astuv = jnp.stack(jnp.meshgrid(x, y, indexing="xy"), axis=-1)
    agluv = astuv * 2.0 - 1.0
    gluv = agluv * jnp.array([aspect, 1.0], jnp.float32)
    stuv = (gluv + 1.0) / 2.0
    # 1D axis lines (astuv space) power separable fast paths (camera, sampling)
    return dict(astuv=astuv, agluv=agluv, stuv=stuv, gluv=gluv,
                u_line=x, v_line=y, aspect=aspect)


def finish_coords(coords: dict, resolution) -> dict:
    """Add the pixel-space coordinates that depend on the iResolution uniform
    (stxy has the reference's +1 offset, vertex/default.glsl:14)."""
    resolution = jnp.asarray(resolution, jnp.float32)
    coords = dict(coords)
    coords["stxy"] = resolution * coords["astuv"] + 1.0
    coords["glxy"] = coords["stxy"] - resolution / 2.0
    return coords


# --------------------------------------------------------------------------- #
# Builtin fragment programs

def default_fragment(sf: Frag):
    """The welcome shader: neon hsv ring over a checkerboard with vignette —
    functional port of fragment/default.glsl."""
    cam = sf.camera
    uv = cam.gluv
    angle = ops.atan2(uv)
    color = 0.3 + ops.hsv2rgb(ops.vec3(angle + (2 * ops.TAU * sf.iTau) - (ops.PI / 4), 1.0, 1.0))
    circle = 1.333 * ops.length(uv) - 1.0
    width = 2.0 * jnp.abs(1.0 / (circle * circle)) * 1e-4

    grid = jnp.where(
        (jnp.mod(jnp.floor(uv[..., 0] * 4.0) + jnp.floor(uv[..., 1] * 4.0), 2.0) > 0.5),
        0.22, 0.20)[..., None]
    base = jnp.where(circle[..., None] < 0.0, 0.18, grid)
    rgb = base + width[..., None] * color

    away = cam.astuv * (1.0 - cam.astuv[..., ::-1])
    linear = 50.0 * (away[..., 0] * away[..., 1])
    rgb = rgb * jnp.clip(jnp.power(jnp.maximum(linear, 0.0), 0.1), 0.0, 1.0)[..., None]

    rgb = jnp.where(cam.out_of_bounds[..., None], 0.15, rgb)
    return ops.vec4(rgb, 1.0)


def missing_fragment(sf: Frag):
    """Magenta checkerboard fallback shown when a program fails to build
    (fragment/missing.glsl)."""
    uv = sf.stuv + sf.iTime / 64.0
    block = jnp.floor(8.0 * uv)
    on = jnp.mod(block[..., 0] + block[..., 1], 2.0) == 0.0
    rgb = jnp.where(on[..., None], jnp.array([1.0, 0.0, 1.0], jnp.float32) * (100.0 / 25.0), 0.0)
    return ops.vec4(rgb, 0.2)


# --------------------------------------------------------------------------- #

def _is_pathlike(value) -> bool:
    if isinstance(value, Path):
        return True
    if isinstance(value, str) and "\n" not in value and len(value) < 4096:
        try:
            return Path(value).exists()
        except OSError:
            return False
    return False


class ShaderProgram(ShaderModule):
    """A pixel program + the texture matrix it renders into."""

    instances: int = 1
    clear: bool = True

    def __init__(self, scene=None, name: Optional[str] = None, **kwargs):
        self._fragment: Union[PixelFunction, str, Path, None] = None
        self._resolved: Optional[PixelFunction] = None
        self._compiled_src: Optional[tuple] = None  # (origin, source) memo
        self._watch_path: Optional[Path] = None
        self._watch_mtime: float = 0.0
        self.texture: Optional[ShaderTexture] = None
        super().__init__(scene=scene, name=name, **kwargs)

    def build(self) -> None:
        self.texture = ShaderTexture(scene=self.scene, name=self.name, track=1.0)
        self._fragment = default_fragment
        self._resolved = default_fragment

    # -- fragment source handling -------------------------------------------

    @property
    def fragment(self) -> Optional[PixelFunction]:
        return self._resolved

    @fragment.setter
    def fragment(self, value: Union[PixelFunction, str, Path]) -> None:
        self._fragment = value
        self._watch_path = None
        if _is_pathlike(value):
            self._watch_path = Path(value)
            self._watch_mtime = self._watch_path.stat().st_mtime
        self.compile()

    @staticmethod
    def _load_source(source: str, origin: str) -> PixelFunction:
        """Resolve shader source text into a pixel function.

        Two authoring formats (reference shader.py:186-239 assembles GLSL;
        this repo's native format is python pixel functions): GLSL sources
        (`void main()`, typically `.frag`/`.glsl` files — the reference's
        authoring format, runnable as-is) compile through the glsl front-end;
        python sources (`def main(sf)`) are exec'd."""
        from shaderflow_tpu import glsl
        if glsl.looks_like_glsl(source):
            return glsl.compile_fragment(source, origin)
        namespace: dict[str, Any] = {}
        exec(compile(source, origin, "exec"), namespace)
        main = namespace.get("main")
        if not callable(main):
            raise ValueError(f"Shader source {origin!r} does not define main(sf)")
        return main

    def compile(self) -> "ShaderProgram":
        """Resolve the fragment into a callable; on failure dump a report and
        fall back to the missing-texture program (never crash a session)."""
        value = self._fragment
        try:
            if value is None:
                self._resolved = default_fragment
                self._compiled_src = None
            elif callable(value):
                self._resolved = value
                self._compiled_src = None
            elif _is_pathlike(value):
                path = Path(value)
                source = path.read_text()
                # Unchanged source: keep the resolved callable. Compile
                # relays fire on every run setup, and re-parsing would mint
                # a NEW function object — the engine's build key hashes
                # fragment identity, so a fresh parse of identical GLSL/
                # python source forced a full retrace per export run
                # (measured: the whole timed GLSL bench pass was one 31 s
                # recompile). Hot reload still works: an edited file has
                # different source text.
                if self._compiled_src == (str(path), source):
                    return self
                self._resolved = self._load_source(source, str(path))
                self._compiled_src = (str(path), source)
            elif isinstance(value, str):
                if self._compiled_src == (self.name, value):
                    return self
                self._resolved = self._load_source(value, f"<{self.name}-fragment>")
                self._compiled_src = (self.name, value)
            else:
                raise TypeError(f"Unsupported fragment source: {type(value)}")
        except Exception as error:
            self.dump_error(error)
            self._resolved = missing_fragment
            self._compiled_src = None
        # The scene's batched render program must be rebuilt around the new fn
        self.scene.invalidate_engine()
        return self

    def dump_error(self, error: Exception) -> None:
        """ShaderDumper equivalent (reference shader.py:38-96): persist the
        faulty source + traceback to the user log dir, log loudly."""
        directory = shaderflow_tpu.directories.ensure().user_log_path
        report = directory / f"{self.uuid}-error.md"
        source = self._fragment if isinstance(self._fragment, str) else str(self._fragment)
        report.write_text(
            f"# Shader build error (module {self.uuid}, {self.name})\n\n"
            f"```\n{traceback.format_exc()}\n```\n\n## Source\n\n```python\n{source}\n```\n")
        logger.error(f"Error building shader {self.name}: {error}; "
                     f"falling back to missing-texture shader (report: {report})")

    def poll_hot_reload(self) -> bool:
        """File-watch without a watchdog dependency: compare mtimes (called
        from the realtime loop; export/freewheel never reloads, matching
        shader.py:249-251)."""
        if self._watch_path is None:
            return False
        try:
            mtime = self._watch_path.stat().st_mtime
        except OSError:
            return False
        if mtime != self._watch_mtime:
            self._watch_mtime = mtime
            self.scene.scheduler.once(self.compile)
            return True
        return False

    # -- module hooks -------------------------------------------------------

    def handle(self, message) -> None:
        if isinstance(message, ShaderMessage.Shader.Compile):
            self.compile()

    def ui(self):
        tex = self.texture
        yield (f"{tex.resolution[0]}x{tex.resolution[1]}  "
               f"layers {tex.layers}  temporal {tex.temporal}")
        if self._watch_path is not None:
            yield f"watching {self._watch_path.name}"

    def render_layer(self, ctx: Frag):
        """Trace one layer of this program: returns (H, W, C) in sample space.

        Instancing (reference shader.py:106 + vertex/default.glsl:5): the
        pixel program runs `instances` times with ctx.instance = 0..N-1,
        drawn in order over a cleared framebuffer with GL's no-blending
        rule — the last instance to write a pixel wins; sf.discard(mask)
        lets an instance leave pixels to the instances below (instance 0
        shows the clear color, zeros, where it discards)."""
        from shaderflow_tpu.ops.tailfuse import TailSpec
        result = None
        for instance in range(self.instances):
            ctx.instance = instance
            ctx._discard = None
            out = self._resolved(ctx)
            if isinstance(out, TailSpec):
                if self.instances == 1:
                    # The engine decides whether to feed it to the final
                    # pass (main program) or materialize it (anything else
                    # samples this texture)
                    return out
                # Instanced draws need the materialized layer for compositing
                from shaderflow_tpu.ops import tailfuse
                height, width = ctx._coords["astuv"].shape[:2]
                out = tailfuse.eval_reference(
                    out, height, width, ctx._coords["aspect"])
            out = jnp.asarray(out, jnp.float32)
            components = self.texture.components
            if out.shape[-1] < components:
                pad = jnp.ones(out.shape[:-1] + (components - out.shape[-1],), jnp.float32)
                out = jnp.concatenate([out, pad], axis=-1)
            out = out[..., :components]
            if ctx._discard is not None:
                below = jnp.zeros_like(out) if result is None else result
                out = jnp.where(ctx._discard[..., None], below, out)
            result = out
        return result
