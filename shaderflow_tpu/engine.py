"""
The batched render engine: whole scene -> one jitted XLA program per frame batch.

This replaces the reference's per-frame GL machinery (uniform re-uploads,
per-layer draw calls, FBO readbacks — shader.py:377-405, scene.py:456-479)
with the batched execution model from SURVEY.md §7:

  * The host advances module state frame by frame (cheap numpy) and captures
    each frame's uniform pytree + any texture written that frame.
  * F frames are rendered per device launch by a lax.scan whose carry is the
    set of program texture matrices (T, L, H, W, C) — temporal feedback
    (motion blur, Life) is the scan carry, the roll is a jnp.roll.
  * Within one frame, programs render in reverse module order; a program
    writes its layers progressively into temporal slot 0 (later layers and
    later programs see them — GL live-texture binding semantics), then its
    ring rolls (deque.rotate(+1) equivalence: slot 1 = newest after roll).
  * The final SSAA box downsample + uint8 quantization is fused into the
    same program (ops/downsample.py), so a frame leaves the device exactly
    once, as (F, H, W, 3) uint8.
"""

from __future__ import annotations

import os
import time
from typing import TYPE_CHECKING, Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

SKIP_TPU = os.environ.get("SKIP_TPU") == "1"
"""Do not run device programs; frames come back black. The reference's
SKIP_GPU kill-switch (shader.py:364-370) for benchmarking pure host-loop
overhead (module updates, uniform capture, piping) in isolation."""

# Persistent compilation cache: scene programs are large (a whole frame
# pipeline per trace), so a cold compile takes seconds; cache hits let a
# later process skip it. JAX_COMPILATION_CACHE_DIR wins when set, else the
# cache lives in the checkout's own (gitignored) .jax_cache.
if not os.environ.get("SHADERFLOW_NO_COMPILE_CACHE"):
    from pathlib import Path as _Path
    _cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", _cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from shaderflow_tpu import logger
from shaderflow_tpu.ops import tailfuse


# Reserved static-texture key prefix carrying precomputed batch-invariant
# prelude fields into the render program ("\0" cannot appear in user texture
# names, which come from Python identifiers / CLI args)
_PRELUDE_KEY = "\0prelude:"


class PreludeCtx:
    """Trace-time context handed to scene.batch_preludes functions.

    A prelude runs INSIDE the jitted render program but OUTSIDE the per-frame
    scan — once per batch, over all frames at once. It is the place for work
    whose per-frame part is tiny but whose per-pixel indexing is
    frame-invariant (e.g. expanding a per-frame lookup table over a static
    radial index field as one batched gather instead of per-frame lookups
    inside the scan). The returned array's leading axis must
    be the batch axis; the scan hands each frame its slice via
    Frag.prelude(name). Return None to deactivate (frames fall back to their
    per-frame formulation)."""

    def __init__(self, frames, sequences, render_size, aspect):
        self.frames = frames          # (B,) i32 stepped frame indices
        self.sequences = sequences    # name -> full (F_pad, ...) device array
        self.render_size = render_size  # (H, W) of the main program
        self.aspect = aspect

    def sequence(self, name: str):
        return self.sequences.get(name)

    def rows(self, name: str):
        """Per-frame rows of a device sequence: seq[clip(frames)] -> (B, ...)."""
        seq = self.sequences.get(name)
        if seq is None:
            return None
        idx = jnp.clip(self.frames, 0, seq.shape[0] - 1)
        return seq[idx]
from shaderflow_tpu.ops.downsample import final_pass
from shaderflow_tpu.ops.tailfuse import TailSpec
from shaderflow_tpu.shader import Frag, ShaderProgram, finish_coords, make_coords
from shaderflow_tpu.texture import ShaderTexture

if TYPE_CHECKING:
    from shaderflow_tpu.scene import ShaderScene


# Wire format for device->host frame delivery: the export loop flattens
# each (F, H, W, 3) u8 batch to (F, H*W*3) on device, ships the flat
# array, and the host reshapes the fetched buffer back to (F, H, W, 3) for
# free (C-contiguous view). Role-equivalent of the
# reference's raw fbo.read() bytes (/root/reference/shaderflow/scene.py:622-639),
# which are likewise unpadded rgb24 on the wire.
_wire_flatten = jax.jit(lambda x: x.reshape(x.shape[0], -1))


class WireBatch:
    """A frame batch staged for host delivery: flat (F, H*W*3) u8 on
    device + the logical (F, H, W, 3) shape to restore after fetch."""

    __slots__ = ("flat", "logical_shape")

    def __init__(self, flat, logical_shape):
        self.flat = flat
        self.logical_shape = tuple(logical_shape)

    @property
    def shape(self):
        return self.logical_shape

    def copy_to_host_async(self):
        self.flat.copy_to_host_async()

    def fetch(self) -> np.ndarray:
        return np.asarray(self.flat).reshape(self.logical_shape)


def to_wire(frames) -> WireBatch:
    """Stage a (F, H, W, 3) u8 batch for host delivery (see WireBatch)."""
    if isinstance(frames, np.ndarray):  # SKIP_TPU path is already on host
        return WireBatch(frames.reshape(frames.shape[0], -1), frames.shape)
    return WireBatch(_wire_flatten(frames), frames.shape)


def fetch_frame(frame) -> np.ndarray:
    """Fetch one (H, W, 3) device frame through the unpadded wire layout
    (device-side flatten, then reshape the host buffer — see WireBatch)."""
    if isinstance(frame, np.ndarray):
        return frame
    try:
        shape = frame.shape
        return np.asarray(frame.reshape(-1)).reshape(shape)
    except Exception:  # non-jax input (test fakes): plain fetch
        return np.asarray(frame)


class RenderEngine:

    def __init__(self, scene: "ShaderScene"):
        self.scene = scene
        self.stale = True

        self._jitted = None
        self._render_fn = None  # unjitted closure (graft entry / sharding)
        self._build_key = None
        self._carry: dict[str, jax.Array] = {}
        self._static_tex: dict[str, jax.Array] = {}
        self._static_versions: dict[str, int] = {}
        self._sequences: dict[str, jax.Array] = {}
        self._sequence_windows: dict[str, int] = {}
        self._statics: dict[str, Any] = {}
        self._streamed_names: set[str] = set()
        self._stream_f32: set[str] = set()  # names pinned to f32 snapshots
        self._uniform_kinds: dict[str, str] = {}

        # Batch-invariant prelude cache bookkeeping (see _ensure_prelude_cache)
        self._prelude_fns: dict[str, Any] = {}
        self._prelude_probe_state: Optional[tuple] = None
        self._prelude_probe_memo: dict[tuple, dict[str, Any]] = {}
        self._main_size: tuple = (0, 0)
        self._aspect: float = 1.0

        # Per-batch capture state
        self._frame_uniforms: list[dict[str, np.ndarray]] = []
        self._frame_streams: dict[str, list[np.ndarray]] = {}

        # Optional multi-device frame sharding (parallel/mesh.py)
        self.mesh = None
        self._sharded_cache: dict = {}

        # Cold-start accounting (tools/coldstart.py): (batch, seconds) per
        # first-compile flush, and the last prelude-probe wall time
        self.compile_events: list[tuple[int, float]] = []
        self.probe_seconds: float = 0.0

    def invalidate(self) -> None:
        self.stale = True

    # ------------------------------------------------------------------ #
    # Inventory

    def _programs(self) -> list[ShaderProgram]:
        """Render order: reverse module-addition order, final excluded
        (scene.py:469-471 update sweep)."""
        programs = [m for m in self.scene.modules
                    if isinstance(m, ShaderProgram) and m is not self.scene._final]
        return programs[::-1]

    def _external_textures(self) -> dict[str, ShaderTexture]:
        """Named textures not owned by a program (images, audio, piano, video)."""
        owned = {p.texture for p in self._programs()} | {self.scene._final.texture}
        out = {}
        for module in self.scene.modules:
            if isinstance(module, ShaderTexture) and module.name and module not in owned:
                out[module.name] = module
        return out

    def _texture_meta(self) -> dict[str, ShaderTexture]:
        meta = dict(self._external_textures())
        for prog in self._programs():
            meta[prog.name] = prog.texture
        return meta

    # ------------------------------------------------------------------ #
    # Build

    def _compute_build_key(self) -> tuple:
        """Everything that specializes the compiled program. If unchanged, a
        rebuild reuses the existing jitted callable (no retrace)."""
        scene = self.scene
        programs = self._programs()
        statics = tuple(sorted(
            (v.name, v.value) for v in scene.full_pipeline()
            if v.static and v.value is not None))
        textures = tuple(
            (p.name, id(p.fragment), p.instances, p.texture.resolution,
             p.texture.temporal, p.texture.layers, p.texture.components,
             p.texture.filter, p.texture.repeat_x, p.texture.repeat_y)
            for p in programs)
        # Streamed/sequence membership and shapes are NOT in the key: they
        # are jit arguments, so the closure is generic over them — changing
        # them retraces through the jit cache without discarding previously
        # compiled signatures (a rebuilt closure would recompile everything).
        # Ring WINDOWS are structural (they change the traced indexing), so
        # they do participate.
        windows = tuple(sorted(
            (name, tex.sequence_window)
            for name, tex in self._external_textures().items()
            if tex.sequence is not None and tex.sequence_window))
        preludes = tuple(sorted(
            (name, id(fn))
            for name, fn in (getattr(scene, "batch_preludes", None) or {}).items()))
        return (textures, statics, scene._final.texture.resolution,
                int(scene.subsample), scene.aspect_ratio, windows, preludes)

    def build(self) -> None:
        key = self._compute_build_key()
        if key == self._build_key and self._jitted is not None:
            # Only data changed (e.g. a Compile relay with identical programs):
            # refresh device state, keep the compiled executable
            self._refresh_static_textures()
            for prog in self._programs():
                if prog.texture.temporal > 1 and prog.texture.matrix is not None:
                    self._carry[prog.name] = jax.numpy.asarray(prog.texture.matrix)
            self._ensure_prelude_cache()  # sequence PRESENCE may have changed
            self.stale = False
            return
        self._build_key = key

        scene = self.scene
        programs = self._programs()
        externals = self._external_textures()
        meta = self._texture_meta()

        # Static uniform values specialize the compiled program
        self._statics = {}
        for variable in scene.full_pipeline():
            if variable.static and variable.value is not None:
                self._statics[variable.name] = variable.value

        # Program texture matrices -> scan carry. Only temporal>1 programs
        # carry state between frames; temporal==1 programs are rebuilt from
        # scratch each frame (no cross-frame reads are possible through a
        # single-slot ring), which keeps their (H, W, C) buffers out of the
        # scan carry entirely — a large per-frame HBM traffic saving.
        self._carry = {}
        for prog in programs:
            if prog.texture.matrix is None:
                prog.texture.make()
            if prog.texture.temporal > 1:
                self._carry[prog.name] = jnp.asarray(prog.texture.matrix)

        # Device copies of external textures. Three classes:
        #   sequence — device-resident (F_total, H, W, C), indexed by iFrame
        #   streamed — host-written per frame, snapshotted into the batch
        #   static   — uploaded once, re-uploaded on version change
        self._static_tex = {}
        self._static_versions = {}
        self._sequences = {}
        self._sequence_windows = {}
        for name, tex in externals.items():
            if tex.sequence is not None:
                self._bind_sequence(name, tex)
                self._streamed_names.discard(name)
                tex.dirty = False
                continue
            if name in self._streamed_names:
                continue
            if tex.matrix is None:
                tex.make()
            self._static_tex[name] = jnp.asarray(tex.matrix)
            self._static_versions[name] = tex.version
            tex.dirty = False

        # Per-program render sizes; the coordinate grids themselves are
        # generated INSIDE the traced function (iota-based) — materializing
        # them here would bake ~100s of MB of constant arrays into the HLO
        # (minute-scale compiles, per-call constant rehydration)
        aspect = scene.aspect_ratio
        sizes = []
        for prog in programs:
            width, height = prog.texture.resolution
            sizes.append((height, width))

        out_width, out_height = scene._final.texture.resolution
        subsample = int(scene.subsample)
        main_name = scene.shader.name
        # After a program's temporal roll the just-rendered frame sits at
        # slot 1 (slot 0 recycles the oldest box); the final pass must read
        # the newest content, not the stale slot 0 the reference's naming
        # would suggest for temporal > 1. SHADERFLOW_REF_SLOT0=1 restores the
        # reference's literal behavior (displays the stale slot) for PSNR
        # parity checks on temporal-feedback scenes.
        main_slot = 1 if scene.shader.texture.temporal > 1 else 0
        if os.environ.get("SHADERFLOW_REF_SLOT0") == "1":
            main_slot = 0
        statics = dict(self._statics)
        program_list = list(programs)
        meta_snapshot = dict(meta)
        seq_windows = dict(self._sequence_windows)
        prelude_fns = dict(getattr(scene, "batch_preludes", None) or {})

        # BATCH-INVARIANT preludes: see _ensure_prelude_cache. The probe
        # state key covers everything the probe can observe (fn code set,
        # sequence signature, size, aspect), so an unchanged rebuild — e.g.
        # a repeat scene.main() — keeps the cached fields instead of paying
        # the full-resolution probe again.
        self._prelude_fns = prelude_fns
        self._main_size = sizes[-1]
        self._aspect = aspect
        self._ensure_prelude_cache()

        def unpack_uniforms(row, spec):
            """Split one packed f32 row back into named uniform values.
            `spec` is a static tuple of (name, offset, size, kind, shape);
            kinds: 'f' float, 'i' int (round-trips exactly below 2^24),
            'b' bool-as-int."""
            out = {}
            for name, offset, size, kind, shape in spec:
                value = row[offset:offset + size]
                value = value.reshape(shape) if shape else value[0]
                if kind in ("i", "b"):
                    value = jnp.round(value).astype(jnp.int32)
                out[name] = value
            return out

        def render_batch(carry, packed, streams, static_tex, sequences, spec):
            # Loop-invariant: XLA hoists these out of the scan
            coords = [make_coords(h, w, aspect) for (h, w) in sizes]

            # Batch preludes: whole-batch precompute outside the scan (see
            # PreludeCtx). Needs the stepped frame index column to gather
            # per-frame sequence rows. Batch-invariant preludes arrive
            # precomputed through static_tex (reserved names, see build).
            prelude_vals = {}
            static_prelude_vals = {
                name[len(_PRELUDE_KEY):]: value
                for name, value in static_tex.items()
                if name.startswith(_PRELUDE_KEY)}
            static_tex = {name: value for name, value in static_tex.items()
                          if not name.startswith(_PRELUDE_KEY)}
            if prelude_fns:
                frame_offset = next(
                    (offset for (name, offset, size, kind, shape) in spec
                     if name == "iFrameIndex"), None)
                if frame_offset is not None:
                    frame_indices = jnp.round(
                        packed[:, frame_offset]).astype(jnp.int32)
                    ctx = PreludeCtx(frame_indices, sequences,
                                     sizes[-1], aspect)
                    for name, fn in prelude_fns.items():
                        if name in static_prelude_vals:
                            continue
                        with jax.named_scope(f"prelude_{name}"):
                            value = fn(ctx)
                        if value is not None:
                            if value.shape[0] == 1:
                                # BATCH-INVARIANT prelude (leading axis 1):
                                # captured by the scan closure instead of
                                # riding the xs — every frame reads the one
                                # entry (Indexed clips its index to 0), and
                                # XLA computes it once per batch.
                                static_prelude_vals[name] = value
                            elif value.shape[0] != packed.shape[0]:
                                raise ValueError(
                                    f"Prelude {name!r}: leading axis "
                                    f"{value.shape[0]} != batch {packed.shape[0]}")
                            else:
                                prelude_vals[name] = value

            def body(carry, per_frame):
                packed_row, frame_streams, frame_preludes, step_id = per_frame
                frame_uniforms = unpack_uniforms(packed_row, spec)
                textures = dict(static_tex)
                # Device-resident per-frame sequences: index by the stepped
                # frame counter (speed-independent, unlike iFrame)
                for name, sequence in sequences.items():
                    window = seq_windows.get(name, 0)
                    if window > 1:
                        # Ring sequence: the texture at frame k is the ring
                        # of the last `window` columns. The sequence is
                        # front-padded with window-1 zero columns, so the
                        # slice at start=k spans columns k-window+1..k
                        # (oldest first); rolling by k+2 reproduces the host
                        # write layout (column k sits at x=(k+1)%window).
                        k = jnp.clip(frame_uniforms["iFrameIndex"], 0,
                                     sequence.shape[0] - window)
                        lin = jax.lax.dynamic_slice_in_dim(
                            sequence, k, window, axis=0)       # (L, H, 1, C)
                        ring = jnp.roll(lin, k + 2, axis=0)
                        box = jnp.transpose(ring[:, :, 0, :], (1, 0, 2))
                    else:
                        index = jnp.clip(frame_uniforms["iFrameIndex"], 0,
                                         sequence.shape[0] - 1)
                        box = jax.lax.dynamic_index_in_dim(
                            sequence, index, 0, keepdims=False)
                    textures[name] = box[None, None]  # (1, 1, H, W, C)
                for name, stream_box in frame_streams.items():
                    # u8-on-the-wire streams (engine._stream_snapshot):
                    # normalize on device with the exact host-write math
                    # (texture._normalize's f32 /255 division)
                    if stream_box.dtype == jnp.uint8:
                        stream_box = stream_box.astype(jnp.float32) / 255.0
                    textures[name] = stream_box
                textures.update(carry)

                new_carry = {}
                tail_spec = None
                for prog, base_coords in zip(program_list, coords):
                    temporal = prog.texture.temporal
                    if temporal > 1:
                        matrix = textures[prog.name]
                    else:
                        width, height = prog.texture.resolution
                        matrix = jnp.zeros(
                            (1, prog.texture.layers, height, width,
                             prog.texture.components), jnp.float32)
                        textures[prog.name] = matrix
                    layers = matrix.shape[1]
                    frame_coords = finish_coords(base_coords, frame_uniforms["iResolution"])
                    for layer in range(layers):
                        ctx = Frag(
                            coords=frame_coords,
                            uniforms=frame_uniforms,
                            statics={**statics, "iLayer": layer},
                            textures=textures,
                            texture_meta=meta_snapshot,
                            layer=layer,
                            preludes={**frame_preludes,
                                      **{n: v[0] for n, v in
                                         static_prelude_vals.items()}},
                            prelude_stacks={**prelude_vals,
                                            **static_prelude_vals},
                            prelude_step=step_id,
                        )
                        with jax.named_scope(f"program_{prog.name}"):
                            out = prog.render_layer(ctx)
                        if isinstance(out, TailSpec):
                            if (prog is program_list[-1] and temporal == 1
                                    and layers == 1):
                                # Main program's tail feeds the final pass
                                # directly — its texture is never written
                                # (nothing renders after it this frame, and
                                # temporal==1 forbids cross-frame reads)
                                tail_spec = out
                                continue
                            out = tailfuse.eval_reference(
                                out, *base_coords["astuv"].shape[:2], aspect)
                            if out.shape[-1] < prog.texture.components:
                                out = jnp.concatenate([out, jnp.ones(
                                    out.shape[:-1] + (prog.texture.components
                                                      - out.shape[-1],),
                                    jnp.float32)], axis=-1)
                        matrix = matrix.at[0, layer].set(out)
                        textures[prog.name] = matrix
                    if temporal > 1:
                        matrix = jnp.roll(matrix, 1, axis=0)
                        textures[prog.name] = matrix
                        new_carry[prog.name] = matrix

                if tail_spec is not None:
                    render_h, render_w = sizes[-1]
                    frame = tailfuse.run_tail_final(
                        tail_spec, render_h, render_w,
                        out_height, out_width, subsample, aspect)
                else:
                    source = textures[main_name][main_slot, -1]
                    with jax.named_scope("final_pass"):
                        frame = final_pass(source, out_height, out_width,
                                           subsample)
                return new_carry, frame

            step_ids = jnp.arange(packed.shape[0], dtype=jnp.int32)
            return jax.lax.scan(
                body, carry, (packed, streams, prelude_vals, step_ids))

        self._render_fn = render_batch
        self._jitted = jax.jit(render_batch, donate_argnums=(0,), static_argnums=(5,))
        self.stale = False
        del meta  # exposed via meta_snapshot in the closure
        logger.debug(f"Engine built: {len(program_list)} programs, "
                     f"{len(self._static_tex)} static + {len(self._streamed_names)} streamed textures, "
                     f"output {out_width}x{out_height} subsample {subsample}")

    # ------------------------------------------------------------------ #
    # Batch capture (host side, per frame)

    def begin_batch(self) -> None:
        if not self.stale:
            self._refresh_static_textures()  # may invalidate (ring change)
        if self.stale:
            self.build()
        else:
            self._ensure_prelude_cache()  # sequence unbinds must drop caches
        self._frame_uniforms = []
        self._frame_streams = {name: [] for name in self._streamed_names}

    def _bind_sequence(self, name: str, tex) -> None:
        """Bind a device sequence. Ring sequences (sequence_window=L) are
        per-frame (H, 1, C) columns; front-pad L-1 zero columns so the
        in-scan window slice at frame 0 sees an empty history (matching the
        host ring's zero-initialized texture)."""
        seq = jnp.asarray(tex.sequence)
        window = tex.sequence_window or 0
        if window > 1:
            pad = jnp.zeros((window - 1,) + seq.shape[1:], seq.dtype)
            seq = jnp.concatenate([pad, seq], axis=0)
            self._sequence_windows[name] = window
        else:
            self._sequence_windows.pop(name, None)
        self._sequences[name] = seq

    def _refresh_static_textures(self) -> None:
        """Re-upload any texture whose host copy changed between batches
        (e.g. a file-drop background swap); rebind device sequences."""
        for name, tex in self._external_textures().items():
            if tex.sequence is not None:
                if (tex.sequence_window or None) != self._sequence_windows.get(name):
                    self.invalidate()  # ring structure changed: retrace
                    continue
                self._bind_sequence(name, tex)
                self._static_tex.pop(name, None)
                tex.dirty = False
                continue
            self._sequences.pop(name, None)
            if name in self._streamed_names:
                continue
            if name not in self._static_tex or tex.version != self._static_versions.get(name):
                if tex.matrix is None:
                    tex.make()
                self._static_tex[name] = jnp.asarray(tex.matrix)
                self._static_versions[name] = tex.version
                tex.dirty = False

    def _sequence_signature(self) -> tuple:
        """Name + shape + dtype of every bound device sequence — the part of
        engine state a batch-invariant prelude is allowed to observe."""
        return tuple(sorted(
            (name, tuple(seq.shape), str(seq.dtype))
            for name, seq in self._sequences.items()))

    def _ensure_prelude_cache(self) -> None:
        """(Re)materialize batch-invariant prelude fields.

        Recomputing frame-invariant per-pixel fields inside every render
        launch costs real device time (~15 ms/batch for the visualizer's
        static fields at 1080p ssaa=2), so prelude fns whose output proves
        batch-invariant are evaluated once here under a probe jit and their
        results threaded through the static-texture dict under a reserved
        name (signature + sharded wrappers unchanged).

        Contract: a cached prelude may depend on sequence PRESENCE / shape /
        dtype (the probe re-runs whenever that signature or the prelude fn
        set changes — including on the key-unchanged build fast path and
        between batches) but NOT on sequence contents or on the concrete
        frame-index VALUES. Both dependences are detected, not trusted: the
        probe evaluates each fn twice at different frame offsets (0 and 7)
        and only caches outputs with leading axis 1 that are bit-identical
        across both probes — a prelude that reduces over ctx.frames /
        ctx.rows(...) falls back to per-launch evaluation in render_batch.

        Under SKIP_TPU the probe is skipped entirely (the flag exists to
        benchmark the pure host loop; flush() never runs device programs),
        leaving the per-launch axis-1 fallback semantically in charge."""
        # Identify prelude fns by (name, __code__): scenes re-register fresh
        # closures from the same factory on every build (demo.py
        # _static_prelude_field), and keying on id(f) made every scene.main
        # re-trace + re-run the full-resolution probe (~0.5 s/export on the
        # chip). Same-code closures share semantics by the batch_preludes
        # contract; a genuinely different fn under the same name still
        # differs in __code__.
        state = (tuple(sorted((n, id(getattr(f, "__code__", f)))
                              for n, f in self._prelude_fns.items())),
                 self._sequence_signature(), self._main_size, self._aspect)
        if state == self._prelude_probe_state:
            return
        self._prelude_probe_state = state
        for name in [n for n in self._static_tex if n.startswith(_PRELUDE_KEY)]:
            del self._static_tex[name]
        if not self._prelude_fns or SKIP_TPU:
            return
        memo = self._prelude_probe_memo.get(state)
        if memo is not None:
            # Repeat scene.main()s flip the sequence signature (module
            # setup() unbinds, the first update rebinds) — serve the already
            # probed device arrays instead of re-probing per export.
            for name, value in memo.items():
                self._static_tex[_PRELUDE_KEY + name] = value
            return
        prelude_fns = dict(self._prelude_fns)
        main_size, aspect = self._main_size, self._aspect

        def _probe(sequences, offsets):
            ctx = PreludeCtx(offsets, sequences, main_size, aspect)
            vals = {}
            for name, fn in prelude_fns.items():
                value = fn(ctx)
                if value is not None and value.shape[0] == 1:
                    vals[name] = value
            return vals

        t0 = time.perf_counter()
        # Frame-index-value dependence is decided STATICALLY: outputs whose
        # jaxpr does not (transitively) depend on the frame-offset input are
        # provably batch-invariant. A value comparison would need a
        # device->host readback (a sync point on every engine build), so no
        # probe bytes ever leave the device.
        offsets0 = jnp.arange(2, dtype=jnp.int32)
        closed = jax.make_jaxpr(_probe)(self._sequences, offsets0)
        flat_outs = closed.jaxpr.outvars
        names = sorted(jax.jit(_probe).eval_shape(self._sequences, offsets0))
        n_seq_leaves = len(jax.tree_util.tree_leaves(self._sequences))
        tainted: set[int] = set()  # id()-keyed: Literals aren't hashable
        in_vars = closed.jaxpr.invars
        if len(in_vars) > n_seq_leaves:
            tainted.add(id(in_vars[n_seq_leaves]))
            for eqn in closed.jaxpr.eqns:
                if any(id(v) in tainted for v in eqn.invars):
                    tainted.update(id(v) for v in eqn.outvars)
        invariant = [name for name, var in zip(names, flat_outs)
                     if id(var) not in tainted]
        if invariant:
            values = jax.jit(_probe)(self._sequences, offsets0)
            cached = {}
            for name in invariant:
                self._static_tex[_PRELUDE_KEY + name] = values[name]
                cached[name] = values[name]
            self._prelude_probe_memo[state] = cached
            # Memo holds full-resolution device arrays: keep it tiny (the
            # realistic churn is ONE signature flip per scene.main)
            while len(self._prelude_probe_memo) > 2:
                self._prelude_probe_memo.pop(
                    next(iter(self._prelude_probe_memo)))
        for name in set(names) - set(invariant):
            logger.debug(f"Prelude {name!r} depends on frame index values; "
                         f"left per-launch (not cached)")
        self.probe_seconds = time.perf_counter() - t0
        if self.probe_seconds > 2.0:
            logger.info(f"Prelude probe: {self.probe_seconds:.1f}s "
                        f"(compile + run, {len(invariant)} fields)")

    def capture_frame(self) -> None:
        """Snapshot the current frame's uniforms + dirty textures. Called
        after the scene ran every module's update() for this frame."""
        uniforms: dict[str, np.ndarray] = {}
        statics_changed = False
        for variable in self.scene.full_pipeline():
            if variable.value is None:
                continue
            if variable.static:
                if self._statics.get(variable.name) != variable.value:
                    statics_changed = True
                continue
            if variable.type == "sampler2D":
                continue
            uniforms[variable.name] = variable.coerce()
            self._uniform_kinds[variable.name] = (
                "i" if variable.type == "int" else
                "b" if variable.type == "bool" else "f")
        if statics_changed:
            # A static (program-specializing) uniform changed mid-run; the
            # next batch rebuilds around the new value.
            self.invalidate()
        self._frame_uniforms.append(uniforms)

        frame_index = len(self._frame_uniforms) - 1
        for name, tex in self._external_textures().items():
            if tex.sequence is not None:
                tex.dirty = False
                if name not in self._sequences:
                    self.invalidate()  # sequence appeared mid-run: rebuild
                continue
            streamed = name in self._streamed_names
            if tex.dirty and not streamed:
                # Texture became per-frame dynamic: promote to streamed. The
                # compiled closure handles streams generically, so refresh the
                # build key in place instead of invalidating (a rebuild would
                # retrace for nothing).
                self._streamed_names.add(name)
                self._static_tex.pop(name, None)
                self._build_key = self._compute_build_key()
                backfill = self._stream_snapshot(name, tex)
                self._frame_streams[name] = [backfill] * frame_index
                streamed = True
                if frame_index:
                    logger.debug(f"Texture {name} became streamed mid-batch at frame {frame_index}")
            if streamed:
                self._frame_streams[name].append(self._stream_snapshot(name, tex))
                tex.dirty = False

    def _stream_snapshot(self, name: str, tex) -> np.ndarray:
        """Host snapshot of a streamed texture's content. u8-on-the-wire
        when the texture's last write kept its u8 twin (texture.wire_u8 —
        video frames): the host->device stream ships 1 byte/channel
        instead of 4 (4K batch 32: 3.19 GB -> 0.80 GB per flush) and
        render_batch normalizes back to f32 in-jit with the same /255
        division the host write used. A name that ever falls back to f32
        stays f32 — a mixed-dtype stack would silently upcast raw 0-255
        u8 values into the normalized f32 stream."""
        wire = getattr(tex, "wire_u8", None)
        if wire is not None and name not in self._stream_f32:
            return wire  # fresh array per write(); never mutated in place
        if name not in self._stream_f32:
            self._stream_f32.add(name)
            snaps = self._frame_streams.get(name) or []
            for index, snap in enumerate(snaps):
                if snap.dtype == np.uint8:  # exact: stored u8/255 == matrix
                    snaps[index] = snap.astype(np.float32) / 255.0
        return tex.matrix.copy()

    # ------------------------------------------------------------------ #
    # Flush: run the device program

    def stack_captures(self, count: Optional[int] = None, pad_to: Optional[int] = None):
        """Stack the captured per-frame state into batch arrays.

        All scalar/vector uniforms pack into ONE (F, K) float32 matrix (one
        host->device transfer instead of one per uniform — transfer latency
        is per-array) plus a static unpack spec; streamed textures stack per
        name. Returns (packed, spec, streams)."""
        count = count if count is not None else len(self._frame_uniforms)
        pad = (pad_to - count) if (pad_to and pad_to > count) else 0
        frames = self._frame_uniforms
        if pad:
            frames = frames + [frames[-1]] * pad

        # Union of names across the whole batch: a uniform first yielded
        # mid-batch (a module activating after frame 0) must not be dropped,
        # and one disappearing mid-batch must not KeyError. Missing values
        # fill from the nearest frame that has them (backward, then forward).
        names = sorted(set().union(*(frame.keys() for frame in frames)))
        first_value = {}
        for frame in frames:
            for name, value in frame.items():
                first_value.setdefault(name, value)
        spec = []
        offset = 0
        for name in names:
            value = np.asarray(first_value[name])
            size = int(value.size)
            shape = value.shape if value.ndim else ()
            spec.append((name, offset, size, self._uniform_kinds.get(name, "f"), shape))
            offset += size
        packed = np.empty((len(frames), offset), np.float32)
        last = dict(first_value)
        for row, frame in enumerate(frames):
            position = 0
            for name in names:
                raw = frame.get(name)
                if raw is None:
                    raw = last[name]
                else:
                    last[name] = raw
                value = np.asarray(raw, np.float32).reshape(-1)
                packed[row, position:position + value.size] = value
                position += value.size

        streams = {}
        for name, snapshots in self._frame_streams.items():
            if pad:
                snapshots = snapshots + [snapshots[-1]] * pad
            streams[name] = np.stack(snapshots)
        return packed, tuple(spec), streams

    def flush(self, count: Optional[int] = None, pad_to: Optional[int] = None):
        """Render all captured frames; returns (F, H, W, 3) uint8 on device.

        pad_to repeats the last frame to keep a stable batch shape (avoids a
        retrace on the final partial batch); the padding is cropped off.
        """
        count = count if count is not None else len(self._frame_uniforms)
        self.last_flush_retraced = False
        if count == 0:
            return None
        if SKIP_TPU:
            width, height = self.scene._final.texture.resolution
            return np.zeros((count, height, width, 3), np.uint8)
        if self.stale:
            # Something re-specialized during capture (e.g. a module bound a
            # device sequence on its first update): rebuild before running —
            # captured uniforms/streams remain valid
            self.build()

        if self.mesh is not None and not self._carry:
            # Frame-sharded SPMD path (feedback-free scenes only): the batch
            # splits F/N per device, uniforms/streams shard on their leading
            # axis, textures replicate; zero collectives in the hot loop
            # (parallel/mesh.py). The batch must divide the mesh size, so a
            # partial flush self-pads to the next multiple by replicating
            # the last frame's inputs (the padded frames are cropped off) —
            # callers never need to know the mesh size.
            n = self.mesh.devices.size
            target = max(pad_to or 0, count)
            target = -(-target // n) * n
            packed, spec, streams = self.stack_captures(count, target)
            frames_u8 = self._sharded(spec)(
                self._carry, packed, streams, self._static_tex, self._sequences)
            return frames_u8[:count] if packed.shape[0] > count else frames_u8

        if self.mesh is not None:
            # Row-sharded GSPMD path for temporal-feedback scenes: the frame
            # scan stays global, textures/frames split on pixel rows
            # (parallel/mesh.py:shard_row_renderer). No batch-divisibility
            # requirement (the batch axis is unsharded).
            packed, spec, streams = self.stack_captures(count, pad_to)
            sharded, carry_shardings = self._row_sharded(spec)
            for name, sharding in carry_shardings.items():
                leaf = self._carry[name]
                if getattr(leaf, "sharding", None) != sharding:
                    self._carry[name] = jax.device_put(leaf, sharding)
            self._carry, frames_u8 = sharded(
                self._carry, packed, streams, self._static_tex, self._sequences)
            return frames_u8[:count] if (pad_to and pad_to > count) else frames_u8

        packed, spec, streams = self.stack_captures(count, pad_to)

        before = self._jitted._cache_size()
        t0 = time.perf_counter()
        self._carry, frames_u8 = self._jitted(
            self._carry, packed, streams, self._static_tex, self._sequences, spec)
        # Consumers that time launches (the realtime micro-batch controller)
        # must be able to discard compile-polluted samples
        self.last_flush_retraced = self._jitted._cache_size() != before
        if self.last_flush_retraced:
            took = time.perf_counter() - t0
            self.compile_events.append((packed.shape[0], took))
            logger.info(f"Engine (re)traced: batch={packed.shape[0]} "
                        f"uniforms={packed.shape[1]} streams={sorted(streams)} "
                        f"sequences={sorted(self._sequences)} "
                        f"(cache {before}->{self._jitted._cache_size()}, "
                        f"{took:.1f}s)")
        return frames_u8[:count] if (pad_to and pad_to > count) else frames_u8

    def cost_analysis(self, count: Optional[int] = None,
                      pad_to: Optional[int] = None) -> dict:
        """XLA's compiled cost model for the current batch's render program
        (flops / bytes accessed per BATCH): the raw material for the roofline
        table (tools/roofline.py). Pallas custom calls are opaque to XLA's
        model — the tool adds their analytic traffic on top. Mirrors the
        non-sharded flush() argument layout."""
        count = count if count is not None else len(self._frame_uniforms)
        packed, spec, streams = self.stack_captures(count, pad_to)
        lowered = self._jitted.lower(
            self._carry, packed, streams, self._static_tex, self._sequences,
            spec)
        analysis = lowered.compile().cost_analysis()
        if isinstance(analysis, (list, tuple)):  # per-device list on old jax
            analysis = analysis[0]
        return dict(analysis or {})

    def _sharded(self, spec):
        """Cached frame-sharded wrapper of the current render closure."""
        key = (id(self._render_fn), spec)
        if key not in self._sharded_cache:
            from shaderflow_tpu.parallel.mesh import shard_frame_renderer
            render = self._render_fn

            def step(carry, packed, streams, statics, sequences):
                return render(carry, packed, streams, statics, sequences, spec)

            self._sharded_cache[key] = shard_frame_renderer(step, self.mesh)
        return self._sharded_cache[key]

    def _row_sharded(self, spec):
        """Cached row-sharded wrapper (temporal-feedback scenes)."""
        carry_shapes = {name: tuple(leaf.shape)
                        for name, leaf in self._carry.items()}
        key = ("rows", id(self._render_fn), spec,
               tuple(sorted(carry_shapes.items())))
        if key not in self._sharded_cache:
            from shaderflow_tpu.parallel.mesh import shard_row_renderer
            render = self._render_fn

            def step(carry, packed, streams, statics, sequences):
                return render(carry, packed, streams, statics, sequences, spec)

            out_width, out_height = self.scene._final.texture.resolution
            self._sharded_cache[key] = shard_row_renderer(
                step, self.mesh, carry_shapes, out_height)
        return self._sharded_cache[key]

    # ------------------------------------------------------------------ #

    def reset_carry(self) -> None:
        """Re-seed program textures from their host matrices (scene reset)."""
        for prog in self._programs():
            if prog.texture.temporal > 1 and prog.texture.matrix is not None:
                self._carry[prog.name] = jnp.asarray(prog.texture.matrix)
