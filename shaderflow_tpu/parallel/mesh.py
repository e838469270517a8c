"""
Multi-device scaling: shard the frame batch over a 1D device mesh.

The reference is single-process/single-GPU (SURVEY.md §2 "Parallelism"):
its only parallel axis is per-pixel on the GPU. Across several cards the
natural scaling axis of this domain is FRAMES — frames of an export are independent
given their uniforms and audio textures (all tiny and replicated), so a
batch of F frames shards F/N per chip over a 1D mesh with zero collectives
in the hot loop; each chip runs the same scanned render program on its
slice and the uint8 results gather on the hosts feeding the encoder.

Caveat: temporal-feedback scenes (texture.temporal > 1, e.g. MotionBlur,
Life) have a sequential dependency between frames; those scenes keep the
frame scan global and shard the PIXEL ROW axis instead
(`shard_row_renderer`). `supports_frame_sharding` reports which applies.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def frame_mesh(n_devices: Optional[int] = None, axis: str = "frames") -> Mesh:
    """A 1D mesh over the first n devices."""
    devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    import numpy as np
    return Mesh(np.array(devices), (axis,))


def supports_frame_sharding(scene) -> bool:
    """Frame-parallel rendering is exact iff no program carries temporal
    state between frames."""
    from shaderflow_tpu.shader import ShaderProgram
    return all(
        module.texture.temporal == 1
        for module in scene.modules
        if isinstance(module, ShaderProgram))


def shard_frame_renderer(render_fn, mesh: Mesh, axis: str = "frames"):
    """Wrap an engine render closure (carry, uniforms, streams, statics) ->
    (carry, frames) into a frame-sharded SPMD program.

    uniforms/streams shard on their leading (frame) axis; the carry and
    static textures replicate. Each device runs its own local scan; the
    per-device carries are discarded (frame sharding is only used for
    feedback-free scenes), so the wrapper returns frames only.
    """

    def local(carry, packed, streams, statics, sequences):
        _, frames = render_fn(carry, packed, streams, statics, sequences)
        return frames

    specs = dict(
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
    )
    return jax.jit(shard_map(local, check_vma=False, **specs))


def shard_row_renderer(render_fn, mesh: Mesh, carry_shapes: dict,
                       out_height: int, axis: Optional[str] = None):
    """Row-sharded (GSPMD) renderer for temporal-feedback scenes.

    Frame sharding is inexact when a program carries temporal state (frame
    k reads frame k-1's texture), so the PIXEL ROW axis shards instead:
    every device holds an H/N slab of each temporal texture and of the
    output frames, the frame scan stays global (all devices step the same
    frame together), and XLA's SPMD partitioner inserts whatever halo
    exchanges / gathers cross-slab texture samples require. Exact by
    construction — identical math, partitioned layout (verified
    bit-identical vs the single-device scan in test_parallel_scenes.py).

    Carry leaves (T, L, H, W, C) shard on H when divisible by the mesh
    size; indivisible leaves replicate (still correct, just unsharded —
    e.g. Life's fixed 192x108 simulation texture on 8 devices). The output
    (F, H_out, W, 3) shards on H_out.

    Returns (jitted_fn, carry_shardings): callers device_put the carry to
    `carry_shardings` once; donation keeps it resident thereafter.
    """
    axis = axis or mesh.axis_names[0]
    n = mesh.devices.size
    replicated = NamedSharding(mesh, P())

    def leaf(shape):
        spec = P(None, None, axis) if shape[2] % n == 0 else P()
        return NamedSharding(mesh, spec)

    carry_sh = {name: leaf(shape) for name, shape in carry_shapes.items()}
    frames_sh = NamedSharding(
        mesh, P(None, axis) if out_height % n == 0 else P())
    jitted = jax.jit(
        render_fn,
        in_shardings=(carry_sh, replicated, replicated, replicated,
                      replicated),
        out_shardings=(carry_sh, frames_sh),
        donate_argnums=(0,))
    return jitted, carry_sh
