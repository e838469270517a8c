"""Multi-chip frame sharding on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shaderflow_tpu import ops
from shaderflow_tpu.parallel import frame_mesh, shard_frame_renderer
from shaderflow_tpu.parallel.mesh import supports_frame_sharding
from shaderflow_tpu.scene import ShaderScene


class Ramp(ShaderScene):
    def build(self):
        self.shader.fragment = lambda sf: ops.vec4(
            jnp.broadcast_to(sf.iTime, sf.astuv.shape[:-1]),
            sf.astuv[..., 0], sf.astuv[..., 1], 1.0)


def _capture(scene, frames):
    scene._setup_run(width=64, height=32, fps=10, time=frames / 10, freewheel=True)
    engine = scene.engine
    engine.begin_batch()
    for _ in range(frames):
        scene.next(dt=scene.frametime)
    packed, spec, streams = engine.stack_captures(frames)
    render = engine._render_fn
    step = (lambda carry, packed, streams, statics, sequences:
            render(carry, packed, streams, statics, sequences, spec))
    return engine, step, (engine._carry, packed, streams, engine._static_tex,
                          engine._sequences)


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_frame_sharded_render_matches_single_device():
    frames = 16
    scene = Ramp()
    engine, step, args = _capture(scene, frames)

    # Single-device reference
    _, expected = jax.jit(step)(*args)
    expected = np.asarray(expected)

    mesh = frame_mesh(8)
    renderer = shard_frame_renderer(step, mesh)
    got = np.asarray(renderer(*args))

    assert got.shape == (frames, 32, 64, 3)
    np.testing.assert_array_equal(got, expected)


def test_supports_frame_sharding_detects_feedback():
    scene = Ramp()
    scene.initialize()
    assert supports_frame_sharding(scene)
    scene.shader.texture.temporal = 4
    assert not supports_frame_sharding(scene)


def test_output_is_frame_sharded():
    """The sharded output's leading axis layout spans the mesh."""
    frames = 8
    scene = Ramp()
    engine, step, args = _capture(scene, frames)
    mesh = frame_mesh(8)
    renderer = shard_frame_renderer(step, mesh)
    out = renderer(*args)
    assert len(out.sharding.device_set) == 8


def test_exported_video_identical_with_devices(tmp_path):
    """End-to-end: scene.main(devices=8) produces bit-identical raw output
    to the single-chip path (stateless scene, uneven final batch)."""
    single = tmp_path / "single.raw"
    sharded = tmp_path / "sharded.raw"
    Ramp().main(width=64, height=32, fps=10, time=1.1, output=str(single),
                batch=8)
    Ramp().main(width=64, height=32, fps=10, time=1.1, output=str(sharded),
                batch=8, devices=8)
    assert single.read_bytes() == sharded.read_bytes()


def test_feedback_scene_falls_back_to_single_chip(tmp_path):
    """Temporal-feedback scenes can't shard frames; devices=N must warn and
    still render correctly."""
    class Feedback(ShaderScene):
        def build(self):
            self.shader.texture.temporal = 2
            self.shader.fragment = lambda sf: ops.vec4(
                sf.texture(sf.tex("iScreen", 1, 0), sf.astuv)[..., 0] + 0.1,
                0.0, 0.0, 1.0)

    out = tmp_path / "fb.raw"
    Feedback().main(width=16, height=8, fps=10, time=0.3, output=str(out),
                    devices=8)
    frames = np.frombuffer(out.read_bytes(), np.uint8).reshape(3, 8, 16, 3)
    np.testing.assert_allclose(frames[:, 0, 0, 0] / 255, [0.1, 0.2, 0.3],
                               atol=0.01)


def test_devices_beyond_available_raise(tmp_path):
    """main(devices=N) with fewer than N devices must fail, not quietly
    render on one device."""
    import jax
    wanted = len(jax.devices()) * 2
    with pytest.raises(RuntimeError, match="devices"):
        Ramp().main(width=64, height=32, fps=10, time=0.2,
                    output=str(tmp_path / "x.raw"), devices=wanted)


def test_feedback_scene_indivisible_rows_raise(tmp_path):
    """A feedback scene whose height does not split over the devices cannot
    be row-sharded: the request fails instead of falling back."""
    class Feedback(ShaderScene):
        def build(self):
            self.shader.texture.temporal = 2
            self.shader.fragment = lambda sf: ops.vec4(0.5, 0.0, 0.0, 1.0)

    with pytest.raises(ValueError, match="row shards"):
        Feedback().main(width=16, height=12, fps=10, time=0.2,
                        output=str(tmp_path / "fb.raw"), devices=8)
