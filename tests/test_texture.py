"""ShaderTexture construction, the u8 streaming twin and read()."""

import numpy as np
import pytest

from shaderflow_tpu.scene import ShaderScene
from shaderflow_tpu.texture import ShaderTexture


class Holder:
    def __init__(self):
        self.scene = ShaderScene()
        self.tracked = ShaderTexture(scene=self.scene, name="tracked",
                                     track=True)
        self.plain = ShaderTexture(scene=self.scene, name="plain", width=4,
                                   height=2, components=3)


def test_tracking_texture_registers_with_scene():
    """A tracking texture is a full module: it knows its scene, follows the
    scene's render resolution, and starts with no device sequence."""
    holder = Holder()
    scene, texture = holder.scene, holder.tracked
    assert texture.scene.uuid == scene.uuid
    assert texture in scene.modules
    assert texture.sequence is None
    assert texture.sequence_window is None
    assert texture.resolution == tuple(scene.render_resolution)
    assert texture.matrix.shape[2:4] == (texture.height, texture.width)


def test_matrix_assignment_keeps_module_state():
    """Assigning the matrix (make(), roll()) touches only the content."""
    holder = Holder()
    texture = holder.plain
    texture.roll(1)
    texture.make()
    assert texture.scene.uuid == holder.scene.uuid
    assert texture.sequence is None


def test_read_is_read_only_view():
    """read() cannot be used to mutate the matrix behind wire_u8's back:
    after a full-box u8 write the streamed bytes and the matrix agree."""
    texture = Holder().plain
    data = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    texture.write(data)
    view = texture.read()
    with pytest.raises(ValueError):
        view[0, 0, 0] = 1.0
    np.testing.assert_array_equal(
        texture.wire_u8[0, 0].astype(np.float32) / 255.0, texture.read())


@pytest.mark.parametrize("where", [dict(layer=3), dict(temporal=1),
                                   dict(temporal=-2)])
def test_u8_write_rejects_out_of_range_box(where):
    """The u8 fast path serves only the single (0, 0) box; other indices
    reach the indexed write and fail as they did before it existed."""
    texture = Holder().plain
    data = np.zeros((2, 4, 3), np.uint8)
    with pytest.raises(IndexError):
        texture.write(data, **where)
    assert texture.wire_u8 is None


@pytest.mark.parametrize("where", [dict(), dict(layer=0), dict(layer=-1),
                                   dict(temporal=0)])
def test_u8_write_default_box_keeps_wire(where):
    texture = Holder().plain
    data = np.full((2, 4, 3), 255, np.uint8)
    texture.write(data, **where)
    assert texture.wire_u8 is not None
    np.testing.assert_array_equal(texture.read(), 1.0)
