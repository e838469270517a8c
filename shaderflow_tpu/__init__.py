"""
shaderflow-tpu: a shader-scene rendering framework on JAX (NVIDIA GPUs).

Re-creation of the capabilities of BrokenSource/ShaderFlow (reference:
/root/reference/shaderflow/__init__.py) where "fragment shaders" are pure
per-pixel JAX programs compiled by XLA — whole scenes become one jitted
program per frame batch — instead of GLSL over OpenGL.

Layout (mirrors SURVEY.md §1's layer map):
  ops/       pure JAX shader stdlib (GLSL-equivalent math, sampling, camera rays)
  module.py  ShaderModule lifecycle (build/setup/update/pipeline/handle/...)
  shader.py  ShaderProgram: pixel programs + jit compile cache + hot reload
  texture.py ShaderTexture: temporal x layers matrix of device arrays
  scene.py   ShaderScene: time model, event loop, batched export
  audio/     rolling buffer, batched STFT spectrogram, waveform
  piano/     MIDI piano roll (pure-python MIDI parser)
  io/        FFmpeg builder + video sinks + C++ frame pump (TurboPipe equivalent)
  parallel/  frame/pixel sharding over jax.sharding.Mesh
"""

import logging as _logging
import os
from pathlib import Path

__version__ = "0.1.0"

package: Path = Path(__file__).parent
"""Path to the shaderflow_tpu package directory"""

resources: Path = (package / "resources")
"""Path to bundled resources (default assets, test fixtures)"""


class _Directories:
    """User directories for logs/data. Reference uses PlatformDirs
    (/root/reference/shaderflow/__init__.py:20-24); we keep it dependency-free."""

    def __init__(self) -> None:
        base = Path(os.environ.get("SHADERFLOW_HOME", Path.home() / ".shaderflow_tpu"))
        self.user_data_path = base / "data"
        self.user_log_path = base / "logs"
        self.user_cache_path = base / "cache"

    def ensure(self) -> "_Directories":
        for path in (self.user_data_path, self.user_log_path, self.user_cache_path):
            path.mkdir(parents=True, exist_ok=True)
        return self


directories = _Directories()

# ------------------------------------------------------------------------- #
# Logging: a thin stand-in for the reference's 'dearlog' logger with the
# same helper names used throughout (info/warn/error/debug/minor/tip).

logger = _logging.getLogger("shaderflow_tpu")

if not logger.handlers:
    _handler = _logging.StreamHandler()
    _handler.setFormatter(_logging.Formatter("%(asctime)s %(levelname)-7s %(message)s", "%H:%M:%S"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("SHADERFLOW_LOGLEVEL", "INFO").upper())


def _join(args) -> str:
    return " ".join(str(x) for x in args)


logger.warn = lambda *a, **k: logger.warning(_join(a)) or _join(a)  # type: ignore[method-assign]
logger.minor = lambda *a, **k: logger.debug(_join(a)) or _join(a)  # type: ignore[attr-defined]
logger.tip = lambda *a, **k: logger.debug(_join(a)) or _join(a)  # type: ignore[attr-defined]
_info, _error, _debug = logger.info, logger.error, logger.debug
logger.info = lambda *a, **k: _info(_join(a)) or _join(a)  # type: ignore[method-assign]
logger.error = lambda *a, **k: _error(_join(a)) or _join(a)  # type: ignore[method-assign]
logger.debug = lambda *a, **k: _debug(_join(a)) or _join(a)  # type: ignore[method-assign]
