"""chip_smoke.py must refuse to report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_fails_on_cpu_only_jax():
    result = _run(REPO / "chip_smoke.py", REPO)
    assert result.returncode != 0
    assert _no_result(result.stdout)
    assert "no GPU" in result.stderr


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_alone_fails(tmp_path, argv):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    result = subprocess.run([sys.executable, str(script), *argv],
                            cwd=tmp_path, env=env, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode != 0
    assert _no_result(result.stdout)
