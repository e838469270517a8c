"""Kernels compiled for the card (no interpret mode), against their plain
references at real widths — the same checks as chip_smoke.py phase 3. Each
test takes the `gpu` fixture and skips without a GPU."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_escape_kernel_matches_xla_on_gpu(gpu):
    chip_smoke.check_escape(2160, 3840)


def test_colsample_forms_agree_on_gpu(gpu):
    chip_smoke.check_colsample(2160, 3840, 1920)


def test_tail_kernel_matches_plain_on_gpu(gpu):
    chip_smoke.check_tail_kernel(1080, 1920, 1920)
