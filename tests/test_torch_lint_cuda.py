"""The port's linters on the card (marker ``gpu``; skips without a CUDA
device). This module imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lint_cuda.py
"""
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_linters_hold_on_the_card(dev):
    """``chip_smoke.py``'s phase 15: every hlolint contract clean under
    the sync debug mode "error" with ``LAUNCH_COUNTS`` per dispatch equal
    to the contract's and the meta census's, the host-read fixture caught
    on the card, tracelint clean, the sync debug mode restored."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    rows, launches = chip_smoke.run_linters(dev)
    assert len([r for r in rows if "contract" in r]) == 13
    assert launches["ring_gather"] > 0 and launches["decode_attention"] > 0


def test_hlolint_cli_defaults_to_the_card(dev, capsys):
    from repro_torch.analysis.hlolint import cli
    assert cli.main(["-q", "--only", "replay_add_batch",
                     "--only", "serve_decode_step"]) == 0
    assert "clean (2 contracts)" in capsys.readouterr().out
