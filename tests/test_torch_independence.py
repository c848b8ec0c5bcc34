"""The port stands alone: nothing under ``src/repro_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
refuse to run on the CPU unless asked to."""
import ast
import importlib
import pathlib
import pkgutil

import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.core import SpreezeConfig, SpreezeTrainer
from repro_torch.kernels import _build
from repro_torch.replay import buffer as rb
from repro_torch.rl import sac
from repro_torch.rl.base import AlgoHP

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}

torch.set_num_threads(2)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_module_builds_nothing():
    for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(mod.name)
    assert _build.load_kernels.cache_info().currsize == 0


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


def test_default_device_is_cuda(no_gpu):
    assert SpreezeConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


@pytest.mark.parametrize("entry", ["trainer", "replay", "sac"])
def test_entry_points_raise_without_a_gpu(no_gpu, entry):
    hp = AlgoHP(hidden=(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "trainer":
            SpreezeTrainer(SpreezeConfig(hp=hp, replay_capacity=64,
                                         num_envs=2, batch_size=8))
        elif entry == "replay":
            rb.init_replay(64, rb.trainer_specs(3, 1))
        else:
            sac.init_state(torch.Generator(), 3, 1, hp)
    # and the same calls run when the CPU is asked for
    SpreezeTrainer(SpreezeConfig(hp=hp, replay_capacity=64, num_envs=2,
                                 batch_size=8, device="cpu"))
