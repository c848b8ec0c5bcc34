"""tracelint configuration: which modules are hot, which are host-side by
design, and the budgets. Counterpart of
``repro/analysis/tracelint/config.py``.

The linter's model of the port lives here, not in the rules: the *hot*
modules (everything a megastep, an LM step or a decode step runs or
dispatches: a host read there stalls the card), the *host-side* modules
(checkpoints, resume bundles, the host-queue ablation, the launchers,
the benches: reads there are the point), the one module allowed to
change process-wide settings, and the shared-memory budget of a Hopper
block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# Modules whose code runs in, or dispatches, the device-resident hot
# loop. Matched as posix path suffixes (files) or infixes (directories).
HOT_MODULES: Tuple[str, ...] = (
    "repro_torch/core/pipeline.py",    # megastep + the train loop
    "repro_torch/core/runtime.py",     # publish path between megasteps
    "repro_torch/core/faults.py",      # the finite guard, in a megastep
    "repro_torch/train/trainer.py",    # LM train step loop
    "repro_torch/kernels/",            # kernel wrappers and routes
    "repro_torch/replay/",             # ring buffer / PER
    "repro_torch/serve/engine.py",     # decode loop
)

# Host-side modules where transfers and waits are by design; they
# override HOT_MODULES (replay/host_queue.py IS the host-transfer
# baseline).
HOST_ALLOW: Tuple[str, ...] = (
    "repro_torch/train/checkpoint.py",   # the SSD weight channel
    "repro_torch/train/resume.py",       # snapshot bundles
    "repro_torch/replay/host_queue.py",  # Fig. 4a host-queue ablation
    "repro_torch/launch/",               # entry points, the dry run
    "repro_torch/analysis/",             # this tool
    "repro_torch/benchmarks/",           # host-side timing harnesses
    "repro_torch/examples/",             # runnable demos
)

# The one module allowed to change process-wide settings (the backends'
# TF32 switches, default dtypes, the sync debug mode, the environment).
CONFIG_FILES: Tuple[str, ...] = (
    "repro_torch/__init__.py",
)

# Where the mesh axes are declared: the string keys of the axis-size
# dicts there, and every ``axis_names`` tuple of the scan, are the axis
# universe; a scan that declares none (a fixture corpus) falls back to
# DEFAULT_MESH_AXES.
MESH_DECL_FILES: Tuple[str, ...] = (
    "launch/mesh.py",
)
DEFAULT_MESH_AXES: Tuple[str, ...] = ("ac", "batch", "data", "model",
                                      "pod")

# The module that must carry the machine-checkable candidate-merge
# ordering contract of the sharded PER selection.
CONTRACT_FILE: str = "distributed/sharding.py"

# Shared memory of one block on an H100 (sm_90): 227 KB may be asked for
# dynamically, 48 KB declared statically.
SMEM_DYNAMIC_BYTES = 227 * 1024
SMEM_STATIC_BYTES = 48 * 1024


@dataclass(frozen=True)
class LintConfig:
    hot_modules: Tuple[str, ...] = HOT_MODULES
    host_allow: Tuple[str, ...] = HOST_ALLOW
    config_files: Tuple[str, ...] = CONFIG_FILES
    contract_file: str = CONTRACT_FILE
    default_mesh_axes: Tuple[str, ...] = DEFAULT_MESH_AXES
    # require the candidate-merge contract when contract_file is in the
    # scan (off for fixture corpora that do not carry one)
    require_contract: bool = True


def _match(rel: str, patterns: Tuple[str, ...]) -> bool:
    rel = rel.replace("\\", "/")
    for p in patterns:
        if p.endswith("/"):
            if ("/" + rel).find("/" + p) >= 0 or rel.startswith(p):
                return True
        elif rel == p or rel.endswith("/" + p):
            return True
    return False


def is_hot(rel: str, cfg: LintConfig) -> bool:
    """A hot module: the host-transfer rule applies (HOST_ALLOW wins)."""
    return _match(rel, cfg.hot_modules) and not _match(rel, cfg.host_allow)


def is_kernel_module(rel: str) -> bool:
    """A module of the kernels package (or a fixture's ``kernels/``)."""
    return _match(rel, ("kernels/",))


def is_config_file(rel: str, cfg: LintConfig) -> bool:
    return _match(rel, cfg.config_files)


def is_mesh_decl_file(rel: str) -> bool:
    return _match(rel, MESH_DECL_FILES)


def is_contract_file(rel: str, cfg: LintConfig) -> bool:
    return _match(rel, (cfg.contract_file,))
