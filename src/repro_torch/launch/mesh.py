"""The trainer's ("ac", "batch") mesh, and the reference's production
meshes as axis sizes. Counterpart of ``repro/launch/mesh.py``.

``make_production_mesh`` and ``make_debug_mesh`` give ``AxisMesh``es:
named axis sizes with no devices, which the sharding rules read
(``distributed.sharding.standard_rules``); the dry run reads from them
what each device would hold. Nothing runs on them.

``make_ac_mesh`` takes the visible CUDA devices by default and raises
when there are too few: a mesh never falls back to fewer devices than it
names. A caller may pass ``devices`` itself, and may name one device more
than once: ``make_ac_mesh(2, 2, devices=["cuda:0"] * 4)`` is the one-card
stand-in (every group's kernels on real shards, on one card), and
``devices=["cpu"] * 4`` the same mesh on the CPU, where the tests run it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import AxisMesh, Mesh, trainer_rules


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16) -> AxisMesh:
    """The reference's production mesh: 16x16 = 256 chips a pod
    ("data", "model"); ``multi_pod`` adds the ``pod`` axis, (2, 16, 16).
    The ``pod`` axis doubles as the Spreeze actor/critic axis under
    ``spreeze_rules``. ``data`` and ``model`` reshape the pod
    (``data * model`` stays 256)."""
    if data * model != 256:
        raise ValueError(f"a pod is 256 chips: data {data} x model {model}")
    axes = {"data": data, "model": model}
    return AxisMesh({"pod": 2, **axes} if multi_pod else axes)


def make_debug_mesh(data: int = 1, model: int = 1) -> AxisMesh:
    """A small ("data", "model") mesh (tests)."""
    return AxisMesh({"data": data, "model": model})


def make_ac_mesh(ac: int = 2, batch: int = 0,
                 devices: Optional[Sequence] = None) -> Mesh:
    """An (ac, batch) mesh for the multi-device megastep: the ``ac`` axis
    carries the double-Q ensemble (paper Fig. 2b), the ``batch`` axis the
    replay rows. ``batch=0`` takes every remaining device. ``devices``
    defaults to every visible CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if batch <= 0:
        batch = max(1, len(devs) // ac)
    need = ac * batch
    if len(devs) < need:
        raise RuntimeError(
            f"need {need} devices for an {ac}x{batch} ac mesh, found "
            f"{len(devs)}; pass devices=[...] to name the devices (a "
            f"device may be named more than once)")
    devs = devs[:need]
    return Mesh([devs[a * batch:(a + 1) * batch] for a in range(ac)])


def parse_ac_spec(spec: str) -> Tuple[int, int]:
    """CLI 'ACxBATCH' spec (e.g. '2x4') -> (ac, batch)."""
    try:
        ac, batch = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: want 'ACxBATCH', e.g. '2x4'") \
            from None
    return ac, batch


def parse_ac_mesh(spec: str, devices: Optional[Sequence] = None) -> Mesh:
    """CLI 'ACxBATCH' spec (e.g. '2x4') -> the ac mesh."""
    return make_ac_mesh(*parse_ac_spec(spec), devices)


def ring_shard_groups(mesh: Mesh, placement: str = "ac") -> int:
    """Number of replay-ring shards (batch groups) an ('ac', 'batch')
    trainer mesh induces under ``placement``: the divisor
    ``replay_capacity`` and ``batch_size`` must both honour
    (``SpreezeTrainer._check_mesh``)."""
    rules = trainer_rules(mesh, placement)
    return rules.axis_size(rules.batch)
