"""hlolint fixture corpus of the port: one entry point that breaks each
rule family, and a clean control.

``python -m repro_torch.analysis.hlolint --device cpu --fixtures
tests/torch_hlolint_fixtures/fixtures.py`` must report exactly the
findings tests/test_torch_hlolint.py asserts: the proof that every family
fires. The coverage scan reads this file as a hot module, so the bare
in-place site at the bottom is the coverage fixture. Every builder runs
on cpu, cuda and meta.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.hlolint.contract import (MOVE, CollectiveContract,
                                                   CollectiveRule,
                                                   EntrypointContract)
from repro_torch.distributed.sharding import group_devices, to_group, \
    trainer_rules
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_ac_mesh

HLOLINT_CONTRACTS = (
    # control: an in-place float32 update, quiet in every family
    EntrypointContract(name="good_entry", module=__name__, inplace=True,
                       state=("x",), launches={"rmsnorm": "1"}),
    # rebuilds its state every dispatch
    EntrypointContract(name="bad_inplace", module=__name__, inplace=True,
                       state=("x",)),
    # computes in float16 against a float32-only contract
    EntrypointContract(name="bad_dtype", module=__name__),
    # reads a device value on the host
    EntrypointContract(name="bad_host_read", module=__name__),
    # launches rmsnorm twice a dispatch against a declared once
    EntrypointContract(name="bad_launches", module=__name__,
                       launches={"rmsnorm": "calls"}),
    # moves the whole capacity-sized pool to every group: the allow rule
    # matches but the max_elems="capacity" cap rejects it
    EntrypointContract(
        name="bad_collective", module=__name__,
        collectives=CollectiveContract(
            allow=(CollectiveRule(MOVE, ("capacity",)),),
            max_elems="capacity")),
)


def _x(device):
    return torch.ones((4, 16), device=device)


# hlolint: entrypoint[good_entry]
def _good_entry(device, census):
    live = {"x": _x(device)}
    w = torch.ones((16,), device=device)

    def dispatch():
        live["x"].mul_(0.5).add_(1.0)
        kops.rmsnorm(live["x"], w)

    return {"dispatch": dispatch, "state": lambda: dict(live), "params": {}}


# hlolint: entrypoint[bad_inplace]
def _bad_inplace(device, census):
    live = {"x": _x(device)}

    def dispatch():
        live["x"] = live["x"] * 0.5 + 1.0

    return {"dispatch": dispatch, "state": lambda: dict(live), "params": {}}


# hlolint: entrypoint[bad_dtype]
def _bad_dtype(device, census):
    x = _x(device)

    def dispatch():
        (x.to(torch.float16) * 2).to(torch.float32)

    return {"dispatch": dispatch, "state": dict, "params": {}}


# hlolint: entrypoint[bad_host_read]
def _bad_host_read(device, census):
    x = _x(device)

    def dispatch():
        if x.sum() > 0:           # a device bool read on the host
            x.add_(1.0)

    return {"dispatch": dispatch, "state": dict, "params": {}}


# hlolint: entrypoint[bad_launches]
def _bad_launches(device, census):
    x, w = _x(device), torch.ones((16,), device=device)

    def dispatch():
        kops.rmsnorm(kops.rmsnorm(x, w), w)

    return {"dispatch": dispatch, "state": dict, "params": {"calls": 1}}


# hlolint: entrypoint[bad_collective]
def _bad_collective(device, census):
    cap = 1024
    mesh = make_ac_mesh(2, 4, devices=[device] * 8)
    census.watch(mesh)
    rules = trainer_rules(mesh, "ac")
    devs = group_devices(rules)
    with census.placing():
        pool = to_group(torch.ones((cap,)), devs[0], copy=True)

    def dispatch():
        for dev in devs[1:]:
            to_group(pool, dev)          # the whole pool to every group

    return {"dispatch": dispatch, "state": dict,
            "params": {"capacity": cap}}


BUILDERS = {
    "good_entry": _good_entry,
    "bad_inplace": _bad_inplace,
    "bad_dtype": _bad_dtype,
    "bad_host_read": _bad_host_read,
    "bad_launches": _bad_launches,
    "bad_collective": _bad_collective,
}


def _uncovered(pools, rows, ptr):
    """The coverage fixture: an in-place ring write with no hlolint
    annotation; the scan must flag the call line below."""
    return kops.ring_write_fields(pools, rows, ptr)
