"""The dry run (``launch.dryrun``) and its census (``launch.analysis``).

- The census against ``FlopCounterMode``: a reduced qwen2-0.5b train step
  on the meta device counts exactly the aten FLOPs ``FlopCounterMode``
  counts on the same step run on the CPU, with the kernels' plain
  versions hidden from it (on the card a kernel is one op with no
  formula), and its kernel calls follow ROADMAP's launch table.
- The probes: on a reduced dense and a reduced hybrid config,
  ``_extrapolate`` of the 1- and 2-period meta runs gives the full-depth
  census exactly (the reference needed the probes because XLA counts a
  loop body once; the meta run counts every layer).
- The census's memory: views share a storage, a storage is freed with
  its last tensor, in-place updates add nothing, autograd keeps what it
  saved.
- ``main`` writes a pair's record, a skip record with the reference's
  reason, and the ``--spreeze``, ``--spreeze-arch`` and
  ``--spreeze-sampler`` records.
"""
import dataclasses
import functools
import json

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import analysis, dryrun
from repro_torch.train.trainer import init_train_state, make_train_step

SHAPE = InputShape("train_small", 64, 2, "train")


def _hidden(fn):
    """``fn`` run with every dispatch mode off: a kernel's plain version,
    which the card runs as one op with no FLOP formula."""
    @functools.wraps(fn)
    def run(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    return run


def test_census_flops_equal_flop_counter_on_the_cpu(monkeypatch):
    cfg = get_config("qwen2-0.5b").reduced(num_layers=2)
    rc = dryrun._run_config(cfg, SHAPE)
    census, _, _ = dryrun._lower_train(rc)
    for mod, names in ((rms, ("rmsnorm_ref", "rmsnorm_bwd_ref")),
                       (fa, ("attention_ref", "flash_attention_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, _hidden(getattr(mod, name)))
    params, state, opt = init_train_state(
        rc, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     dtype=torch.int32)}
    with FlopCounterMode(display=False) as counter:
        make_train_step(rc, opt)(params, state, batch)
    assert census.aten_flops == counter.get_total_flops() > 0
    # ROADMAP's launch table for a dense train step under remat, L layers
    L = cfg.num_layers
    assert census.kernel_calls == {"rmsnorm": 4 * L + 1,
                                   "rmsnorm_bwd": 2 * L + 1,
                                   "rope": 2 * L, "rope_bwd": L,
                                   "flash_attention": 2 * L,
                                   "flash_attention_bwd": L}


def _costs(cfg, kind):
    rc = dryrun._run_config(cfg, dataclasses.replace(SHAPE, kind=kind))
    return dryrun.census_costs(dryrun._lower_for(rc)[0])


@pytest.mark.parametrize("arch, layers", [("qwen2-0.5b", 4),
                                          ("zamba2-1.2b", 6)])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_probes_extrapolate_to_the_full_depth_census(arch, layers, kind):
    """Exactly, but for the hybrid train step's bytes: its backward turns
    each group's slice of the stacked core layers into a gradient of the
    whole stack (a slice's backward), so its bytes grow with groups x
    layers, faster than the depth; the extrapolation reads them low."""
    cfg = get_config(arch).reduced(num_layers=layers)
    c1 = _costs(dryrun._scale_depth(cfg, 1), kind)
    c2 = _costs(dryrun._scale_depth(cfg, 2), kind)
    full = _costs(cfg, kind)
    assert dryrun._n_periods(cfg) == (3 if arch == "zamba2-1.2b" else 4)
    got = dryrun._extrapolate(c1, c2, dryrun._n_periods(cfg))
    if arch == "zamba2-1.2b" and kind == "train":
        assert got.pop("bytes") < full.pop("bytes")
    assert got == full


def test_census_memory_follows_storages():
    mb = 1 << 20
    n = mb // 4                                         # 1 MB of float32
    with analysis.OpCensus() as c:
        a = torch.empty(n, device="meta")               # 1 MB
        b = a * 2                                       # 2
        v = b.view(-1)                                  # a view: nothing
        v.mul_(3)                                       # in place: nothing
        del b                                           # v keeps it alive
        d = v + 1                                       # 3: the peak
        del v, d                                        # both freed: 1
        e = a + 1                                       # 2
    assert (c.argument_bytes, c.peak_temp_bytes) == (0, 3 * mb)
    assert c.temp_bytes >= 2 * mb
    del e
    x = torch.empty(n, device="meta", requires_grad=True)
    with analysis.OpCensus() as c:
        z = torch.exp(x * 2)                            # x an argument; 2
        s = z.sum()                                     # x * 2 freed
        del z                                           # exp saved it
        w = torch.empty(n, device="meta")               # z, s, w: 2 + 512
        del s                                           # the graph goes
        w2 = torch.empty(n, device="meta")              # w, w2: 2
    assert c.argument_bytes == mb
    assert c.peak_temp_bytes == 2 * mb + 512      # 2 MB had z been freed
    assert c.dtypes[torch.float32] > 0 and c.ops > 0
    del w, w2


def test_main_writes_a_pair_and_a_skip(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "mamba2-130m_decode_32k_16x16.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "chips", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device",
                "compute_s", "memory_s", "collective_s", "bottleneck",
                "model_flops", "useful_ratio", "peak_memory_per_device",
                "notes", "lower_s", "compile_s", "collective_breakdown",
                "state_bytes_per_device", "fits_one_card"):
        assert key in rec
    assert rec["collective_bytes_per_device"] is None
    assert rec["census"]["kernels"]["rmsnorm"]["calls"] == 2 * 24 + 1
    assert rec["fits_one_card"] and rec["bottleneck"] == "memory"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path), "--multipod"]) == 0
    rec = json.loads((tmp_path / "qwen2-0.5b_long_500k_2x16x16.json")
                     .read_text())
    assert rec["skipped"].startswith("pure full-attention arch")
    out = capsys.readouterr().out
    assert "[mamba2-130m_decode_32k_16x16] ok" in out and "SKIP" in out


def test_spreeze_records(tmp_path, monkeypatch):
    """``--spreeze`` at a small batch (the ac placement moves fewer bytes
    into a device than dp: only rows, actions and Q values cross the ac
    rows, and each Q tower's gradients are summed within its row), and
    ``--spreeze-arch`` and ``--spreeze-sampler`` (a reduced backbone, few
    envs)."""
    assert dryrun.main(["--spreeze", "--spreeze-batch", "256",
                        "--out", str(tmp_path)]) == 0
    ac, dp = (json.loads((tmp_path / f"spreeze_rl_{p}.json").read_text())
              for p in ("ac", "dp"))
    assert (ac["groups"], dp["groups"]) == (16, 32)
    assert ac["unresolved_move_bytes"] == dp["unresolved_move_bytes"] == 0
    assert 0 < ac["collective_bytes_per_device"] < \
        dp["collective_bytes_per_device"]
    small = get_config("smollm-360m").reduced(num_layers=2)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: small)
    rec = dryrun.lower_spreeze_arch("smollm-360m", batch=2, seq=16)
    assert rec["census"]["kernels"]["flash_attention_bwd"]["calls"] == 3 * 2
    assert rec["collective_bytes_per_device"] is None
    rec = dryrun.lower_spreeze_sampler(num_envs=64, chunk_len=2)
    assert rec["flops_per_device"] > 0 and rec["num_envs"] == 64


def test_roofline_terms():
    r = analysis.Roofline(arch="a", shape="s", mesh="1", chips=1,
                          flops_per_device=989e12 + 67e12,
                          flops_f32_per_device=67e12,
                          bytes_per_device=3.35e12,
                          collective_bytes_per_device=None,
                          model_flops=989e12).finalize()
    assert r.compute_s == pytest.approx(2.0) and r.memory_s == 1.0
    assert r.collective_s is None and r.bottleneck == "compute"
    r = dataclasses.replace(r, collective_bytes_per_device=900e9).finalize()
    assert r.collective_s == pytest.approx(2.0)


def test_model_flops_estimate_uses_the_active_parameters():
    shape = InputShape("t", 16, 2, "train")
    dense, moe = get_config("qwen2-0.5b"), get_config("mixtral-8x7b")
    assert analysis.model_flops_estimate(dense, shape) == \
        6.0 * dense.param_count() * 32
    assert analysis.model_flops_estimate(moe, dataclasses.replace(
        shape, kind="decode")) == 2.0 * moe.active_param_count() * 2
    assert moe.active_param_count() < moe.param_count()


def test_meta_trees_hold_no_memory():
    """A full-size kimi-k2 (1T parameters) builds on the meta device."""
    from repro_torch.models import factory
    params = factory.init_params(get_config("kimi-k2-1t-a32b"),
                                 torch.Generator(), dtype=torch.bfloat16,
                                 device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert sum(t.numel() for t in tree_leaves(params)) > 1.0e12
