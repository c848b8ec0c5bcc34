"""Runner of the cells whose timed path is the port's RL update of towers
on interleaved Mamba-2 / attention backbones (granite-4.0-h-micro's
layout, the port's ``interleaved`` family): ``arch_rl_update``'s cell
(the same ``core.model_parallel.make_arch_spreeze_update``, batches,
spans, checked updates and recorded outputs) with the towers drawn by
``bench/lib/hybrid_weights``, the model FLOPs of
``bench/work/hybrid_flops``, the reference ``granite_towers``, and in
the traced sub-window the SSD scan's calls logged both ways and each
Mamba-2 mixer inside the span ``ssm_mixer``.

Its traced sub-window is reduced without CUPTI's own bookkeeping events
(``BOOKKEEPING``). Where the launch queue fills, as this backbone's many
small eager ops make it do, CUPTI reports a ``Command Buffer Full`` host
event for each blocked launch and links the kernel to it as well as to
the op that launched it; ``bench/lib/trace.reduce_events`` would give
that kernel's time to every span the two events start in, twice. Over
the op-linked events alone each device op is linked once (2 updates:
21,845 links against 21,846 device ops, 6.977 s against 6.977 s busy),
so the span metrics read device time once.
"""
from __future__ import annotations

import time
from unittest import mock

import torch

from bench.lib import hybrid_weights
from bench.lib import trace as trace_lib
from bench.reference import granite_towers as reference
from bench.runners import arch_rl_update as dense
from bench.runners.arch_rl_update import make_batches
from bench.work import hybrid_flops

# CUPTI's host events that are not a launching op
BOOKKEEPING = frozenset(("Command Buffer Full", "Activity Buffer Request",
                         "Buffer Flush"))


def model_config(cfg: dict):
    """The program's ``InterleavedConfig`` for the configuration's sizes
    (its first ``num_hidden_layers`` of ``layer_types``)."""
    from repro_torch.configs.base import InterleavedConfig, SSMConfig
    n = cfg["num_hidden_layers"]
    return InterleavedConfig(
        name=cfg["name"], family="interleaved", num_layers=n,
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        use_rope=cfg["position_embedding_type"] != "nope",
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        ssm=SSMConfig(state_dim=cfg["mamba_d_state"],
                      head_dim=cfg["mamba_d_head"],
                      expand=cfg["mamba_expand"], conv_dim=cfg["mamba_d_conv"],
                      chunk_size=cfg["mamba_chunk_size"],
                      ngroups=cfg["mamba_n_groups"]),
        layer_types=tuple(cfg["layer_types"][:n]),
        embedding_multiplier=cfg["embedding_multiplier"],
        attention_multiplier=cfg["attention_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=cfg["logits_scaling"])


class Cell(dense.Cell):
    """One run of a hybrid arch-update cell."""

    def setup(self) -> None:
        """The dense cell's set-up (its recorded outputs, checked updates
        and the change's redraw), over this module's config and towers."""
        with mock.patch.multiple(dense, model_config=model_config,
                                 lm_weights=hybrid_weights):
            super().setup()

    def window(self, seconds: float) -> dict:
        """The dense cell's timed loop, with this backbone's model FLOPs
        (11 forward units an update, ``bench/work/hybrid_flops``)."""
        t = self.traffic
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one()
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        fwd = hybrid_flops.backbone_flops(self.cfg, t["batch"], t["seq"])
        return {"wall_s": wall, "updates": n,
                "update_tokens_per_s": n * t["batch"] * t["seq"] / wall,
                "model_flops": n * 11 * fwd, "attempted": n, "failed": 0}

    def traced(self, tracer) -> dict:
        """The dense cell's spans and kernel logs, and the SSD scan's
        calls (the forward entry point and the backward the autograd
        Function calls) and each Mamba-2 mixer (``models/ssm.ssm_block``)
        under the span ``ssm_mixer``; the sub-window's events reduced
        without ``BOOKKEEPING``."""
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ssd_scan as ssd
        from repro_torch.models import ssm
        out = super().traced(tracer)
        tracer.kernel_calls(kops, "ssd_scan", "ssd_scan", _ssd_work)
        tracer.kernel_calls(ssd, "ssd_scan_bwd", "ssd_scan_bwd",
                            _ssd_bwd_work)
        tracer.span_around(ssm, "ssm_block", "ssm_mixer")
        trace_lib.reduce_events = _op_linked(trace_lib.reduce_events)
        return out

    def reference_numbers(self, fp8: bool = False) -> dict:
        batches = make_batches(self.cfg, self.traffic, self.b_seed,
                               self.device)[:self.traffic["check_updates"]]
        return reference.run(self.cfg, self.w_seed, batches,
                             self.traffic["ref_rows"], self.device, fp8=fp8)


def _op_linked(reduce):
    """``reduce`` for the next reduction only (it puts ``reduce`` back
    first) over the events but ``BOOKKEEPING``."""
    def reduce_op_linked(events, window_s, calls):
        trace_lib.reduce_events = reduce
        return reduce([e for e in events if e.name not in BOOKKEEPING],
                      window_s, calls)
    return reduce_op_linked


def _ssd_work(x, dtA, B_, C_, *, chunk, initial_state=None):
    from bench.work import kernel_work
    states = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dtA, B_, C_))
    Bb, S, H, P = x.shape
    w = kernel_work.ssd_scan(Bb, S, H, P, B_.shape[-1], chunk, x.dtype,
                             initial_state=initial_state is not None,
                             states=states)
    return lambda: w


def _ssd_bwd_work(x, dtA, B_, C_, states, dy, dfinal=None, *, chunk=64):
    from bench.work import kernel_work
    Bb, S, H, P = x.shape
    w = kernel_work.ssd_scan_bwd(Bb, S, H, P, B_.shape[-1], chunk, x.dtype)
    return lambda: w
