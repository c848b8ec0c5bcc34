"""LM training step and loop.

Counterpart of ``repro/train/trainer.py``. ``make_train_step`` returns
one step: the loss and its gradients by autograd through
``factory.loss_fn`` (the rmsnorm, flash attention and SSD scan kernels
and their backward kernels on the card, their plain versions on the
CPU), then
the optimizer's in-place update of the parameters and moments (the
analogue of the reference's donated buffers). Nothing in a step reads a
tensor back to the host: the metrics stay on the device, and
``train_loop`` converts the losses once, after its last step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.analysis.hlolint.contract import EntrypointContract
from repro_torch.configs.base import RunConfig
from repro_torch.models import factory
from repro_torch.train.optimizer import OptState, Optimizer, make_optimizer


# hlolint contract of the LM train step at the probe's reduced dense arch
# (float32 parameters, bf16 compute, remat): the parameters and the Adam
# moments updated in place, and a rmsnorm forward a norm (each layer's two
# run again under remat, and the final one), a backward a norm, a rope and
# a flash forward a layer (again under remat) and a backward of each a
# layer
HLOLINT_CONTRACTS = (
    EntrypointContract(
        name="lm_train_step", module=__name__, inplace=True,
        state=("params", "opt_state"), float_dtypes=("float32", "bfloat16"),
        launches={"rmsnorm": "4*layers+1", "rmsnorm_bwd": "2*layers+1",
                  "rope": "2*layers", "rope_bwd": "layers",
                  "flash_attention": "2*layers",
                  "flash_attention_bwd": "layers"}),
)


def dtype_of(name: str) -> torch.dtype:
    """A ``RunConfig`` dtype name -> torch dtype (the model kernels take
    float32 and bfloat16)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _optimizer(rc: RunConfig) -> Optimizer:
    return make_optimizer(rc.optimizer, rc.learning_rate,
                          weight_decay=rc.weight_decay,
                          grad_clip=rc.grad_clip)


def value_and_grad(rc: RunConfig, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              List[torch.Tensor]]:
    """``factory.loss_fn`` and its gradients: (loss, {"ce", "aux"},
    gradients in the order of ``tree_leaves(params)``; zeros for a leaf
    the loss does not reach, as JAX gives). The parameters' leaves must
    require grad (``init_train_state`` sets it)."""
    leaves = tree_leaves(params)
    loss, metrics = factory.loss_fn(params, batch, rc.model,
                                    dtype=dtype_of(rc.compute_dtype),
                                    remat=rc.remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


# hlolint: entrypoint[lm_train_step]
def make_train_step(rc: RunConfig, opt: Optional[Optimizer] = None
                    ) -> Callable:
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``metrics`` = {"ce", "aux", "loss"} device scalars;
    ``params`` and ``opt_state`` are updated in place and returned."""
    opt = opt or _optimizer(rc)

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = value_and_grad(rc, params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def init_train_state(rc: RunConfig, gen: torch.Generator,
                     opt: Optional[Optimizer] = None, device=None):
    """Random parameters from ``gen`` (on ``device``, the generator's
    unless given; ``meta`` builds the shapes only) in ``rc.param_dtype``,
    each leaf requiring grad, and the optimizer's zeroed state. ->
    (params, opt_state, opt)."""
    opt = opt or _optimizer(rc)
    params = factory.init_params(rc.model, gen,
                                 dtype=dtype_of(rc.param_dtype),
                                 device=device)
    params = tree_map(lambda p: p.requires_grad_(), params)
    return params, opt.init(params), opt


@dataclass
class TrainResult:
    losses: list
    steps_per_sec: float


def train_loop(rc: RunConfig, batches, *, steps: int,
               gen: Optional[torch.Generator] = None, device="cuda",
               callback=None) -> TrainResult:
    """Simple synchronous LM training loop over an iterable of batches
    (on ``device``; the card unless ``device="cpu"`` is given). The
    parameters come from ``gen`` (seed 0 on ``device`` when not given).
    The rate skips step 0 (first launches, cuBLAS handles): it starts
    after a synchronise behind step 0 and ends with one behind the last
    step. The losses stay device scalars until then."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state, opt = init_train_state(rc, gen)
    step_fn = make_train_step(rc, opt)
    losses = []
    t0 = None
    for i, batch in zip(range(steps), batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i == 0:
            _synchronize(dev)
            t0 = time.perf_counter()
        losses.append(metrics["loss"])
        if callback:
            callback(i, params, metrics)
    _synchronize(dev)
    dt = time.perf_counter() - (t0 or time.perf_counter())
    rate = (len(losses) - 1) / dt if dt > 0 and len(losses) > 1 else 0.0
    # tracelint: allow[host-transfer] -- once, after the timed loop
    losses = torch.stack(losses).tolist() if losses else []
    return TrainResult(losses=losses, steps_per_sec=rate)


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        # tracelint: allow[host-transfer] -- the timed window's two barriers
        torch.cuda.synchronize(dev)
