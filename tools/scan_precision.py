#!/usr/bin/env python3
"""How far the bf16 SSD scan lies from the plain float32 computation
rounded once, at both SSM prefill shapes.

    python3 tools/scan_precision.py [--src DIR]

Inputs: for each of ``chip_smoke.SCAN_SHAPES`` (mamba2-130m's scan, B 8,
S 1024, 24 heads, P 64, N 128, chunk 256; zamba2-1.2b's, 64 heads, N 64),
x, B_ and C_ ~ 0.5 N(0, 1) drawn with numpy (seed 0) and rounded once
to bf16, dtA = -0.3 softplus(N(0, 1)) in float32 (the decays of
``chip_smoke.scan_inputs``). The reference is ``ssd_scan_ref``
on the card in float32 (TF32 off) over the same values upcast, rounded
once to bf16. On the card: the kernel on the bf16 operands, and the
kernel on the values upcast to float32, its output rounded once. One JSON
line each, for y and the final state apart, as ``flash_precision.py``
reports: the share of outputs whose bf16 value differs from the
reference's, the count beyond ``chip_smoke.scan_close``'s tolerance (1e-5
of the largest |ref| plus one bf16 step, 2**-7 of |ref|) and the max abs
error. ``--src`` names the ``src`` directory whose ``repro_torch`` runs
(default: this checkout's), so two versions of the kernel are compared
from one checkout. Needs a CUDA device.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inputs(B, S, H, P, N):
    """x, dtA, B_, C_ as float32 tensors on the CPU, x, B_ and C_ holding
    bf16 values."""
    import torch
    rng = np.random.default_rng(0)

    def bf16(shape):
        a = rng.standard_normal(shape, dtype=np.float32) * 0.5
        return torch.from_numpy(a).bfloat16().float()

    x = bf16((B, S, H, P))
    dtA = torch.from_numpy(
        -np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
        * np.float32(0.3))
    return x, dtA, bf16((B, S, H, N)), bf16((B, S, H, N))


def report(variant, part, got, want, **extra):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    beyond = diff > 1e-5 * float(want.abs().max()) + 2.0 ** -7 * want.abs()
    return {"variant": variant, "output": part, "outputs": got.numel(),
            "differ_share": float((got != want).float().mean()),
            "beyond_tolerance": int(beyond.sum()),
            "max_abs_err": float(diff.max()), **extra}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("scan_precision: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from device_profile import card_line
    from repro_torch.kernels import ssd_scan as ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    src = os.path.dirname(ssd.__file__)
    for arch, (B, S, H, P, N, L) in cs.SCAN_SHAPES.items():
        x, dtA, Bm, Cm = (a.cuda() for a in make_inputs(B, S, H, P, N))
        want = [t.bfloat16() for t in ssd.ssd_scan_ref(x, dtA, Bm, Cm,
                                                       chunk=L)]
        f32 = [t.bfloat16() for t in ssd.ssd_scan(x, dtA, Bm, Cm, chunk=L)]
        got = ssd.ssd_scan(x.bfloat16(), dtA, Bm.bfloat16(), Cm.bfloat16(),
                           chunk=L)
        head = {"arch": arch, "shape": [B, S, H, P, N, L], "card": card,
                "src": src}
        for part, g, f, w in zip(("y", "final_state"), got, f32, want):
            print(json.dumps(report(
                "bf16 kernel", part, g, w, **head,
                differ_from_f32_share=float((g != f).float().mean()))),
                flush=True)
            print(json.dumps(report("f32 kernel, rounded once", part, f, w,
                                    **head)), flush=True)
        del x, dtA, Bm, Cm, want, f32, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
