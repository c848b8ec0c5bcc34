#!/usr/bin/env python3
"""How far bf16 flash attention lies from the plain float32 computation
rounded once, at the serving prefill's shape.

    python3 tools/flash_precision.py              # the kernels, on the card
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/flash_precision.py \\
        --emulate                                 # the CPU emulation

Inputs: q (8, 1024, 14, 64) and k, v (8, 1024, 2, 64), qwen2-0.5b's
prefill, causal: standard normals drawn with numpy (``--seed``, default
0) and rounded once to bf16, so both modes see the same bits. The
reference is ``attention_ref`` on the CPU (float32, rounded once to
bf16). One JSON line a variant: the share of outputs whose bf16 value
differs from the reference's, the count beyond the kernels' tolerance
(1e-5 plus one bf16 step, 2**-7 of |ref|), and the max abs error.

On the card the variants are ``flash_tc_kernel`` (the bf16 operands'
kernel) and the float32 SIMT kernel on the same values upcast, its
output rounded once to bf16 (the arithmetic of the bf16 path before the
tensor-core kernel); the first also gives its share of outputs that
differ from the second. ``--emulate`` runs, on the CPU, the emulation of
the tensor-core kernel's arithmetic that
``tests/test_torch_model_kernels.py`` keeps, with P V as hi + lo (the
kernel's), as one bf16 p, and with p whole; it imports that test file,
so it needs the JAX test environment.
"""
import argparse
import json
import os
import sys

import numpy as np

B, S, H, KV, D = 8, 1024, 14, 2, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inputs(seed):
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(torch.bfloat16)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]


def per_batch(fn, q, k, v):
    """``fn`` one batch row at a time (the CPU's memory stays small)."""
    import torch
    return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1])
                      for b in range(q.shape[0])])


def report(variant, got, want, **extra):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    beyond = diff > 1e-5 + 2.0 ** -7 * want.abs()
    return {"variant": variant, "outputs": got.numel(),
            "differ_share": float((got != want).float().mean()),
            "beyond_tolerance": int(beyond.sum()),
            "max_abs_err": float(diff.max()), **extra}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emulate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import flash_attention as fa

    q, k, v = make_inputs(args.seed)
    want = per_batch(fa.attention_ref, q, k, v)
    if args.emulate:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from test_torch_model_kernels import emulate_tensor_core_flash
        for parts in ("hi_lo", "bf16", "f32"):
            got = per_batch(lambda *a: emulate_tensor_core_flash(*a, parts),
                            q, k, v)
            print(json.dumps(report(f"cpu emulation, p as {parts}", got,
                                    want)), flush=True)
        return 0

    if not torch.cuda.is_available():
        sys.exit("flash_precision: no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from device_profile import card_line
    card = card_line()
    qd, kd, vd = (a.cuda() for a in (q, k, v))
    simt = fa.flash_attention(qd.float(), kd.float(), vd.float()).to(
        torch.bfloat16).cpu()
    tc = fa.flash_attention(qd, kd, vd).cpu()
    print(json.dumps(report(
        "flash_tc_kernel", tc, want, card=card,
        differ_from_simt_share=float((tc != simt).float().mean()))),
        flush=True)
    print(json.dumps(report("simt f32, rounded once", simt, want,
                            card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
