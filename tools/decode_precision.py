#!/usr/bin/env python3
"""How far bf16 decode attention lies from the plain float32 computation
rounded once, at qwen2-0.5b's decode_32k shape.

    python3 tools/decode_precision.py [--src DIR] [--seed N]

Inputs: q (8, 14, 64) and the caches (8, 32768, 2, 64), every slot
valid: standard normals drawn with numpy (``--seed``, default 0) and
rounded once to bf16. The reference is ``decode_attention_ref`` on the
CPU (float32), rounded once to bf16. On the card: the kernel on the bf16
operands, and the kernel on the same values upcast to float32, its
output rounded once. One JSON line each, as ``flash_precision.py``
reports: the share of outputs whose bf16 value differs from the
reference's, the count beyond the kernels' tolerance (1e-5 plus one bf16
step, 2**-7 of |ref|) and the max abs error. ``--src`` names the ``src``
directory whose ``repro_torch`` runs (default: this checkout's), so two
versions of the kernel are compared from one checkout. Needs a CUDA
device.
"""
import argparse
import json
import os
import sys

import numpy as np

B, S, H, KV, D = 8, 32_768, 14, 2, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_precision: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from device_profile import card_line
    from flash_precision import report
    from repro_torch.kernels import decode_attention as dec

    rng = np.random.default_rng(args.seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16)
               for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = torch.cat([dec.decode_attention_ref(q[b:b + 1], k[b:b + 1],
                                               v[b:b + 1], S)
                      for b in range(B)])
    card = card_line()
    qd, kd, vd = (a.cuda() for a in (q, k, v))
    vl = torch.tensor(S, dtype=torch.int32, device="cuda")
    f32 = dec.decode_attention(qd.float(), kd.float(), vd.float(), vl).to(
        torch.bfloat16).cpu()
    got = dec.decode_attention(qd, kd, vd, vl).cpu()
    src = os.path.dirname(dec.__file__)
    print(json.dumps(report(
        "bf16 kernel", got, want, card=card, src=src,
        differ_from_f32_share=float((got != f32).float().mean()))),
        flush=True)
    print(json.dumps(report("f32 kernel, rounded once", f32, want,
                            card=card, src=src)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
