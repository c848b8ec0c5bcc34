"""host-transfer control: host values only, and a reasoned allow."""
import math

import torch


def step(x, n, cfg):
    rows = int(x.shape[0])
    k = int(math.ceil(n / 2))
    width = int(x.numel() // 4)
    on = bool(cfg.sanitize)
    # tracelint: allow[host-transfer] -- the end-of-run read, off the hot loop
    total = float(x.sum())
    return rows, k, width, on, total, len(torch.zeros(3))
