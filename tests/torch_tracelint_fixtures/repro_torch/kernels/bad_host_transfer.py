"""host-transfer fixture: every way a hot module reads a device value on
the host. Lives under repro_torch/kernels/ so the hot-module rule
applies."""
import numpy as np
import torch


def step(x, flag, ev):
    a = x.sum().item()
    b = x.tolist()
    c = x.cpu()
    d = float(x.mean())
    e = int(x.argmax())
    if bool(flag):
        pass
    torch.cuda.synchronize()
    ev.synchronize()
    f = np.asarray(x)
    return a, b, c, d, e, f
