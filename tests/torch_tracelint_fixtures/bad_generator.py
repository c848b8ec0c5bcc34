"""generator fixture: global-RNG draws and a seed reused in one scope."""
import torch


def draws(x, seed):
    a = torch.randn((4,))
    b = torch.rand_like(x)
    x.normal_()
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 4, (2,))
    return a, b, g1, g2, c


def two_constants():
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    return g1, g2
