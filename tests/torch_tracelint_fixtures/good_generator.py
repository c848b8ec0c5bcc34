"""generator control: every draw from an explicit generator, distinct
seeds, and one seed in each of two scopes."""
import torch


def draws(x, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.Generator().manual_seed(seed + 1)
    a = torch.randn((4,), generator=g)
    x.normal_(generator=h)
    return a, torch.randint(0, 4, (2,), generator=g)


def other_scope(seed):
    return torch.Generator().manual_seed(seed)
