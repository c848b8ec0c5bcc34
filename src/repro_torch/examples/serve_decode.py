"""Batched serving example: prefill + greedy decode on a reduced arch, on
the chosen device (the hand-written kernels on the card) and on the CPU
(their plain versions), asserting that they agree. Counterpart of
``examples/serve_decode.py``, whose two paths were the XLA oracle and
the Pallas kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
          [--arch qwen2-0.5b] [--device cuda]

Any registered architecture (``repro_torch.configs.ARCHS``), reduced, at
float32 compute, random weights from seed 0. Exits non-zero when the
tokens differ.
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import card_line, resolve_device
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve.engine import greedy_generate, prefix_len

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    shape = InputShape("serve", seq_len=args.prompt_len + prefix_len(cfg),
                       global_batch=args.batch, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(1))

    toks = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        toks[where.type] = greedy_generate(
            rc, tree_map(lambda a: a.to(where), params),
            tree_map(lambda a: a.to(where), batch), args.prompt_len,
            args.gen).cpu()
        print(f"{where.type:4s}: {tuple(toks[where.type].shape)} tokens in "
              f"{time.perf_counter() - t0:.2f}s")
    print(card_line(dev))
    agree = torch.equal(toks[dev.type], toks["cpu"])
    print(f"greedy tokens identical across devices: {agree}")
    print(toks["cpu"])
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
