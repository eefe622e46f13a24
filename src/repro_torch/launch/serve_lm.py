"""Batched LM serving: continuous batching with slot refill + KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-14b \\
        --requests 12 --slots 4 --max-new 24 --device cpu   # smoke, the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-14b \\
        --full --slots 8 --max-len 32768                    # full, the card

The port's counterpart of ``examples/serve_lm.py``.  Trains nothing: draws
a randomly-initialized model of the arch (its smoke config, or the
published one with ``--full``) from seed 0 on ``--device``, submits a queue
of prompt requests and decodes them with the ``BatchedServer``, reporting
tokens/s in the example's two lines.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.serve import BatchedServer, Request


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the smoke config)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    spec = configs.get(args.arch)
    if spec.family != "lm":
        raise ValueError(f"--arch {args.arch!r} is not an LM")
    cfg = spec.model_cfg if args.full else spec.smoke_cfg
    params = T.init_params(torch.Generator(device).manual_seed(0), cfg,
                           device=device)
    srv = BatchedServer(params, cfg, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, rng.integers(3, 10))
        srv.submit(Request(prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    stats = srv.run_to_completion()
    wall = time.perf_counter() - t0
    print(f"arch={args.arch} ({'full' if args.full else 'smoke'} config), "
          f"slots={args.slots}")
    print(f"decoded {stats['decoded_tokens']} tokens in {wall:.2f}s "
          f"({stats['decoded_tokens'] / wall:.1f} tok/s, "
          f"{stats['steps']} decode steps)")
    return stats


if __name__ == "__main__":
    main()
