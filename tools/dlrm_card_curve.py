#!/usr/bin/env python3
"""Train the port's dlrm-mlperf on the card at the published widths and
print its loss curve, optionally beside the JAX reference's from the same
state.

    python3 tools/dlrm_card_curve.py --state ref.npz
    python3 tools/dlrm_card_curve.py --rows 8000000 --batch 65536 \\
        --steps 40 [--sparse-lr 0.5] [--grad-clip 0]

``--state``: an ``.npz`` that ``tests/fullwidth_parity.py --arch
dlrm-mlperf --export`` wrote on a machine with JAX: the reference
trainer's initial dense towers and tables, its tables' row counts, batch,
sparse learning rate and per-step losses.  The port starts from that state
(``repro_torch.interop.from_reference``; the accumulators are the initial
0.01), takes the same batches (``recsys_batches(seed=1)``, byte-identical
in the two packages) and prints both curves step by step with their
relative difference.  Without ``--state`` the port starts from
``build_trainer``'s seed-0 state with each table capped at ``--rows``.

Both use the launcher's training settings (n_pod 2, k 20, two_phase, dense
lr 1e-3, initial accumulator 0.01), capacity the batch rounded up to a
power of two (a single-hot table cannot overflow it), the sparse learning
rate of the state (else ``--sparse-lr``) and ``--grad-clip`` (the k-step
config's global-norm clip, 0: off).  Each step is scored first, as
``fit_online`` does; the last line gives the online AUC over the last 20
scored batches.  Run from the root of a checkout; needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _state_from(z):
    """(dense tree, tables, accum) of an exported reference state."""
    dense = {}
    for key in sorted(k for k in z.files if k.startswith("dense/")):
        _, tower, i, name = key.split("/")
        layers = dense.setdefault(tower, [])
        while len(layers) <= int(i):
            layers.append({})
        layers[int(i)][name] = z[key]
    tables = {k[len("table/"):]: z[k] for k in z.files
              if k.startswith("table/")}
    accum = {n: np.full(t.shape, 0.01, np.float32) for n, t in tables.items()}
    return dense, tables, accum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="")
    ap.add_argument("--rows", type=int, default=8_000_000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--sparse-lr", type=float, default=0.5)
    ap.add_argument("--grad-clip", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("dlrm_card_curve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.interop import from_reference
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_dlrm_engine, build_trainer
    from repro_torch.runtime.metrics import StreamingAUC
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    want = None
    if args.state:
        z = np.load(args.state)
        rows = tuple(int(r) for r in z["rows"])
        batch, sparse_lr = int(z["batch"]), float(z["sparse_lr"])
        want = z["losses"]
        steps = len(want)
    else:
        rows = tuple(min(r, args.rows) for r in dlrm_mlperf.MODEL.rows)
        batch, sparse_lr, steps = args.batch, args.sparse_lr, args.steps
    mcfg = dataclasses.replace(dlrm_mlperf.MODEL, rows=rows)
    tcfg = TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase",
                                   grad_clip=args.grad_clip),
        sparse=SparseAdagradConfig(lr=sparse_lr, initial_accumulator=0.01),
        placement="gather", capacity=1 << (batch - 1).bit_length(),
        log_every=10)
    if args.state:
        state = from_reference(*_state_from(z), device="cuda")
        tr = HybridTrainer(None, build_dlrm_engine(mcfg, tcfg, device="cuda"),
                           R.dlrm_embed_from_workings(mcfg),
                           R.dlrm_hybrid_loss(mcfg), tcfg, state=state,
                           device="cuda")
    else:
        tr = build_trainer("dlrm-mlperf", tcfg, smoke=False, model_cfg=mcfg,
                           seed=0, device="cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"dlrm-mlperf at the published widths, {sum(rows)} rows in 26 "
          f"tables (each at most {max(rows)}), batch {batch}, sparse lr "
          f"{sparse_lr}, grad clip {args.grad_clip}, {steps} steps; "
          + ("from the reference's state" if args.state else "seed 0"))
    meter = StreamingAUC(window=20)
    stream = recsys_batches(mcfg, batch=batch, seed=1)
    got = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        b = next(stream)
        meter.update(b["label"], tr.predict(b))
        got.append(float(tr.train_step(b)))
        line = f"step {step:3d}  card {got[-1]:.6f}"
        if want is not None:
            rel = abs(got[-1] - want[step - 1]) / abs(want[step - 1])
            line += f"  reference {want[step - 1]:.6f}  rel {rel:.3g}"
        print(line, flush=True)
    bad = [i + 1 for i, x in enumerate(got) if not np.isfinite(x)]
    print(f"{steps} steps in {time.perf_counter() - t0:.1f} s; first "
          f"non-finite loss at step {bad[0] if bad else 'none'}; online AUC "
          f"{meter.value():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
