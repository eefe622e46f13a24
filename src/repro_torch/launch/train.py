"""Training launcher of the port — config-driven via ``build_trainer``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --steps 20 --device cpu                   # smoke size, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --full --batch 1024 --capacity 65536      # full width, on the card

Counterpart of ``repro/launch/train.py``'s recsys branch for ``baidu-ctr``:
the hybrid trainer (k-step Adam on the dense tower, AdaGrad pushes into the
tables on the gather placement) through the online predict-then-train loop
``runtime.online.fit_online``, with the reference's defaults (n_pod 2, k 20,
``two_phase`` merge, sparse lr 0.5, initial accumulator 0.01).  ``--serve``
co-locates a ``CTRServer`` that scores a second request stream through the
engine's read-only lookup, draining after each step; the training
trajectory is the same as without it.  The final line has the reference's
form.

``--full`` selects the full model config (2e9 rows, which one card cannot
hold: pass ``--rows`` to cut the table, e.g. ``--rows 50000000``).

Flags of the reference that the port does not have yet raise, naming the
ROADMAP.md item that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--merge", default="two_phase",
                    choices=["flat", "two_phase", "bf16", "int8_ef"])
    ap.add_argument("--n-pod", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sparse-lr", type=float, default=0.5)
    ap.add_argument("--placement", default="gather",
                    choices=["gather", "routed", "cached"],
                    help="sparse pull/push backend ('gather' is ported)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="working-set bound per batch (0: arch default)")
    ap.add_argument("--rows", type=int, default=0,
                    help="cut the table to this many rows (0: the config's)")
    ap.add_argument("--serve", action="store_true",
                    help="co-locate a CTR serving tier with training")
    ap.add_argument("--serve-batch", type=int, default=64,
                    help="dynamic-batch size of the co-located server")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="full model config (the card)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    # the reference's flags the port does not have yet: they raise
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--store", default="host", choices=["host", "disk"])
    ap.add_argument("--cache-rows", type=int, default=0)
    ap.add_argument("--merge-delay", type=int, default=0)
    ap.add_argument("--strict-transfers", action="store_true")
    return ap


def _reject_unported(args) -> None:
    unported = [
        (args.prefetch, "--prefetch", "A5 (prefetch)"),
        (bool(args.ckpt_dir), "--ckpt-dir", "A3 (checkpointing)"),
        (args.store != "host", "--store disk", "A7 (SSD tier)"),
        (bool(args.cache_rows), "--cache-rows", "A4 (cached placement)"),
    ]
    for given, flag, item in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet; see ROADMAP.md queue {item}")
    if args.strict_transfers:
        raise NotImplementedError(
            "--strict-transfers is not honoured by the port: the dedup's "
            "torch.unique syncs the host every step (ROADMAP.md §C)")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    _reject_unported(args)

    from repro_torch import configs
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data import synthetic as S
    from repro_torch.runtime.factory import build_ctr_server, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import TrainerConfig

    spec = configs.get(args.arch)
    cfg = spec.smoke_cfg if args.smoke else spec.model_cfg
    if args.rows:
        cfg = dataclasses.replace(cfg, rows=args.rows)
    tcfg = TrainerConfig(
        n_pod=args.n_pod,
        kstep=KStepConfig(lr=args.lr, k=args.k, merge=args.merge),
        sparse=SparseAdagradConfig(lr=args.sparse_lr,
                                   initial_accumulator=0.01),
        placement=args.placement, capacity=args.capacity or None,
        merge_delay=args.merge_delay,
    )
    t0 = time.perf_counter()
    tr = build_trainer(args.arch, tcfg, model_cfg=cfg, device=args.device)
    gen = S.recsys_batches(cfg, batch=args.batch, seed=1)

    if args.serve:
        # co-located train + serve: the server reads the LIVE tables the
        # trainer writes, through the read-only lookup, and drains right
        # after each step lands, so rows trained at step t serve step t+1's
        # traffic and the training trajectory is unchanged
        srv = build_ctr_server(tr, max_batch=args.serve_batch)
        serve_gen = S.recsys_batches(cfg, batch=args.serve_batch, seed=2)
        loss = float("nan")
        for _ in range(args.steps):
            b = next(gen)
            srv.submit_batch(next(serve_gen))   # traffic lands mid-step
            loss = tr.train_step(b)
            srv.drain()                         # commit boundary
        s = srv.summary()
        print(f"final loss {float(loss):.6f} "
              f"served {int(s['served'])} qps {s['qps']:.1f} "
              f"p50 {s['p50'] * 1e3:.2f}ms p99 {s['p99'] * 1e3:.2f}ms "
              f"placement {args.placement} prefetch {args.prefetch} "
              f"({args.steps / (time.perf_counter() - t0):.2f} steps/s)")
        return

    hist, online_auc = fit_online(tr, gen, args.steps, window=20, log=print,
                                  strict_transfers=args.strict_transfers)
    loss = hist[-1]["loss"] if hist else float("nan")
    auc_s = f"online AUC {online_auc:.4f} " if online_auc is not None else ""
    print(f"final loss {float(loss):.6f} {auc_s}"
          f"placement {args.placement} prefetch {args.prefetch} "
          f"overflow_dropped {tr.overflow_dropped} "
          f"({args.steps / (time.perf_counter() - t0):.2f} steps/s)")


if __name__ == "__main__":
    main()
