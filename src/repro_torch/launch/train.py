"""Training launcher of the port — config-driven via ``build_trainer``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --steps 20 --device cpu                   # smoke size, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --full --batch 1024 --capacity 65536      # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --placement cached --cache-rows 512 --device cpu   # the cache tier
    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --store disk --spill-dir /tmp/pages --page-rows 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch baidu-ctr \\
        --prefetch --device cpu                   # the pull prefetch

Counterpart of ``repro/launch/train.py``'s recsys branch for ``baidu-ctr``,
``dlrm-mlperf``, ``din``, ``dien`` and ``two-tower-retrieval``:
the hybrid trainer (k-step Adam on the dense tower, AdaGrad pushes into the
tables) through the online predict-then-train loop
``runtime.online.fit_online``, with the reference's defaults (n_pod 2, k 20,
``two_phase`` merge, sparse lr 0.5, initial accumulator 0.01).  ``--serve``
co-locates a ``CTRServer`` that scores a second request stream through the
engine's read-only lookup, draining after each step; the training
trajectory is the same as without it.  The final line has the reference's
form.

Placements: ``gather`` (the table next to the model) and ``cached`` (the
paper's §2.3 hierarchy: the full table and its AdaGrad accumulator in host
memory, a device cache of ``--cache-rows`` rows, by default the capacity,
serving the Zipf-hot working set; the final line adds ``cache_hit_rate``
and ``evictions``, the serving line ``serve_hit_rate``).

``--store disk`` drops the cold tier one level (docs/storage.md): the full
table and accumulator live in row pages under ``--spill-dir``
(``--page-rows`` rows each) behind an in-RAM LRU page cache
(``--page-cache-pages``, 0: unbounded), with read-ahead and write-behind;
the engine stages each batch's rows out of it.  It works with ``gather``
and ``cached``, and trains bit for bit as ``--store host`` does.  The store
is synced and closed at the end.

``--full`` selects the full model config (2e9 rows, which one card cannot
hold: pass ``--rows`` to cut the table, e.g. ``--rows 50000000``).

``--arch dlrm-mlperf`` trains MLPerf's DLRM the same way (26 single-hot
tables, the dot interaction's CUDA kernels in both directions); with
``--rows N`` each of its 26 tables keeps at most N rows.

``--arch din``, ``--arch dien`` and ``--arch two-tower-retrieval`` train on
one item table (history and target ids; on the card the takes and the
history bag run as the bag's kernels); ``--rows N`` caps the item table
at N rows (``item_vocab``).  Two-tower's stream has no labels: it trains
without the online AUC.

``--arch qwen3-14b`` (and the other registered LMs: ``qwen2-7b``,
``granite-8b``) trains a ``DenseTrainer`` as the reference's launcher
does: ``lm_batches`` of ``max(n_pod * 4, 8)`` sequences of 64 tokens,
k-step Adam with ``--k``, ``--merge``, ``--lr`` and ``--merge-delay``,
and the final line ``final loss ... (... steps/s)``; the sparse and table
flags do not apply to it, and ``--rows`` raises.

``--arch gin-tu`` trains GIN on a ``DenseTrainer`` as the reference's
launcher does: the smoke (or ``--full``) config with ``d_in`` 32 and 5
classes, full-graph node classification on a ``community_graph`` of 2000
nodes (average degree 8) stacked once per pod, ``--steps`` steps, and the
final line ``final loss ... (... steps/s)``.  On the card its message
passing runs as the bag's kernels.

``--prefetch`` turns on the double-buffered pull prefetch (the paper's
Fig. 5): each batch's pull is issued before the predict/train pair, so on
the card its dedup runs on a side stream while the previous step still
runs, and on the DiskStore its read-ahead starts before the previous
step's rows are absorbed; the results are bit-identical.  A
``DenseTrainer`` arch (an LM, GIN) rejects it, as in the reference.

``--ckpt-dir DIR`` checkpoints every ``--ckpt-every`` steps (the
reference's layout, written by a background thread) and, in every branch,
resumes from the newest complete checkpoint in ``DIR`` before the loop
(printing ``resumed at step N``): a stopped run restarted with the same
command line goes on from there.

``--strict-transfers``, which the port does not honour, raises
(ROADMAP.md §C), as do ``--placement routed`` (queue A8).
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
                    help="sparse pull/push backend ('gather' and 'cached' "
                         "are ported)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="working-set bound per batch (0: arch default)")
    ap.add_argument("--rows", type=int, default=0,
                    help="cut the table to this many rows, or each table "
                         "to at most this many (DLRM), or the item table to "
                         "at most this many (DIN, DIEN, two-tower) (0: the "
                         "config's)")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="device cache rows for --placement cached "
                         "(0: the capacity)")
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
    ap.add_argument("--store", default="host", choices=["host", "disk"],
                    help="cold tier below the device cache: 'host' keeps "
                         "the full tables resident (default); 'disk' pages "
                         "them to --spill-dir")
    ap.add_argument("--spill-dir", default="",
                    help="DiskStore page directory (required for --store "
                         "disk)")
    ap.add_argument("--page-rows", type=int, default=0,
                    help="rows per page for --store disk (0: 1024)")
    ap.add_argument("--page-cache-pages", type=int, default=0,
                    help="in-RAM page-cache budget for --store disk "
                         "(0: unbounded)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: resume from its newest "
                         "checkpoint, save every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--merge-delay", type=int, default=0)
    ap.add_argument("--prefetch", action="store_true",
                    help="double-buffered pull prefetch: issue the next "
                         "batch's pull while the current step runs")
    # the reference's flag the port does not honour: it raises
    ap.add_argument("--strict-transfers", action="store_true")
    return ap


def _reject_unported(args) -> None:
    if args.strict_transfers:
        raise NotImplementedError(
            "--strict-transfers is not honoured by the port: the dedup's "
            "torch.unique syncs the host every step (ROADMAP.md §C)")


def model_config(args):
    """The model config ``args`` select: the arch's smoke or full config,
    its table cut to ``--rows`` rows (DLRM: each of its tables to at most
    ``--rows``; DIN, DIEN and two-tower: the item table, ``item_vocab``, to
    at most ``--rows``)."""
    from repro_torch import configs

    spec = configs.get(args.arch)
    cfg = spec.smoke_cfg if args.smoke else spec.model_cfg
    if not args.rows:
        return cfg
    if hasattr(cfg, "item_vocab"):
        if args.rows < 64:
            # the streams split the items into up to 64 interest clusters
            raise ValueError(f"--rows {args.rows}: the item table needs at "
                             "least 64 rows (one per interest cluster)")
        return dataclasses.replace(cfg,
                                   item_vocab=min(cfg.item_vocab, args.rows))
    rows = (tuple(min(r, args.rows) for r in cfg.rows)
            if isinstance(cfg.rows, tuple) else args.rows)
    return dataclasses.replace(cfg, rows=rows)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    _reject_unported(args)

    from repro_torch import configs
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data import synthetic as S
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    family = configs.get(args.arch).family
    if family != "recsys" and args.rows:
        raise ValueError(f"--rows cuts embedding tables; a {family} model "
                         "has none")
    cfg = model_config(args)
    if family == "gnn":
        cfg = dataclasses.replace(cfg, d_in=32, n_classes=5)
    tcfg = TrainerConfig(
        n_pod=args.n_pod,
        kstep=KStepConfig(lr=args.lr, k=args.k, merge=args.merge),
        sparse=SparseAdagradConfig(lr=args.sparse_lr,
                                   initial_accumulator=0.01),
        placement=args.placement, capacity=args.capacity or None,
        cache_rows=args.cache_rows or None, prefetch=args.prefetch,
        merge_delay=args.merge_delay,
        store=args.store, spill_dir=args.spill_dir or None,
        page_rows=args.page_rows or None,
        page_cache_pages=args.page_cache_pages or None,
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
    )
    t0 = time.perf_counter()
    tr = build_trainer(args.arch, tcfg, model_cfg=cfg, device=args.device)
    if args.ckpt_dir and tr.resume():
        print(f"resumed at step {tr.step_num}")
    if family == "gnn":
        print(f"final loss {_run_gnn(args, tr):.4f} "
              f"({tr.step_num / (time.perf_counter() - t0):.2f} steps/s)")
        return
    if family == "lm":
        gen = S.lm_batches(seed=0, batch=max(args.n_pod * 4, 8), seq_len=64,
                           vocab=cfg.vocab)
        hist = tr.fit(gen, args.steps)
        final = (f"{hist[-1]['loss']:.4f}" if hist
                 else "n/a (steps < log_every)")
        print(f"final loss {final} "
              f"({tr.step_num / (time.perf_counter() - t0):.2f} steps/s)")
        return
    gen = S.recsys_batches(cfg, batch=args.batch, seed=1)

    try:
        _run(args, tr, cfg, gen, t0)
    finally:
        tr.close()


def _run_gnn(args, tr) -> float:
    """GIN's full-graph loop (the reference launcher's GNN branch): one
    ``community_graph`` stacked once per pod, ``--steps`` steps; returns
    the last loss (0.0 after no step)."""
    import numpy as np

    from repro_torch.data import synthetic as S

    g = S.community_graph(seed=0, n_nodes=2000, avg_degree=8, d_feat=32,
                          n_classes=5)
    batch = {k: np.stack([v] * args.n_pod) for k, v in
             [("x", g.x), ("edge_src", g.edge_src),
              ("edge_dst", g.edge_dst), ("labels", g.labels)]}
    loss = 0.0
    for _ in range(args.steps):
        loss = tr.train_step(batch, podded=True)
    if tr.ckpt:
        tr.ckpt.wait()   # the async writer must land the final checkpoint
    return float(loss)


def _run(args, tr, cfg, gen, t0):
    """The training loop (with ``--serve`` the co-located one) and its
    final line."""
    from repro_torch.data import synthetic as S
    from repro_torch.runtime.factory import build_ctr_server
    from repro_torch.runtime.online import fit_online

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
            if args.prefetch:
                tr.prefetch(b)
            srv.submit_batch(next(serve_gen))   # traffic lands mid-step
            loss = tr.train_step(b)
            srv.drain()                         # commit boundary
        s = srv.summary()
        hit = (f"serve_hit_rate {s['serve_hit_rate']:.3f} "
               if "serve_hit_rate" in s else "")
        print(f"final loss {float(loss):.6f} "
              f"served {int(s['served'])} qps {s['qps']:.1f} "
              f"p50 {s['p50'] * 1e3:.2f}ms p99 {s['p99'] * 1e3:.2f}ms {hit}"
              f"placement {args.placement} prefetch {args.prefetch} "
              f"({args.steps / (time.perf_counter() - t0):.2f} steps/s)")
        return

    hist, online_auc = fit_online(tr, gen, args.steps, window=20, log=print,
                                  strict_transfers=args.strict_transfers)
    loss = hist[-1]["loss"] if hist else float("nan")
    stats = tr.sparse_metrics()
    cache = (
        f"cache_hit_rate {stats['cache_hit_rate_total']:.3f} "
        f"evictions {stats['evictions_total']} "
        if "cache_hit_rate_total" in stats else ""
    )
    auc_s = f"online AUC {online_auc:.4f} " if online_auc is not None else ""
    print(f"final loss {float(loss):.6f} {auc_s}"
          f"placement {args.placement} prefetch {args.prefetch} "
          f"overflow_dropped {tr.overflow_dropped} {cache}"
          f"({args.steps / (time.perf_counter() - t0):.2f} steps/s)")


if __name__ == "__main__":
    main()