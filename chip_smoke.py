#!/usr/bin/env python3
"""Run the PyTorch port's baidu-ctr serving and training paths on one
NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and the script exits non-zero):
  1. kernels: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (into ``build/torch_kernels/``), then holds each kernel against its
     plain PyTorch version on the card.
     - The bag: at the serving path's shapes (working set 65537 x 64,
       102400 ids, 40960 bags), at small odd shapes with empty bags, with
       the sum/mean/sqrtn combiners and their gradients.  Forward within
       rtol = atol = 1e-5; two runs bit-equal.
     - The bag's backward: at the training path's per-pod shapes (51200
       ids, 20480 bags) and the small odd shapes.  Working-row gradients
       bit-equal to the CPU plain vjp, weight gradients within
       rtol = atol = 1e-5, two runs bit-equal.
     - The push: the slice's uid layout (one batch deduplicated at
       capacity 65536, with its pads), odd widths, an overflowed batch (no
       pads), and the slice batch on a 50 M-row table (uids above
       2^31 / 64).  Bit-equal to the plain version, two runs bit-equal,
       untouched rows unchanged.
     Times each kernel, its plain version and one PyTorch library call.
  2. serving: ``build_trainer`` at the full width of baidu-ctr (embed 64, 40
     fields, 100 ids per instance, MLP 512-256-1, f32) with the table cut to
     50 M rows, capacity 65536, then ``build_ctr_server(max_batch=1024)``:
     4 full batches and a 300-request tail.  The launch counts show that
     the bag ran as the CUDA kernel and never as the plain version; the
     table and accumulator checksums show that serving wrote nothing.
  3. training: ``fit_online`` for 40 steps at the same width (n_pod 2,
     k 20, two_phase, sparse lr 0.5, initial accumulator 0.01), batch 1024.
     Finite losses, no overflow, launch counts per step (bag 1 + n_pod,
     backward n_pod, push 1, plain versions 0), rows outside every batch
     unchanged; the step's device time by part.
  4. co-located serving changes nothing: 10 full-width steps twice, the
     second with a ``CTRServer`` draining between steps; per-step losses
     and the final state's checksums bit-equal.
  5. quickstart: ``examples/quickstart.py``'s configuration through the
     port, online AUC > 0.72.
  6. agreement: serving (3 request batches) and 6 training steps at smoke
     size on the card and on the CPU from one state; scores within
     rtol = atol = 1e-5, losses and final parameters within rtol = 1e-4,
     atol = 1e-6 (the CPU parity tests' tolerance).

TF32 is off for matmuls and convolutions.  Prints the card (``nvidia-smi``
name and power limit), a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ROWS = 50_000_000          # baidu-ctr's 2e9 rows cut to fit one card
CAPACITY = 65536           # > the ~34 k distinct ids of a 1024 x 100 batch
BATCH = 1024               # SHAPES["serve_online"]
TAIL = 300
TOL = dict(rtol=1e-5, atol=1e-5)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 without tensor
# cores.  They assume the 700 W limit; the printed power limit says more.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _time_ms(fn, iters=100, warmup=10):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bag_case(gen, C, D, nnz, num_bags, weighted, device):
    """Working set (C + 1, D) with a zero drop row, unsorted seg that leaves
    about a third of the bags empty, a few ids on the drop row."""
    import torch

    working = torch.randn((C + 1, D), generator=gen, device=device)
    working[C] = 0
    inv = torch.randint(0, C, (nnz,), generator=gen, device=device,
                        dtype=torch.int32)
    inv[torch.rand(nnz, generator=gen, device=device) < 0.05] = C
    used = torch.randperm(num_bags, generator=gen, device=device)
    used = used[:max(1, 2 * num_bags // 3)]
    pick = torch.randint(0, used.numel(), (nnz,), generator=gen, device=device)
    seg = used[pick].to(torch.int32)
    w = None
    if weighted:
        w = (torch.rand(nnz, generator=gen, device=device) < 0.9).float()
    return working, inv, seg, w


def _slice_case(device):
    """The serving path's bag inputs for the first request batch: ids
    deduplicated at capacity 65536, seg as recsys builds it
    (instance * n_fields + field), mask weights, and 1 % of the ids moved
    to the drop row."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.core.embedding_backend import _dedup
    from repro_torch.data.synthetic import ctr_batches

    cfg = baidu_ctr.MODEL
    b = next(ctr_batches(seed=2, batch=BATCH, rows=ROWS))
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    _, inv, _ = _dedup(ids, CAPACITY)
    gen = torch.Generator(device).manual_seed(11)
    inv[torch.rand(inv.numel(), generator=gen, device=device) < 0.01] = CAPACITY
    inst = torch.arange(BATCH, dtype=torch.int32, device=device)[:, None]
    seg = (inst * cfg.n_fields
           + torch.from_numpy(b["field_ids"]).to(device)).reshape(-1)
    w = torch.from_numpy(b["mask"]).to(device).reshape(-1)
    working = torch.randn((CAPACITY + 1, cfg.embed_dim), generator=gen,
                          device=device)
    working[CAPACITY] = 0
    return working, inv, seg.contiguous(), w, BATCH * cfg.n_fields


def phase_kernels(device):
    """Each kernel against its plain version; returns the kernels-line entry
    (without ``launches``, which the slice phase fills)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ops, ref

    max_err = 0.0

    def check(name, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        max_err = max(max_err, err)
        if not torch.allclose(got, want, **TOL):
            raise AssertionError(f"{name}: kernel and plain version differ, "
                                 f"max |diff| {err}")
        return err

    def bag_checks(name, working, inv, seg, w, num_bags):
        out = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
        torch.cuda.synchronize()
        again = kb.embedding_bag_cuda(working, inv, seg, w, num_bags)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        err = check(name, out, ref.embedding_bag_ref(working, inv, seg, w,
                                                     num_bags))
        cpu = ref.embedding_bag_ref(working.cpu(), inv.cpu(), seg.cpu(),
                                    None if w is None else w.cpu(), num_bags)
        same = torch.equal(out.cpu(), cpu)
        print(f"  {name}: max|kernel - plain| {err:.3g}, "
              f"bit-equal to the CPU plain version: {same}")

    t0 = time.perf_counter()
    build.extension()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(build.SOURCES)} into "
          f"{build.BUILD_DIR.relative_to(ROOT)})")

    working, inv, seg, w, num_bags = _slice_case(device)
    print(f"phase 1: embedding_bag against its plain version "
          f"(working {tuple(working.shape)}, nnz {inv.numel()}, "
          f"bags {num_bags})")
    bag_checks("slice shape, mask weights", working, inv, seg, w, num_bags)
    bag_checks("slice shape, unweighted", working, inv, seg, None, num_bags)

    gen = torch.Generator(device).manual_seed(5)
    for C, D, nnz, nb in [(37, 24, 101, 53), (200, 16, 333, 97),
                          (90, 100, 257, 40), (64, 200, 150, 31)]:
        for weighted in (True, False):
            case = _bag_case(gen, C, D, nnz, nb, weighted, device)
            bag_checks(f"C={C} D={D} nnz={nnz} bags={nb} "
                       f"weighted={weighted}", *case, nb)

    for combiner in ("sum", "mean", "sqrtn"):
        wk, inv_c, seg_c, w_c = _bag_case(gen, 500, 64, 2000, 300, True,
                                          device)
        g = torch.randn((300, 64), generator=gen, device=device)
        grads = []
        for fn in (ops.embedding_bag_working, ref.embedding_bag_combiner_ref):
            x = wk.clone().requires_grad_(True)
            y = w_c.clone().requires_grad_(True)
            out = fn(x, inv_c, seg_c, y, 300, combiner)
            (out * g).sum().backward()
            grads.append((out.detach(), x.grad, y.grad))
        for what, a, b in zip(("forward", "grad working", "grad weights"),
                              *grads):
            check(f"{combiner} {what}", a, b)
        print(f"  combiner {combiner}: forward and gradients agree")

    # ---- times at the slice's shapes
    order, offsets = kb.csr_from_segments(seg, num_bags)
    ms = _time_ms(lambda: kb.embedding_bag_cuda(working, inv, seg, w,
                                                num_bags))
    launch_ms = _time_ms(lambda: kb.launch(working, inv, w, order, offsets,
                                           num_bags))
    prep_ms = _time_ms(lambda: kb.csr_from_segments(seg, num_bags))
    plain_ms = _time_ms(lambda: ref.embedding_bag_ref(working, inv, seg, w,
                                                      num_bags))
    seg64 = seg.long()

    def library():
        return torch.zeros((num_bags, working.shape[1]),
                           device=device).index_add_(
            0, seg64, working[inv.long()] * w[:, None])

    library_ms = _time_ms(library)
    check("library call", library(), ref.embedding_bag_ref(
        working, inv, seg, w, num_bags))

    D = working.shape[1]
    rows_read = torch.unique(inv).numel()
    nbytes = (rows_read * D * 4 + inv.numel() * (4 + 4 + 4)
              + num_bags * D * 4)
    flops = 2 * inv.numel() * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    print(f"  times (ms): wrapper {ms:.4f} (kernel launch alone "
          f"{launch_ms:.4f}, index preparation alone {prep_ms:.4f}), plain "
          f"{plain_ms:.4f}, index_add_ library call {library_ms:.4f}; bound "
          f"{bound_ms:.4f} ({nbytes / 1e6:.2f} MB: {rows_read} distinct rows "
          f"read, {flops / 1e6:.1f} MFLOP)")
    return {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:102",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def phase_slice(device):
    """The serving path at full width; returns the launch counts of the
    timed run."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.kernels import ops
    from repro_torch.runtime.factory import build_ctr_server, build_trainer
    from repro_torch.runtime.metrics import auc
    from repro_torch.runtime.trainer import TrainerConfig

    mcfg = dataclasses.replace(baidu_ctr.MODEL, rows=ROWS)
    t0 = time.perf_counter()
    tr = build_trainer(
        "baidu-ctr",
        TrainerConfig(placement="gather", store="host", capacity=CAPACITY),
        smoke=False, model_cfg=mcfg, seed=0, device=device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in
                   list(tr.tables.values())
                   + list(tr.sparse_state.accum.values())) / 1e9
    print(f"phase 2: baidu-ctr serving, rows {ROWS}, capacity "
          f"{tr.engine.capacity}, batch {BATCH}; trainer built in "
          f"{time.perf_counter() - t0:.1f} s, table + accumulator "
          f"{state_gb:.1f} GB on the card")
    if tr.engine.capacity != CAPACITY:
        raise AssertionError(f"capacity {tr.engine.capacity}, not {CAPACITY}")

    warm = build_ctr_server(tr, max_batch=BATCH)
    warm.submit_batch(next(ctr_batches(seed=1, batch=BATCH, rows=ROWS)))
    warm.drain()

    stream = ctr_batches(seed=2, batch=BATCH, rows=ROWS)
    batches = [next(stream) for _ in range(5)]
    batches[-1] = {k: v[:TAIL] for k, v in batches[-1].items()}
    distinct = [int(np.unique(b["ids"]).size) for b in batches]
    before = tr.serve_metrics()
    sums = _checksum(tr)
    server = build_ctr_server(tr, max_batch=BATCH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for b in batches:
        server.submit_batch(b)
    reqs = list(server.pending)
    server.drain()
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    after = tr.serve_metrics()
    summ = server.summary()
    scores = np.array([r.score for r in reqs])
    labels = np.concatenate([b["label"] for b in batches])
    n_sub = 4 * BATCH + TAIL
    scored = after["serve_requests"] - before["serve_requests"]
    slots = scored * baidu_ctr.MODEL.nnz_per_instance
    dropped = slots - (after["serve_lookups"] - before["serve_lookups"])
    if len(reqs) != n_sub or summ["served"] != n_sub:
        raise AssertionError(f"served {summ['served']} of {n_sub} requests")
    if scored != 5 * BATCH:       # predict counts tail pads, as the reference
        raise AssertionError(f"serve_requests moved by {scored}, "
                             f"expected {5 * BATCH}")
    if not (np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all()):
        raise AssertionError("a score is not a finite value in (0, 1)")
    if launches["embedding_bag"] < 1 or launches["embedding_bag_ref"] != 0:
        raise AssertionError(f"the bag did not run as its kernel: {launches}")
    if _checksum(tr) != sums:
        raise AssertionError("serving changed the table or the accumulator")
    print(f"  requests {n_sub} in {int(summ['steps'])} predicts; qps "
          f"{summ['qps']:.1f}, p50 {summ['p50'] * 1e3:.2f} ms, p99 "
          f"{summ['p99'] * 1e3:.2f} ms, predict wall "
          f"{summ['wall_s'] / summ['steps'] * 1e3:.2f} ms each")
    print(f"  AUC on the labels {auc(labels, scores):.4f} (random weights); "
          f"ids dropped by capacity {dropped:.0f}; distinct ids per batch "
          f"{distinct}; peak device memory {peak_gb:.2f} GB")
    print(f"  launches during the run: {launches}")
    _breakdown(tr, batches[0])
    return launches


def _checksum(tr):
    """Integer sums of the bits of the table and the accumulator, in chunks
    of 2^20 rows (a lookup must leave both untouched)."""
    import torch

    return [sum(int(c.view(torch.int32).to(torch.int64).sum())
                for c in t.split(1 << 20))
            for t in list(tr.tables.values())
            + list(tr.sparse_state.accum.values())]


def _breakdown(tr, batch):
    """Device time of one predict's parts (CUDA events; outside the counted
    run)."""
    import torch

    from repro_torch.runtime.trainer import pod_slice

    b = tr._stage(batch)
    eng = tr.engine
    with torch.inference_mode():
        wss, _ = eng.lookup_batch(tr.tables, tr.sparse_state.accum,
                                  tr.backend_state, b)
        workings = {n: ws.rows for n, ws in wss.items()}
        invs = {n: ws.inverse for n, ws in wss.items()}
        emb = tr._embed(workings, invs, b)
        dense0 = pod_slice(tr.dense, 0)
        parts = {
            "stage batch": lambda: tr._stage(batch),
            "lookup (dedup + gather)": lambda: eng.lookup_batch(
                tr.tables, tr.sparse_state.accum, tr.backend_state, b),
            "bags (CUDA kernel + index prep)": lambda: tr._embed(
                workings, invs, b),
            "attention + MLP + sigmoid": lambda: tr._loss(
                dense0, emb, b, predict=True),
            "whole predict": lambda: tr.predict(batch),
        }
        times = {k: _time_ms(fn, iters=20, warmup=3) for k, fn in parts.items()}
    print("  one predict, device time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))


def phase_agreement(device):
    """The port on the card and on the CPU, one state, same requests."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import (
        build_ctr_engine,
        build_ctr_server,
        build_trainer,
    )
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = baidu_ctr.SMOKE
    tcfg = TrainerConfig(placement="gather", capacity=256)
    gpu = build_trainer("baidu-ctr", tcfg, seed=3, device=device)
    state = ReferenceState(
        dense=tree_map(lambda x: x.cpu(), gpu.dense),
        tables={n: t.cpu() for n, t in gpu.tables.items()},
        accum={n: a.cpu() for n, a in gpu.sparse_state.accum.items()})
    cpu = HybridTrainer(None, build_ctr_engine(smoke, tcfg, device="cpu"),
                        R.ctr_embed_from_workings(smoke),
                        R.ctr_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    stream = ctr_batches(seed=4, batch=64, rows=smoke.rows,
                         n_fields=smoke.n_fields,
                         nnz=smoke.nnz_per_instance)
    batches = [next(stream) for _ in range(3)]
    got = []
    for tr in (gpu, cpu):
        server = build_ctr_server(tr, max_batch=64)
        for b in batches:
            server.submit_batch(b)
        reqs = list(server.pending)
        server.drain()
        got.append(np.array([r.score for r in reqs]))
    np.testing.assert_allclose(got[0], got[1], **TOL)
    print(f"phase 6: smoke-size serving, card vs CPU from one state: "
          f"{got[0].size} scores, max |diff| "
          f"{np.abs(got[0] - got[1]).max():.3g}")


def _train_batches(n, seed=1, batch=None):
    """The first ``n`` batches of the training stream (50 M-row ids)."""
    from repro_torch.data.synthetic import ctr_batches

    stream = ctr_batches(seed=seed, batch=batch or BATCH, rows=ROWS)
    return [next(stream) for _ in range(n)]


def _backward_slice_case(device):
    """The bag backward's inputs on the training path, pod 0 of n_pod 2:
    the first training batch deduplicated at capacity 65536, its first 512
    instances (51200 ids, 20480 bags), mask weights, a random cotangent."""
    import torch

    from repro_torch.configs import baidu_ctr
    from repro_torch.core.embedding_backend import _dedup

    cfg = baidu_ctr.MODEL
    b = _train_batches(1)[0]
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    _, inv, _ = _dedup(ids, CAPACITY)
    half = BATCH // 2
    nnz = half * cfg.nnz_per_instance
    inv = inv[:nnz].contiguous()
    inst = torch.arange(half, dtype=torch.int32, device=device)[:, None]
    seg = (inst * cfg.n_fields + torch.from_numpy(
        b["field_ids"][:half]).to(device)).reshape(-1).contiguous()
    w = torch.from_numpy(b["mask"][:half]).to(device).reshape(-1)
    gen = torch.Generator(device).manual_seed(21)
    working = torch.randn((CAPACITY + 1, cfg.embed_dim), generator=gen,
                          device=device)
    working[CAPACITY] = 0
    g = torch.randn((half * cfg.n_fields, cfg.embed_dim), generator=gen,
                    device=device) * 1e-3
    return g, working, inv, seg, w


def phase_backward(device):
    """The bag backward kernel against the plain vjp; returns its
    kernels-line entry (without ``launches``)."""
    import torch

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref

    max_err = 0.0

    def checks(name, g, working, inv, seg, w):
        nonlocal max_err
        need_w = w is not None
        got = kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                             need_w)
        again = kb.embedding_bag_backward_cuda(g, working, inv, seg, w, True,
                                               need_w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"backward {name}: two runs differ")
        cpu = ref.embedding_bag_backward_ref(
            g.cpu(), working.cpu(), inv.cpu(), seg.cpu(),
            None if w is None else w.cpu(), True, need_w)
        if not torch.equal(got[0].cpu(), cpu[0]):
            err = (got[0].cpu() - cpu[0]).abs().max().item()
            raise AssertionError(f"backward {name}: working-row gradient "
                                 f"not bit-equal to the CPU plain vjp "
                                 f"(max |diff| {err})")
        card = ref.embedding_bag_backward_ref(g, working, inv, seg, w, True,
                                              need_w)
        err = (got[0] - card[0]).abs().max().item()
        max_err = max(max_err, err)
        msg = f"  {name}: g_work bit-equal to the CPU plain vjp"
        if need_w:
            err_w = (got[1].cpu() - cpu[1]).abs().max().item()
            max_err = max(max_err, err_w)
            if not torch.allclose(got[1].cpu(), cpu[1], **TOL):
                raise AssertionError(f"backward {name}: weight gradient "
                                     f"differs, max |diff| {err_w}")
            msg += f", g_w max |diff| {err_w:.3g}"
        print(msg + f"; vs the plain vjp on the card max |diff| {err:.3g}")

    g, working, inv, seg, w = _backward_slice_case(device)
    per_row = torch.bincount(inv.long(), minlength=working.shape[0])
    print(f"phase 1: embedding_bag backward against the plain vjp "
          f"(g {tuple(g.shape)}, working {tuple(working.shape)}, nnz "
          f"{inv.numel()}; the hottest working row holds "
          f"{int(per_row.max())} entries, {int((per_row > 32).sum())} rows "
          f"hold more than 32)")
    checks("slice shape, mask weights", g, working, inv, seg, w)
    gen = torch.Generator(device).manual_seed(6)
    for C, D, nnz, nb in [(37, 24, 101, 53), (200, 16, 333, 97),
                          (90, 100, 257, 40), (64, 200, 150, 31)]:
        for weighted in (True, False):
            wk, iv, sg, ww = _bag_case(gen, C, D, nnz, nb, weighted, device)
            gg = torch.randn((nb, D), generator=gen, device=device)
            checks(f"C={C} D={D} nnz={nnz} bags={nb} weighted={weighted}",
                   gg, wk, iv, sg, ww)

    # ---- times at the training path's shapes (the CTR mask needs no grad)
    ms = _time_ms(lambda: kb.embedding_bag_backward_cuda(
        g, working, inv, seg, w, True, False))
    streams = kb.sorted_streams(inv, working.shape[0], seg, w)
    launch_ms = _time_ms(lambda: kb.launch_backward(g, *streams,
                                                    working.shape[0]))
    plain_ms = _time_ms(lambda: ref.embedding_bag_backward_ref(
        g, working, inv, seg, w, True, False))
    inv64, seg64 = inv.long(), seg.long()

    def library():
        return torch.zeros_like(working).index_add_(
            0, inv64, g[seg64] * w[:, None])

    library_ms = _time_ms(library)
    D = working.shape[1]
    g_rows = torch.unique(seg).numel()
    nbytes = (g_rows * D * 4 + inv.numel() * (4 + 4 + 4)
              + working.shape[0] * D * 4)
    flops = 2 * inv.numel() * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    print(f"  times (ms): wrapper {ms:.4f} (kernel launch alone "
          f"{launch_ms:.4f}), plain vjp {plain_ms:.4f}, index_add_ library "
          f"call {library_ms:.4f}; bound {bound_ms:.4f} "
          f"({nbytes / 1e6:.2f} MB: {g_rows} cotangent rows read, "
          f"{working.shape[0]} working rows written)")
    return {
        "name": "embedding_bag_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/ops.py:113 (XLA vjp, no Pallas "
                    "kernel)",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _slice_uids(device, capacity=CAPACITY, fit_rows=None):
    """uids as the training pull lays them out for the first training
    batch (strictly ascending real ids, then pads repeating uids[0]).
    With ``fit_rows`` the ids at or above ``fit_rows - n_real`` are
    renumbered in order from there, so the layout fits a table of
    ``fit_rows`` rows with every id below that line unchanged."""
    import torch

    from repro_torch.core.embedding_backend import pull_working_set

    b = _train_batches(1)[0]
    ids = torch.from_numpy(b["ids"]).to(device).reshape(-1)
    uids, _ = pull_working_set(ids, capacity)
    n_real = min(int(torch.unique(ids).numel()), capacity)
    if fit_rows is not None:
        real = uids[:n_real].long()
        line = fit_rows - n_real
        high = real >= line
        rank = torch.cumsum(high.long(), 0) - 1
        real = torch.where(high, line + rank, real)
        uids = torch.cat([real, real[:1].expand(capacity - n_real)]).to(
            torch.int32)
    return uids.contiguous(), n_real


def _push_inputs(gen, uids, n_real, table_rows, D, device):
    import torch

    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    table = torch.randn((table_rows, D), generator=gen, device=device) * 0.05
    accum = torch.rand((table_rows, D), generator=gen, device=device) + 0.01
    grads = torch.randn((uids.numel(), D), generator=gen, device=device)
    grads[n_real:] = 0.0               # no id slot maps to a pad
    delta, g2 = adagrad_row_updates(accum[uids.long()], grads, table.dtype,
                                    lr=0.5, eps=1e-10)
    return table, accum, delta, g2


def phase_push(device):
    """The push kernel against its plain version; returns its kernels-line
    entry (without ``launches``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_apply_cuda

    gen = torch.Generator(device).manual_seed(31)
    max_err = 0.0

    def err(a, b):
        return (a - b).abs().max().item() if a.numel() else 0.0

    def checks(name, uids, n_real, table_rows, D):
        nonlocal max_err
        table, accum, delta, g2 = _push_inputs(gen, uids, n_real, table_rows,
                                               D, device)
        want = ref.sparse_adagrad_apply_ref(table.clone(), accum.clone(),
                                            uids, delta, g2)
        runs = []
        for _ in range(2):
            t, a = table.clone(), accum.clone()
            out = sparse_adagrad_apply_cuda(t, a, uids, delta, g2)
            torch.cuda.synchronize()
            if out[0] is not t or out[1] is not a:
                raise AssertionError(f"push {name}: not in place")
            runs.append((t, a))
        for t, a in runs:
            max_err = max(max_err, err(t, want[0]), err(a, want[1]))
            if not (torch.equal(t, want[0]) and torch.equal(a, want[1])):
                raise AssertionError(f"push {name}: kernel and plain "
                                     "version differ")
        touched = torch.zeros(table_rows, dtype=torch.bool, device=device)
        touched[uids.long()] = True
        if not torch.equal(runs[0][0][~touched], table[~touched]):
            raise AssertionError(f"push {name}: an untouched row changed")
        n_pads = int((uids[1:] <= uids[:-1]).sum())
        print(f"  {name}: bit-equal to the plain version, two runs "
              f"bit-equal, untouched rows unchanged ({n_real} real rows, "
              f"{n_pads} pads)")
        return table, accum, delta, g2

    small_rows = 4_000_000
    uids, n_real = _slice_uids(device, fit_rows=small_rows)
    print(f"phase 1: sparse_adagrad_apply against its plain version (uids "
          f"{uids.numel()}, table {small_rows} x 64)")
    table, accum, delta, g2 = checks("slice layout, D=64", uids, n_real,
                                     small_rows, 64)
    over, n_over = _slice_uids(device, capacity=16384, fit_rows=small_rows)
    checks("overflowed batch (capacity 16384), D=64", over, 16384,
           small_rows, 64)
    from repro_torch.core.embedding_backend import pull_working_set

    for D in (16, 100):
        ids = torch.randint(0, 30000, (5000,), generator=gen, device=device,
                            dtype=torch.int32)
        u, _ = pull_working_set(ids, 8192)
        checks(f"random batch, D={D}", u, int(torch.unique(ids).numel()),
               30000, D)

    # the slice batch on the 50 M-row table: offsets beyond int32
    big_uids, big_real = _slice_uids(device)
    n_high = int((big_uids.long() * 64 >= (1 << 31)).sum())
    big_t = torch.zeros((ROWS, 64), device=device)
    big_a = torch.full((ROWS, 64), 0.01, device=device)
    grads = torch.randn((CAPACITY, 64), generator=gen, device=device)
    grads[big_real:] = 0.0
    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    bd, bg2 = adagrad_row_updates(big_a[big_uids.long()], grads,
                                  torch.float32, lr=0.5, eps=1e-10)
    uniq, pos = torch.unique(big_uids, return_inverse=True)
    want_t, want_a = ref.sparse_adagrad_apply_ref(
        big_t[uniq.long()].clone(), big_a[uniq.long()].clone(),
        pos.to(torch.int32), bd, bg2)
    sample = torch.randint(0, ROWS, (1 << 16,), generator=gen, device=device)
    sample = sample[~torch.isin(sample, uniq)]
    before = big_t[sample].clone(), big_a[sample].clone()
    sparse_adagrad_apply_cuda(big_t, big_a, big_uids, bd, bg2)
    torch.cuda.synchronize()
    max_err = max(max_err, err(big_t[uniq.long()], want_t),
                  err(big_a[uniq.long()], want_a))
    if not (torch.equal(big_t[uniq.long()], want_t)
            and torch.equal(big_a[uniq.long()], want_a)):
        raise AssertionError("push on the 50 M-row table: rows differ from "
                             "the plain version")
    if not (torch.equal(big_t[sample], before[0])
            and torch.equal(big_a[sample], before[1])):
        raise AssertionError("push on the 50 M-row table: an untouched row "
                             "changed")
    print(f"  slice batch on the {ROWS}-row table: touched rows bit-equal "
          f"to the plain version ({n_high} uids with uid * 64 >= 2^31), "
          f"{sample.numel()} sampled untouched rows unchanged")
    del big_t, big_a
    torch.cuda.empty_cache()

    # ---- times at the slice's layout, in place on the 4 M-row table
    ms = _time_ms(lambda: sparse_adagrad_apply_cuda(table, accum, uids,
                                                    delta, g2))
    plain_ms = _time_ms(lambda: ref.sparse_adagrad_apply_ref(
        table, accum, uids, delta, g2))
    idx = uids.long()

    def library():
        table.index_add_(0, idx, delta)
        accum.index_add_(0, idx, g2)

    library_ms = _time_ms(library)
    D = table.shape[1]
    nbytes = n_real * D * 4 * 6 + uids.numel() * 4
    flops = 2 * n_real * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    print(f"  times (ms): kernel {ms:.4f}, plain version (two index_add_) "
          f"{plain_ms:.4f}, index_add_ library calls {library_ms:.4f}; "
          f"bound {bound_ms:.4f} ({nbytes / 1e6:.2f} MB: {n_real} real rows "
          f"x 6 x {D * 4} B + the uid stream)")
    return {
        "name": "sparse_adagrad_apply",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_adagrad.cu",
        "replaces": "src/repro/kernels/sparse_adagrad.py:127",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _full_width_trainer(device, n_pod=2, seed=0):
    """baidu-ctr at full width, 50 M rows, with the launcher's defaults."""
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    mcfg = dataclasses.replace(baidu_ctr.MODEL, rows=ROWS)
    tcfg = TrainerConfig(
        n_pod=n_pod, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement="gather", capacity=CAPACITY, log_every=10)
    return build_trainer("baidu-ctr", tcfg, smoke=False, model_cfg=mcfg,
                         seed=seed, device=device)


def _release():
    """Return the memory of dropped trainers to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


TRAIN_STEPS = 40


def phase_train(device):
    """40 training steps at full width; returns the launch counts of the
    run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.online import fit_online

    t0 = time.perf_counter()
    tr = _full_width_trainer(device)
    torch.cuda.synchronize()
    print(f"phase 3: baidu-ctr training, rows {ROWS}, capacity "
          f"{tr.engine.capacity}, batch {BATCH}, n_pod {tr.n_pod}, k "
          f"{tr.cfg.kstep.k}, merge {tr.cfg.kstep.merge}; trainer built in "
          f"{time.perf_counter() - t0:.1f} s")
    batches = _train_batches(TRAIN_STEPS + 12)   # + 12 for the breakdown
    run, extra = batches[:TRAIN_STEPS], batches[TRAIN_STEPS:]
    seen = np.unique(np.concatenate([b["ids"].reshape(-1) for b in run]))
    rng = np.random.default_rng(0)
    sample = rng.integers(0, ROWS, 1 << 14)
    sample = torch.from_numpy(sample[~np.isin(sample, seen)]).to(device)
    before = [t[sample].clone() for t in (tr.tables["sparse"],
                                          tr.sparse_state.accum["sparse"])]
    # every step's loss, kept on the device until the run ends
    step_losses = []
    train_step = tr.train_step

    def recorded(b):
        loss = train_step(b)
        step_losses.append(loss)
        return loss

    tr.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, online_auc = fit_online(tr, iter(run), TRAIN_STEPS, window=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr.train_step

    losses = [r["loss"] for r in hist]
    every = torch.stack(step_losses).cpu().numpy()
    if [r["step"] for r in hist] != [10, 20, 30, 40]:
        raise AssertionError(f"history steps {[r['step'] for r in hist]}")
    if every.shape != (TRAIN_STEPS,) or not np.isfinite(every).all():
        raise AssertionError(f"a loss is not finite: {every}")
    if not np.array_equal(every[9::10], np.float32(losses)):
        raise AssertionError("history losses are not the steps' losses")
    if tr.overflow_dropped != 0:
        raise AssertionError(f"overflow_dropped {tr.overflow_dropped}")
    n = TRAIN_STEPS
    want = {"embedding_bag": n * (1 + tr.n_pod),
            "embedding_bag_backward": n * tr.n_pod,
            "sparse_adagrad_apply": n}
    want.update({k + "_ref": 0 for k in list(want)})
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    after = [t[sample] for t in (tr.tables["sparse"],
                                 tr.sparse_state.accum["sparse"])]
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("a row outside every batch changed")
    print(f"  losses at steps 10/20/30/40: "
          f"{', '.join(f'{x:.6f}' for x in losses)} (all {TRAIN_STEPS} "
          f"finite, {every.min():.4f} to {every.max():.4f}); online AUC "
          f"{online_auc:.4f}; overflow_dropped 0; {sample.numel()} rows "
          f"outside every batch unchanged")
    print(f"  predict + train per step (fit_online wall / {n}): "
          f"{wall / n * 1e3:.2f} ms ({n / wall:.2f} steps/s); peak device "
          f"memory {peak_gb:.2f} GB")
    print(f"  launches during the run: {launches}")
    _train_breakdown(tr, extra)
    del tr
    _release()
    return launches


def _train_breakdown(tr, batches):
    """Device time of one training step by part (CUDA events between the
    parts of ``train_step``), and the train step's wall time; outside the
    counted run."""
    import torch

    names = ("pull (stage + dedup + gather)", "forward (bags + tower)",
             "backward (bag kernel + autograd)", "k-step Adam", "push")
    sums = dict.fromkeys(names, 0.0)
    steps = batches[:6]
    for b in steps:
        tr.step_num += 1
        merge = tr.step_num % tr.cfg.kstep.k == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        staged = tr._stage(b)
        wss, tables, accum, bstate = tr.engine.pull_batch(
            tr.tables, tr.sparse_state.accum, tr.backend_state, staged)
        ev[1].record()
        dense, workings, losses = tr._forward(wss, tr.pod_batch(staged))
        ev[2].record()
        dense_g, work_g = tr._backward(dense, workings, losses)
        ev[3].record()
        tr.opt.step(tr.dense, dense_g, tr.opt_state, merge=merge)
        ev[4].record()
        tr.engine.push(tables, accum, bstate, wss, work_g)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            sums[k] += ev[i].elapsed_time(ev[i + 1])
    parts = {k: v / len(steps) for k, v in sums.items()}
    walls = []
    for b in batches[6:9]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("  one train step, stream time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}")
    print(f"  train_step wall (synchronized, {len(walls)} steps): mean "
          f"{np.mean(walls) * 1e3:.2f} ms, min {np.min(walls) * 1e3:.2f} ms")
    _busy_share(tr, batches[9:12])


def _busy_share(tr, batches):
    """The device's busy share over a few train steps: the kernels' device
    time in a ``torch.profiler`` trace over the steps' wall time, and the
    kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            tr.train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("  device busy share: not measured (the trace holds no device "
              "time)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  device busy share over {len(batches)} train steps (profiler): "
          f"{busy_us / wall_us:.3f} ({busy_us / len(batches) / 1e3:.3f} ms "
          f"of device time per step of {wall_us / len(batches) / 1e3:.3f} ms "
          f"wall, profiler on); top kernels (ms per step): " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / len(batches) / 1e3:.3f}"
              for e in top))


def phase_colocated(device):
    """10 full-width steps twice from one seed, the second with a server
    draining between steps: the same bits."""
    import torch

    from repro_torch.core.kstep import leaves
    from repro_torch.runtime.factory import build_ctr_server

    batches = _train_batches(10)
    requests = _train_batches(10, seed=2, batch=256)
    results = []
    for serve in (False, True):
        tr = _full_width_trainer(device)
        srv = build_ctr_server(tr, max_batch=256) if serve else None
        losses = []
        for b, r in zip(batches, requests):
            if srv is not None:
                srv.submit_batch(r)
            losses.append(tr.train_step(b))
            if srv is not None and srv.drain() != 256:
                raise AssertionError("the server did not drain its batch")
        losses = torch.stack(losses).cpu()
        dense = torch.cat([x.reshape(-1) for x in leaves(tr.dense)]).cpu()
        results.append((losses, _checksum(tr), dense))
        served = 0 if srv is None else int(srv.summary()["served"])
        del tr, srv
        _release()
    (la, ca, da), (lb, cb, db) = results
    if not torch.equal(la, lb):
        raise AssertionError(f"losses differ with the server: {la} vs {lb}")
    if ca != cb or not torch.equal(da, db):
        raise AssertionError("final state differs with the server")
    print(f"phase 4: 10 full-width steps without and with a co-located "
          f"server ({served} requests served): per-step losses, table and "
          f"accumulator checksums and dense parameters bit-equal; losses "
          f"{la[0]:.6f} ... {la[-1]:.6f}")


def phase_quickstart(device):
    """``examples/quickstart.py``'s configuration through the port."""
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.data.synthetic import ctr_batches
    from repro_torch.models.recsys import CTRConfig
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import TrainerConfig

    cfg = CTRConfig(rows=20_000, n_fields=8, nnz_per_instance=20,
                    mlp=(64, 1), attn_heads=2)
    tr = build_trainer(
        "baidu-ctr",
        TrainerConfig(
            n_pod=4, kstep=KStepConfig(lr=1e-3, k=10, b1=0.0, merge="flat"),
            sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
            placement="gather", capacity=16384),
        model_cfg=cfg, device=device)
    gen = ctr_batches(seed=1, batch=512, rows=cfg.rows,
                      n_fields=cfg.n_fields, nnz=cfg.nnz_per_instance)
    t0 = time.perf_counter()
    _, online_auc = fit_online(tr, gen, 150, window=20)
    wall = time.perf_counter() - t0
    print(f"phase 5: quickstart configuration (4 pods, k 10, 150 steps): "
          f"online AUC {online_auc:.4f} (bar 0.72), {150 / wall:.1f} "
          f"steps/s")
    if not online_auc > 0.72:
        raise AssertionError(f"quickstart AUC {online_auc} <= 0.72")


def phase_agreement_train(device):
    """6 training steps at smoke size on the card and on the CPU from one
    state."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import KStepAdamState, KStepConfig, leaves
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.interop import ReferenceState
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_ctr_engine, build_trainer
    from repro_torch.runtime.online import fit_online
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    smoke = baidu_ctr.SMOKE
    tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=256,
                         log_every=1)
    gpu = build_trainer("baidu-ctr", tcfg, seed=3, device=device)
    cpu_of = lambda x: x.cpu().clone()    # the trainers update in place
    s = gpu.opt_state
    state = ReferenceState(
        dense=tree_map(cpu_of, gpu.dense),
        tables={n: cpu_of(t) for n, t in gpu.tables.items()},
        accum={n: cpu_of(a) for n, a in gpu.sparse_state.accum.items()},
        opt_state=KStepAdamState(cpu_of(s.step), tree_map(cpu_of, s.m),
                                 tree_map(cpu_of, s.v_local),
                                 tree_map(cpu_of, s.v_hat), None))
    cpu = HybridTrainer(None, build_ctr_engine(smoke, tcfg, device="cpu"),
                        R.ctr_embed_from_workings(smoke),
                        R.ctr_hybrid_loss(smoke), tcfg, state=state,
                        device="cpu")
    out = []
    for tr in (gpu, cpu):
        hist, _ = fit_online(tr, recsys_batches(smoke, batch=32, seed=5), 6,
                             window=5)
        out.append(([r["loss"] for r in hist],
                    torch.cat([x.reshape(-1).cpu()
                               for x in leaves(tr.dense)]).numpy(),
                    tr.tables["sparse"].cpu().numpy()))
    tol = dict(rtol=1e-4, atol=1e-6)
    for what, a, b in zip(("losses", "dense", "table"), *out):
        np.testing.assert_allclose(a, b, err_msg=what, **tol)
    print(f"phase 6: 6 smoke-size training steps, card vs CPU from one "
          f"state: losses max |diff| "
          f"{np.abs(np.subtract(out[0][0], out[1][0])).max():.3g}, dense "
          f"max |diff| {np.abs(out[0][1] - out[1][1]).max():.3g}, table max "
          f"|diff| {np.abs(out[0][2] - out[1][2]).max():.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import embedding_bag  # noqa: F401 (a checkout?)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, tf32 off")

    bag = phase_kernels(device)
    backward = phase_backward(device)
    push = phase_push(device)
    phase_slice(device)
    _release()
    launches = phase_train(device)
    for entry in (bag, backward, push):
        entry["launches"] = launches[entry["name"]]
    phase_colocated(device)
    phase_quickstart(device)
    phase_agreement(device)
    phase_agreement_train(device)
    print(json.dumps({"kernels": [bag, backward, push]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
