#!/usr/bin/env python3
"""Run the PyTorch port's baidu-ctr serving path on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure raises and the script exits non-zero):
  1. kernels: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (into ``build/torch_kernels/``), then holds each kernel against its
     plain PyTorch version on the card: at the serving path's shapes
     (working set 65537 x 64, 102400 ids, 40960 bags), at small odd shapes
     with empty bags, with the sum/mean/sqrtn combiners and their gradients.
     Forward within rtol = atol = 1e-5; two runs bit-equal.  Times the
     kernel, the plain version and one PyTorch library call.
  2. slice: ``build_trainer`` at the full width of baidu-ctr (embed 64, 40
     fields, 100 ids per instance, MLP 512-256-1, f32) with the table cut to
     50 M rows, capacity 65536, then ``build_ctr_server(max_batch=1024)``:
     4 full batches and a 300-request tail.  The launch counts show that
     the bag ran as the CUDA kernel and never as the plain version; the
     table and accumulator checksums show that serving wrote nothing.
  3. agreement: the same path at smoke size on the card and on the CPU from
     one state, scores within rtol = atol = 1e-5.

Prints the card (``nvidia-smi`` name and power limit), a ``kernels`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Without
CUDA, or outside a checkout, it exits non-zero and prints no result.
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
    kb.extension()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(into {kb.BUILD_DIR.relative_to(ROOT)})")

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
    print(f"phase 3: smoke-size slice, card vs CPU from one state: "
          f"{got[0].size} scores, max |diff| "
          f"{np.abs(got[0] - got[1]).max():.3g}")


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

    entry = phase_kernels(device)
    launches = phase_slice(device)
    entry["launches"] = launches["embedding_bag"]
    phase_agreement(device)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
