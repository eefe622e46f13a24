#!/usr/bin/env python3
"""Time the bag forward's, the hash probe's, the pushes', the cached
gather's and flash attention's forward's and backward's wrappers of one
checkout on the card, so that two checkouts can be compared on one card in
one run.

    python3 tools/kernel_ab.py ROOT [--label NAME] [--out FILE]

``ROOT`` is the root of a checkout: this one, or another one unpacked
beside it (``git archive <commit> | tar -x -C build/parent``).  Its package
gives the wrappers, so each checkout is timed with its own kernels (built
into that checkout's ``build/``); this checkout's ``chip_smoke.py`` gives
the inputs and the timers, the same for every checkout.  Run two checkouts
in turns in one call (A, B, B, A), each in its own process.

Inputs:
  - the bag: phase 1's serving shape (``chip_smoke._slice_case``: working
    set 65537 x 64, 102,400 ids, 40,960 bags, mask weights) and four times
    its batch;
  - the probe: a map of the cache tier's slice size (C = 262,144 slots,
    H = 2^20 buckets) after two rounds of admissions (the second evicts
    131,072 of the first round's ids, whose entries go stale), probed with
    65,536 sorted distinct ids (80 % live, 10 % stale, 10 % never
    admitted) and with four times as many;
  - the push at the ops level (``ops.sparse_adagrad_apply``, the same
    signature in every checkout), with the slice's first batch
    deduplicated at capacity 65,536 (``chip_smoke._slice_uids``): on a
    4 M-row table (the ids above the line renumbered into it) and on the
    50 M-row table with the batch's own ids;
  - the cached push at the ops level (``ops.sparse_adagrad_cached_apply``)
    on a cache of 262,144 x 64 rows, the batch's real ids at a random
    permutation of the slots, the pads sharing the first id's slot;
  - the cached gather at those slots, with the working set's drop row:
    ``ops.gather_rows_cached(..., drop_row=True)`` where the checkout has
    it, else ``_with_drop_row(ops.gather_rows_cached(...))`` (the pull's
    gather, then its ``cat``);
  - flash attention's forward (kernel 9, ``flash_attention_cuda``,
    causal) at the LM prefill cell's shape, (B, S, H, Kv, hd) = (4, 4096,
    40, 8, 128), in bfloat16, and at (1, 4096, 40, 8, 128) in float32,
    with a digest of its output's bytes;
  - flash attention's backward (kernel 9b,
    ``flash_attention_backward_cuda``) at the LM training cell's shape,
    (B, S, H, Kv, hd) = (1, 4096, 40, 8, 128), causal, in bfloat16 and in
    float32, from the output and log-sum-exp of the checkout's forward;
    with a digest of its gradients' bytes (two checkouts whose kernels give
    the same bits give the same digest).
  - with ``--digests-only``, none of the above: the digests of the bag's
    forward and working-row gradient (``_bag_digests``) at the widths up
    to 256 and past it, weighted and not, on inputs with a very long, a
    long and short working rows (equal digests: the same bits).
Times (ms, or us where said): the wrapper with a cold L2 (after a 256 MB
write, and after a 256 MB read, which leaves no dirty line in L2) and a
warm one, the device alone (CUDA graph replays, cold L2 and warm), the
host per call.  Also,
the same in every checkout: ``F.embedding_bag`` on the bag's CSR,
``index_add_`` and the backward of ``F.scaled_dot_product_attention``
(library calls), and the latency of one dependent trip to HBM
(``tools/pointer_chase.cu``).  Each push's and gather's result is held
against the plain version on the card (bit-equal) before it is timed.
Appends one JSON line per run to ``FILE`` (default
``build/kernel_ab.jsonl``) and prints it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _probe_case(device, scale=1, seed=3):
    """(key_tab, slot_tab, slot_uid, uids) of a slice-size map."""
    import torch

    from repro_torch.kernels import hash_map as hm

    C, rows = 262144, 50_000_000
    H = hm.hash_table_size(C)
    gen = torch.Generator(device).manual_seed(seed)
    ids = torch.randperm(rows, generator=gen, device=device)[:C + C // 2 + C]
    ids = ids.to(torch.int32)
    first, second, fresh = ids[:C], ids[C:C + C // 2], ids[C + C // 2:]
    key_tab = torch.full((H,), hm.EMPTY, dtype=torch.int32, device=device)
    slot_tab = torch.zeros((H,), dtype=torch.int32, device=device)
    n_occ = torch.zeros((), dtype=torch.int32, device=device)
    slot_uid = torch.full((C,), -1, dtype=torch.int32, device=device)
    evict = torch.randperm(C, generator=gen, device=device)[:C // 2]
    for batch, slots in ((first, torch.arange(C, device=device)),
                         (second, evict)):
        slots = slots.to(torch.int32)
        slot_uid[slots.long()] = batch
        key_tab, slot_tab, n_occ = hm.hash_insert(
            key_tab, slot_tab, n_occ, batch, slots,
            torch.ones(batch.shape, dtype=torch.bool, device=device))
    live = slot_uid
    stale = first[evict.long()]
    n = 65536 * scale
    pick = [live[torch.randperm(C, generator=gen, device=device)[:n * 8 // 10]],
            stale[torch.randperm(stale.numel(), generator=gen,
                                 device=device)[:n // 10]],
            fresh[:n - n * 8 // 10 - n // 10]]
    uids = torch.sort(torch.cat(pick)).values.contiguous()
    return key_tab, slot_tab, slot_uid, uids


def _push_gather_times(cs, dev, times):
    """The pushes and the cached gather of the checkout whose package was
    imported first, at the ops level (see the module's docstring)."""
    import inspect

    import torch

    from repro_torch.core.embedding_backend import _with_drop_row
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    lr, eps = 0.5, 1e-10
    gen = torch.Generator(dev).manual_seed(5)
    out = {}

    def held(name, push, t, a, rows, g):
        """``push(t, a)`` on copies, bit-equal to the plain version."""
        d, g2 = adagrad_row_updates(a.index_select(0, rows.long()), g,
                                    t.dtype, lr=lr, eps=eps)
        want = ref.sparse_adagrad_apply_ref(t.clone(), a.clone(), rows, d, g2)
        got = push(t.clone(), a.clone())
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: the push and its plain version "
                                 "differ")

    for key, rows in (("push_4m_rows", 4_000_000),
                      ("push_50m_rows", cs.ROWS)):
        uids, n_real = cs._slice_uids(
            dev, fit_rows=rows if rows != cs.ROWS else None)
        table = torch.randn((rows, 64), generator=gen,
                            device=dev).mul_(0.05)
        accum = torch.rand((rows, 64), generator=gen, device=dev).add_(0.01)
        grads = torch.randn((uids.numel(), 64), generator=gen, device=dev)
        grads[n_real:] = 0.0
        if rows != cs.ROWS:       # the check copies the table
            held(key, lambda t, a: ops.sparse_adagrad_apply(
                t, a, uids, grads, lr=lr, eps=eps), table, accum, uids,
                grads)
        out[key] = times(lambda: ops.sparse_adagrad_apply(
            table, accum, uids, grads, lr=lr, eps=eps))
        out[key]["real_rows"], out[key]["table_rows"] = n_real, rows
        del table, accum
        torch.cuda.empty_cache()

    C = 262_144
    cache = torch.randn((C, 64), generator=gen, device=dev)
    cache_acc = torch.rand((C, 64), generator=gen, device=dev).add_(0.01)
    perm = torch.randperm(C, generator=gen, device=dev)[:n_real]
    slots = torch.cat([perm, perm[:1].expand(uids.numel() - n_real)]).to(
        torch.int32).contiguous()

    held("cached push", lambda t, a: ops.sparse_adagrad_cached_apply(
        t, a, slots, grads, lr=lr, eps=eps, uids=uids), cache, cache_acc,
        slots, grads)
    out["cached_push"] = times(lambda: ops.sparse_adagrad_cached_apply(
        cache, cache_acc, slots, grads, lr=lr, eps=eps, uids=uids))

    if "drop_row" in inspect.signature(ops.gather_rows_cached).parameters:
        def gather():
            return ops.gather_rows_cached(cache, slots, drop_row=True)
    else:
        def gather():
            return _with_drop_row(ops.gather_rows_cached(cache, slots))
    got = gather()
    if not torch.equal(got, _with_drop_row(cache.index_select(
            0, slots.long()))):
        raise AssertionError("cached gather: rows differ from index_select "
                             "+ cat")
    out["cached_gather_drop_row"] = times(gather)
    return out


def _flash_forward_times(cs, dev, times):
    """Kernel 9 of the checkout whose package was imported first, causal,
    at the LM prefill cell's shape in bfloat16 and one sequence in float32
    (see the module's docstring)."""
    import hashlib

    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda

    out = {}
    for key, B, dtype in (("flash_forward_bf16", 4, torch.bfloat16),
                          ("flash_forward_f32", 1, torch.float32)):
        gen = torch.Generator(dev).manual_seed(61)
        q = torch.randn((B, 4096, 40, 128), generator=gen,
                        device=dev).to(dtype)
        k, v = [torch.randn((B, 4096, 8, 128), generator=gen,
                            device=dev).to(dtype) for _ in range(2)]

        def kernel():
            return flash_attention_cuda(q, k, v, True)

        digest = hashlib.sha256(kernel().view(torch.uint8).cpu().numpy())
        out[key] = times(kernel)
        out[key]["digest"] = digest.hexdigest()[:16]
        del q, k, v
        torch.cuda.empty_cache()
    return out


def _flash_backward_times(cs, dev, times):
    """Kernel 9b of the checkout whose package was imported first, at the
    LM cell's shape in bfloat16 and float32 (see the module's docstring)."""
    import hashlib

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    out = {}
    for key, dtype in (("flash_backward_bf16", torch.bfloat16),
                       ("flash_backward_f32", torch.float32)):
        gen = torch.Generator(dev).manual_seed(59)
        q = torch.randn((1, 4096, 40, 128), generator=gen,
                        device=dev).to(dtype)
        k, v = [torch.randn((1, 4096, 8, 128), generator=gen,
                            device=dev).to(dtype) for _ in range(2)]
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        o, lse = flash_attention_cuda(q, k, v, True, return_lse=True)

        def kernel():
            return flash_attention_backward_cuda(q, k, v, o, lse, dout, True)

        digest = hashlib.sha256()
        for g in kernel():
            digest.update(g.contiguous().view(torch.uint8).cpu().numpy())
        out[key] = times(kernel)
        out[key]["digest"] = digest.hexdigest()[:16]
        xs = [x.transpose(1, 2).detach().requires_grad_(True)
              for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*xs, is_causal=True,
                                                 enable_gqa=True)
        g = dout.transpose(1, 2)
        out[key]["sdpa_backward_ms"] = cs._time_ms(
            lambda: torch.autograd.grad(lib_out, xs, g, retain_graph=True))
        del q, k, v, dout, o, lse, xs, lib_out
        torch.cuda.empty_cache()
    return out


BAG_DIGEST_WIDTHS = (3, 16, 18, 37, 64, 100, 128, 200, 256, 257, 300, 602,
                     1433)


def _bag_digests(dev):
    """{"D{width}_{w|u}": digest} of the bag's forward and working-row
    gradient (``embedding_bag_cuda``, ``embedding_bag_backward_cuda``, the
    same signatures in every checkout) at ``BAG_DIGEST_WIDTHS``; a
    checkout whose bag takes no such width (no ``max_bag_dim`` in its
    extension: 256 columns at most) gives "not taken"."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels.build import extension

    C, nnz, nb = 5000, 200_000, 40_000
    max_dim = getattr(extension(), "max_bag_dim", 256)
    out = {}
    for D in BAG_DIGEST_WIDTHS:
        for weighted in (True, False):
            key = f"D{D}_{'w' if weighted else 'u'}"
            if D > max_dim:
                out[key] = "not taken"
                continue
            rng = np.random.default_rng(D)
            working = torch.from_numpy(rng.standard_normal(
                (C + 1, D)).astype(np.float32)).to(dev)
            inv = rng.integers(0, C + 1, nnz).astype(np.int32)
            inv[rng.permutation(nnz)[:6000]] = np.repeat([5, 7], [5000, 1000])
            inv = torch.from_numpy(inv).to(dev)
            seg = torch.from_numpy(rng.integers(-3, nb + 3, nnz).astype(
                np.int32)).to(dev)
            w = (torch.from_numpy(rng.standard_normal(nnz).astype(
                np.float32)).to(dev) if weighted else None)
            g = torch.from_numpy(rng.standard_normal((nb, D)).astype(
                np.float32)).to(dev)
            fwd = kb.embedding_bag_cuda(working, inv, seg, w, nb)
            bwd, _ = kb.embedding_bag_backward_cuda(g, working, inv, seg, w,
                                                    True, False)
            digest = hashlib.sha256()
            for t in (fwd, bwd):
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy())
            out[key] = digest.hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=pathlib.Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", type=pathlib.Path,
                    default=HERE / "build" / "kernel_ab.jsonl")
    ap.add_argument("--digests-only", action="store_true",
                    help="only the bag's digests (_bag_digests), no times")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    # ROOT's package first: what chip_smoke then imports of the package
    # comes from it
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels.hash_map import hash_lookup_cuda

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rec = {"label": args.label or str(root), "card": smi}
    rec["bag_digests"] = _bag_digests(dev)
    if args.digests_only:
        return _emit(rec, args.out)

    def times(fn):
        return {"ms": cs._time_ms(fn), "ms_l2_warm": cs._time_ms(
                    fn, cold_l2=False),
                "ms_scrub_read": cs._time_ms(fn, scrub_read=True),
                "graph_ms": cs._graph_ms(fn),
                "graph_ms_l2_warm": cs._graph_ms(fn, cold_l2=False),
                "host_us": cs._host_us(fn)}

    for scale in (1, 4):
        working, inv, seg, w, nb = cs._slice_case(dev, scale=scale)
        order, offsets = kb.csr_from_segments(seg, nb)
        lo, hi = int(offsets[0]), int(offsets[-1])
        inv_s = inv[order[lo:hi]].contiguous()
        w_s = w[order[lo:hi]].contiguous()
        off_s = (offsets - lo).to(torch.int32).contiguous()
        want = kb.embedding_bag_cuda(working, inv, seg, w, nb)
        lib = F.embedding_bag(inv_s, working, off_s, mode="sum",
                              per_sample_weights=w_s,
                              include_last_offset=True)
        torch.cuda.synchronize()
        if not torch.allclose(lib, want, rtol=1e-5, atol=1e-5):
            raise AssertionError("F.embedding_bag and the wrapper differ")
        seg64 = seg.long()
        key = "bag" if scale == 1 else "bag_4x"
        rec[key] = times(lambda: kb.embedding_bag_cuda(working, inv, seg, w,
                                                       nb))
        rec[key]["F.embedding_bag_ms"] = cs._time_ms(lambda: F.embedding_bag(
            inv_s, working, off_s, mode="sum", per_sample_weights=w_s,
            include_last_offset=True))
        rec[key]["index_add_ms"] = cs._time_ms(
            lambda: torch.zeros((nb, working.shape[1]), device=dev)
            .index_add_(0, seg64, working[inv.long()] * w[:, None]))
        rec[key]["nnz"], rec[key]["bags"] = inv.numel(), nb
        del working, inv, seg, w, order, offsets, inv_s, w_s, off_s

        pargs = _probe_case(dev, scale=scale)
        key = "probe" if scale == 1 else "probe_4x"
        rec[key] = times(lambda: hash_lookup_cuda(*pargs))
        rec[key]["ids"] = pargs[3].numel()
        rec[key]["hits"] = int((hash_lookup_cuda(*pargs) >= 0).sum())
        del pargs
    rec.update(_push_gather_times(cs, dev, times))
    rec.update(_flash_forward_times(cs, dev, times))
    rec.update(_flash_backward_times(cs, dev, times))
    trip_us, launch_ms = cs._hbm_trip()
    rec["hbm_trip_us"], rec["empty_launch_graph_ms"] = trip_us, launch_ms
    return _emit(rec, args.out)


def _emit(rec, out) -> int:
    """Print the run's JSON line and append it to ``out``."""
    line = json.dumps(rec)
    print(line)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
