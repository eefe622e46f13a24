"""The port against the JAX reference at a recsys arch's full widths, on
the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fullwidth_parity.py \\
        [--arch baidu-ctr|dlrm-mlperf] [--rows N] [--steps 24] \\
        [--batch 1024] [--out curves.json] [--sparse-lr 0.5] [--export x.npz] \\
        [--mode free|forced|perturbed|reference]

A script, not a test (pytest collects ``test_*.py`` only): one run takes
minutes.  The model is the arch's full config with its tables cut to
``--rows``:
  - ``baidu-ctr`` (the default): embed 64, 40 fields, 100 ids per
    instance, 4 heads, MLP 512-256-1, float32; the table cut to ``--rows``
    (default 1,000,000), capacity 65536, so no id of a 1024-instance batch
    is dropped;
  - ``dlrm-mlperf``: 13 dense and 26 single-hot sparse features, embed
    128, bottom MLP 13-512-256-128, top MLP 479-1024-1024-512-256-1,
    float32; each of the 26 tables capped at ``--rows`` rows (default
    20,000), capacity the batch rounded up to a power of two (a single-hot
    table cannot overflow it).
Both take the launcher's training settings (n_pod 2, k 20, two_phase,
dense lr 1e-3 with b1 0 and b2 0.999, sparse lr 0.5, initial accumulator
0.01).  Both trainers start from the reference's state
(``interop.from_reference``) and take the same batches, past the first
merge at step 20, each batch scored before it is trained on (the online
protocol of ``fit_online``).  It prints both loss curves step by step,
their maxima, the steps where they differ beyond the parity tests'
tolerance (rtol 1e-4, atol 1e-6) and both online AUCs (the streaming AUC
over the last 20 scored batches), and writes the curves as JSON to
``--out``.

Modes:
  - ``free`` (the default): both trainers run on from one state;
  - ``forced``: before every step the port is loaded with the reference's
    current state, so each step's loss and state show what ONE step of the
    port does differently (the function computed, not the trajectory);
  - ``perturbed``: the reference against itself, the second run started
    from its state with every dense parameter moved by one float32 ulp: how
    far the dynamics alone carry a difference of that size;
  - ``reference``: the reference alone (its loss curve and online AUC).
``--sparse-lr`` replaces the sparse learning rate in both packages.
``--export PATH`` writes the reference's initial state (dense towers and
tables; the accumulators are the initial 0.01) and its loss curve to an
``.npz``, from which ``tools/dlrm_card_curve.py`` trains the port on the
card from the same state (DLRM).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import numpy as np

TOL = dict(rtol=1e-4, atol=1e-6)
DEFAULT_ROWS = {"baidu-ctr": 1_000_000, "dlrm-mlperf": 20_000}
AUC_WINDOW = 20


def _state_arrays(jtr):
    """The reference trainer's podded dense leaves and tables as numpy,
    keyed ``dense/<tower>/<layer>/<w|b>`` and ``table/<name>`` (a DLRM
    trainer; its accumulators are the initial constant)."""
    arrays = {}
    for tower, layers in jax.device_get(jtr.dense).items():
        for i, layer in enumerate(layers):
            for k, v in layer.items():
                arrays[f"dense/{tower}/{i}/{k}"] = np.asarray(v)
    for name, t in jax.device_get(jtr.tables).items():
        arrays[f"table/{name}"] = np.asarray(t)
    return arrays


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="baidu-ctr",
                    choices=sorted(DEFAULT_ROWS))
    ap.add_argument("--rows", type=int, default=0,
                    help="rows of the table (baidu-ctr) or the most rows of "
                         "each table (dlrm-mlperf); 0: the arch's default")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default="")
    ap.add_argument("--mode", default="free",
                    choices=["free", "forced", "perturbed", "reference"])
    ap.add_argument("--sparse-lr", type=float, default=0.5)
    ap.add_argument("--export", default="",
                    help="write the reference's initial state and its loss "
                         "curve to this .npz (for tools/dlrm_card_curve.py)")
    args = ap.parse_args(argv)

    import torch

    from repro import configs as jconfigs
    from repro.core.kstep import KStepConfig as JKStepConfig
    from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
    from repro.data import synthetic as JS
    from repro.runtime.factory import build_trainer as jbuild_trainer
    from repro.runtime.metrics import StreamingAUC as JStreamingAUC
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    from repro_torch import configs
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.interop import from_reference
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_ctr_engine, build_dlrm_engine
    from repro_torch.runtime.metrics import StreamingAUC
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    rows = args.rows or DEFAULT_ROWS[args.arch]

    def cut(model_cfg):
        if args.arch == "baidu-ctr":
            return dataclasses.replace(model_cfg, rows=rows)
        return dataclasses.replace(
            model_cfg, rows=tuple(min(r, rows) for r in model_cfg.rows))

    jcfg = cut(jconfigs.get(args.arch).model_cfg)
    tcfg_model = cut(configs.get(args.arch).model_cfg)
    if args.arch == "baidu-ctr":
        capacity = 65536
        build_engine, embed_of, loss_of = (
            build_ctr_engine, R.ctr_embed_from_workings, R.ctr_hybrid_loss)
    else:
        capacity = 1 << (args.batch - 1).bit_length()
        build_engine, embed_of, loss_of = (
            build_dlrm_engine, R.dlrm_embed_from_workings,
            R.dlrm_hybrid_loss)
    t0 = time.perf_counter()

    def jtrainer():
        return jbuild_trainer(args.arch, JTrainerConfig(
            n_pod=2, kstep=JKStepConfig(lr=1e-3, k=20, merge="two_phase"),
            sparse=JSparseConfig(lr=args.sparse_lr,
                                 initial_accumulator=0.01),
            placement="gather", capacity=capacity, log_every=1),
            model_cfg=jcfg, seed=0)

    jtr = jtrainer()
    tcfg = TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=args.sparse_lr,
                                   initial_accumulator=0.01),
        placement="gather", capacity=capacity, log_every=1)

    def port_from(src):
        st = from_reference(
            jax.device_get(src.dense), jax.device_get(src.tables),
            jax.device_get(src.sparse_state.accum),
            jax.device_get(src.opt_state), device="cpu")
        return HybridTrainer(None, build_engine(tcfg_model, tcfg,
                                                device="cpu"),
                             embed_of(tcfg_model), loss_of(tcfg_model), tcfg,
                             state=st, device="cpu")

    exported = _state_arrays(jtr) if args.export else None
    if args.mode == "reference":
        step_fn = predict_fn = meter = None
    elif args.mode == "perturbed":
        other = jtrainer()
        other.dense = jax.tree.map(
            lambda x: jax.numpy.asarray(np.nextafter(
                np.asarray(x), np.float32(np.inf))),
            jax.device_get(other.dense))
        step_fn = lambda b: float(other.train_step(b))
        predict_fn = other.predict
        meter = JStreamingAUC(window=AUC_WINDOW)
    else:
        tr = port_from(jtr)
        step_fn = lambda b: float(tr.train_step(b))
        predict_fn = lambda b: tr.predict(b)
        meter = StreamingAUC(window=AUC_WINDOW)
    jmeter = JStreamingAUC(window=AUC_WINDOW)
    print(f"arch {args.arch}, mode {args.mode}, rows {rows}, batch "
          f"{args.batch}, capacity {capacity}, sparse lr {args.sparse_lr}, "
          f"{args.steps} steps; torch "
          f"{torch.__version__}, jax {jax.__version__}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = JS.recsys_batches(jcfg, batch=args.batch, seed=1)
    ref_losses, port_losses, dense_diff = [], [], []
    for step in range(1, args.steps + 1):
        b = next(gen)
        if args.mode == "forced":
            tr = port_from(jtr)
        t0 = time.perf_counter()
        jmeter.update(b["label"], np.asarray(jtr.predict(b)))
        ref_losses.append(float(jtr.train_step(b)))
        t1 = time.perf_counter()
        if args.mode == "reference":
            print(f"step {step:3d}  reference {ref_losses[-1]:.6f}  "
                  f"({t1 - t0:.1f} s)", flush=True)
            continue
        meter.update(b["label"], np.asarray(predict_fn(b)))
        port_losses.append(step_fn(b))
        t2 = time.perf_counter()
        line = (f"step {step:3d}  reference {ref_losses[-1]:.6f}  other "
                f"{port_losses[-1]:.6f}  |diff| "
                f"{abs(ref_losses[-1] - port_losses[-1]):.3g}")
        if args.mode == "forced":
            # the dense tower after this one step, relative to its size
            want = jax.tree.leaves(jax.device_get(jtr.dense))
            got = [x.numpy() for x in jax.tree.leaves(tr.dense)]
            rel = max(float(np.abs(g - w).max() / np.abs(w).max())
                      for g, w in zip(got, want))
            dense_diff.append(rel)
            line += f"  dense max |diff| / max |w| {rel:.3g}"
        print(line + f"  ({t1 - t0:.1f} s, {t2 - t1:.1f} s)", flush=True)
    if args.export:
        np.savez(args.export, losses=np.array(ref_losses, np.float64),
                 rows=np.array(tcfg_model.rows), batch=args.batch,
                 sparse_lr=args.sparse_lr, **exported)
    if args.mode == "reference":
        print(f"reference: max {max(ref_losses):.6f} at step "
              f"{int(np.argmax(ref_losses)) + 1}; online AUC (last "
              f"{AUC_WINDOW} scored batches) {jmeter.value():.6f}")
        return
    ref, port = np.array(ref_losses), np.array(port_losses)
    close = np.isclose(port, ref, **TOL)
    apart = [int(i) + 1 for i in np.flatnonzero(~close)]
    print(f"maxima: reference {ref.max():.6f} at step {ref.argmax() + 1}, "
          f"other {port.max():.6f} at step {port.argmax() + 1}")
    print(f"max |diff| {np.abs(port - ref).max():.3g}, max relative "
          f"{(np.abs(port - ref) / np.abs(ref)).max():.3g}; steps beyond "
          f"rtol 1e-4 atol 1e-6: {apart or 'none'}")
    auc, jauc = meter.value(), jmeter.value()
    print(f"online AUC (last {AUC_WINDOW} scored batches): reference "
          f"{jauc:.6f}, other {auc:.6f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "mode": args.mode, "rows": rows,
                       "batch": args.batch, "reference": ref_losses,
                       "other": port_losses, "apart": apart,
                       "auc_reference": jauc, "auc_other": auc,
                       "dense_rel_diff": dense_diff}, f, indent=1)


if __name__ == "__main__":
    main()
