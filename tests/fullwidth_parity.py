"""The port against the JAX reference at baidu-ctr's full widths, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fullwidth_parity.py \\
        [--rows 1000000] [--steps 24] [--batch 1024] [--out curves.json]
        [--mode free|forced|perturbed]

A script, not a test (pytest collects ``test_*.py`` only): one run takes
minutes.  The model is baidu-ctr's full config (embed 64, 40 fields, 100 ids
per instance, 4 heads, MLP 512-256-1, float32) with the table cut to
``--rows``; the launcher's training settings (n_pod 2, k 20, two_phase,
dense lr 1e-3 with b1 0 and b2 0.999, sparse lr 0.5, initial accumulator
0.01) and capacity 65536, so no id of a 1024-instance batch is dropped.
Both trainers start from the reference's state (``interop.from_reference``)
and take the same batches, past the first merge at step 20.  It prints both
loss curves step by step, their maxima, and the steps where they differ
beyond the parity tests' tolerance (rtol 1e-4, atol 1e-6), and writes the
curves as JSON to ``--out``.

Modes:
  - ``free`` (the default): both trainers run on from one state;
  - ``forced``: before every step the port is loaded with the reference's
    current state, so each step's loss and state show what ONE step of the
    port does differently (the function computed, not the trajectory);
  - ``perturbed``: the reference against itself, the second run started
    from its state with every dense parameter moved by one float32 ulp: how
    far the dynamics alone carry a difference of that size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import numpy as np

TOL = dict(rtol=1e-4, atol=1e-6)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default="")
    ap.add_argument("--mode", default="free",
                    choices=["free", "forced", "perturbed"])
    args = ap.parse_args(argv)

    import torch

    from repro import configs as jconfigs
    from repro.core.kstep import KStepConfig as JKStepConfig
    from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
    from repro.data import synthetic as JS
    from repro.runtime.factory import build_trainer as jbuild_trainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    from repro_torch import configs
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.interop import from_reference
    from repro_torch.models import recsys as R
    from repro_torch.runtime.factory import build_ctr_engine
    from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

    jcfg = dataclasses.replace(jconfigs.get("baidu-ctr").model_cfg,
                               rows=args.rows)
    tcfg_model = dataclasses.replace(configs.get("baidu-ctr").model_cfg,
                                     rows=args.rows)
    t0 = time.perf_counter()
    jtr = jbuild_trainer("baidu-ctr", JTrainerConfig(
        n_pod=2, kstep=JKStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=JSparseConfig(lr=0.5, initial_accumulator=0.01),
        placement="gather", capacity=65536, log_every=1),
        model_cfg=jcfg, seed=0)
    tcfg = TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=20, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement="gather", capacity=65536, log_every=1)

    def port_from(src):
        st = from_reference(
            jax.device_get(src.dense), jax.device_get(src.tables),
            jax.device_get(src.sparse_state.accum),
            jax.device_get(src.opt_state), device="cpu")
        return HybridTrainer(None, build_ctr_engine(tcfg_model, tcfg,
                                                    device="cpu"),
                             R.ctr_embed_from_workings(tcfg_model),
                             R.ctr_hybrid_loss(tcfg_model), tcfg, state=st,
                             device="cpu")

    if args.mode == "perturbed":
        other = jbuild_trainer("baidu-ctr", JTrainerConfig(
            n_pod=2, kstep=JKStepConfig(lr=1e-3, k=20, merge="two_phase"),
            sparse=JSparseConfig(lr=0.5, initial_accumulator=0.01),
            placement="gather", capacity=65536, log_every=1),
            model_cfg=jcfg, seed=0)
        other.dense = jax.tree.map(
            lambda x: jax.numpy.asarray(np.nextafter(
                np.asarray(x), np.float32(np.inf))),
            jax.device_get(other.dense))
        step_fn = lambda b: float(other.train_step(b))
    else:
        tr = port_from(jtr)
        step_fn = lambda b: float(tr.train_step(b))
    print(f"mode {args.mode}, rows {args.rows}, batch {args.batch}, "
          f"{args.steps} steps; torch {torch.__version__}, jax "
          f"{jax.__version__}; built in {time.perf_counter() - t0:.1f} s")
    gen = JS.recsys_batches(jcfg, batch=args.batch, seed=1)
    ref_losses, port_losses, dense_diff = [], [], []
    for step in range(1, args.steps + 1):
        b = next(gen)
        if args.mode == "forced":
            tr = port_from(jtr)
        t0 = time.perf_counter()
        ref_losses.append(float(jtr.train_step(b)))
        t1 = time.perf_counter()
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
    ref, port = np.array(ref_losses), np.array(port_losses)
    close = np.isclose(port, ref, **TOL)
    apart = [int(i) + 1 for i in np.flatnonzero(~close)]
    print(f"maxima: reference {ref.max():.6f} at step {ref.argmax() + 1}, "
          f"other {port.max():.6f} at step {port.argmax() + 1}")
    print(f"max |diff| {np.abs(port - ref).max():.3g}, max relative "
          f"{(np.abs(port - ref) / np.abs(ref)).max():.3g}; steps beyond "
          f"rtol 1e-4 atol 1e-6: {apart or 'none'}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": args.mode, "rows": args.rows,
                       "batch": args.batch, "reference": ref_losses,
                       "other": port_losses, "apart": apart,
                       "dense_rel_diff": dense_diff}, f, indent=1)


if __name__ == "__main__":
    main()
