"""End-to-end training CLI of the port (mirrors ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --method adpsgd --steps 200 --replicas 4 --backend vmap

Runs on the card; ``--device cpu`` runs on the CPU.  ``--method`` offers
the strategies the port has registered, ``--backend`` its backends.  The
reference's flags for parts not ported yet (telemetry clocks, checkpoints,
mesh placements, AdaComm, hierarchical periods) come with those parts.
``--no-reduced`` keeps the published widths and ``--layers`` cuts depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.backends import available_backends, make_backend
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import model as M
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.engine import PeriodicEval, TrainerEngine
from repro_torch.strategies import available_strategies, make_strategy


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--method", default="adpsgd",
                    choices=available_strategies())
    ap.add_argument("--backend", default="vmap",
                    choices=available_backends())
    ap.add_argument("--sync-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused mean+sqdev kernel in the sync (auto = on "
                         "whenever the parameters are on CUDA)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-replica batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="tiny smoke widths (--no-reduced: published widths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = keep)")
    ap.add_argument("--p-init", type=int, default=2)
    ap.add_argument("--p-const", type=int, default=8)
    ap.add_argument("--warmup-sync", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate the replica-averaged model every N steps")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace, callbacks=()):
    """The engine this CLI runs, and the model config it trains."""
    run = get_config(args.arch)
    cfg = reduced(run.model, max_seq_len=args.seq) if args.reduced \
        else dataclasses.replace(run.model, max_seq_len=args.seq)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    avg_cfg = AveragingConfig(
        method=args.method, p_init=args.p_init, p_const=args.p_const,
        warmup_full_sync_steps=args.warmup_sync, k_sample_frac=0.25)
    lr = args.lr if args.lr is not None else min(run.learning_rate, 0.05)
    lr_fn = make_lr_schedule(
        "step", lr, args.steps,
        decay_steps=(args.steps // 2, 3 * args.steps // 4))
    opt = get_optimizer(run.optimizer, momentum_coef=run.momentum)
    use_kernel = {"auto": None, "on": True, "off": False}[args.sync_kernel]
    backend = make_backend(args.backend, use_kernel=use_kernel,
                           device=args.device)

    data = SyntheticTokens(cfg.vocab_size, args.seq,
                           n_samples=args.replicas * args.batch * 64,
                           seed=args.seed)
    data_fn = data.batches(n_replicas=args.replicas,
                           per_replica_batch=args.batch,
                           device=backend.device)
    params0 = M.init_params(args.seed, cfg, device=backend.device)
    loss_fn = make_loss_fn(cfg)
    callbacks = list(callbacks)
    if args.eval_every:
        callbacks.append(PeriodicEval(
            loss_fn, lambda: data.eval_batches(batch=args.batch * 4,
                                               device=backend.device),
            every=args.eval_every))
    engine = TrainerEngine(
        loss_fn=loss_fn, optimizer=opt, params0=params0,
        n_replicas=args.replicas, data_fn=data_fn, lr_fn=lr_fn,
        avg_cfg=avg_cfg, total_steps=args.steps,
        strategy=make_strategy(avg_cfg, args.steps), backend=backend,
        callbacks=callbacks,
        track_variance_every=max(1, args.steps // 50), seed=args.seed)
    return engine, cfg


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    engine, cfg = build_engine(args)
    t0 = time.time()
    hist = engine.run()
    dt = time.time() - t0

    print(f"[{args.arch} / {args.method} / {args.backend}] "
          f"{args.steps} steps in {dt:.1f}s  ({engine.backend.describe()})")
    print(f"  loss {hist.losses[0]:.4f} -> "
          f"{np.mean(hist.losses[-10:]):.4f}")
    print(f"  syncs={hist.n_syncs} mean_period="
          f"{args.steps / max(1, hist.n_syncs):.2f} "
          f"final_p={hist.period_history[-1] if hist.period_history else 1}")
    if hist.evals:
        print(f"  evals={len(hist.evals)} last@step{hist.eval_steps[-1]}: "
              + " ".join(f"{k}={v:.4f}" for k, v in hist.evals[-1].items()))
    print(f"  weighted-avg Var[W_k] (paper Eq.9) = "
          f"{hist.weighted_avg_variance():.3e}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "method": args.method,
                       "backend": args.backend,
                       "evals": hist.evals, "eval_steps": hist.eval_steps,
                       "losses": hist.losses, "s_k": hist.s_k,
                       "sync_steps": hist.sync_steps,
                       "periods": hist.period_history,
                       "variances": hist.variances,
                       "variance_steps": hist.variance_steps}, f)
        print(f"  history -> {args.out}")
    return hist


if __name__ == "__main__":
    main()
