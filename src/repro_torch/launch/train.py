"""End-to-end training CLI of the port (mirrors ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --method adpsgd --steps 200 --replicas 4 --backend vmap
    PYTHONPATH=src python -m repro_torch.launch.train --method qsgd_periodic
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --backend mesh ...

Runs on the card; ``--device cpu`` runs on the CPU.  ``--method`` offers
every strategy of the reference, ``--backend`` the port's backends.
``--net`` binds a telemetry clock (``runtime/clock.py``): ``real`` times
each program on the device, ``10gbps`` / ``100gbps`` / ``<x>gbps``
simulate the paper's network.  ``--ckpt DIR`` writes a final
replica-averaged checkpoint; ``--ckpt-every N --ckpt-path DIR`` saves one
every N steps (``--no-keep-replicas``: replica-averaged export
checkpoints).  A run resumes through ``TrainerEngine.load_state``, as in
the reference.  ``--backend mesh`` spreads the replicas over the
processes of a ``torch.distributed.run`` launch, one GPU each (NCCL; gloo
with ``--device cpu``), or runs one process without a launcher; every
process prints nothing and writes nothing but the first (rank 0).
``--placement replica_tp`` spreads each replica over a model axis of
``--model-parallel`` ranks (0: the backend's default, 2 when the world is
even and above 1, else 1), with its leaves sharded by
``launch/sharding.py``'s rules; both flags are mesh-only.
``--no-reduced`` keeps the published widths and ``--layers`` cuts depth.
``--arch`` takes every config of ``repro_torch.configs`` (the Mamba
hybrid ``jamba-1.5-large-398b`` and ``xlstm-350m`` too).  A
mixture-of-experts config (``--arch mixtral-8x22b``,
``deepseek-v2-lite-16b``, ``jamba-1.5-large-398b``) adds its aux losses
to the loss; the run prints them at its first and last step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.backends import available_backends, make_backend
from repro_torch.checkpoint.io import save_checkpoint, strategy_state
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import model as M
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.clock import make_clock
from repro_torch.runtime.engine import (Callback, Checkpointer,
                                        PeriodicEval, TrainerEngine)
from repro_torch.strategies import available_strategies, make_strategy
from repro_torch.tree import tree_leaves


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--method", default="adpsgd",
                    choices=available_strategies())
    ap.add_argument("--backend", default="vmap",
                    choices=available_backends())
    ap.add_argument("--placement", default="replica_ddp",
                    choices=["replica_ddp", "replica_tp"],
                    help="mesh-backend replica layout: replica_ddp = each "
                         "replica is a whole model; replica_tp = one "
                         "replica spans the mesh's 'model' axis "
                         "(megatron-style tensor parallelism on DTensors)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="model-axis size of the mesh (0 = the backend's "
                         "default: 2 for replica_tp when the world is even "
                         "and above 1, else 1)")
    ap.add_argument("--sync-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="the CUDA kernels of the syncs and the QSGD step "
                         "(auto = on whenever the parameters are on CUDA)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--net", default="none",
                    help="telemetry clock: 'none', 'real' (WallClock: each "
                         "program timed to its end on the device), or "
                         "'10gbps'/'100gbps'/'<x>gbps' (SimulatedClock: "
                         "compute per step, communication from the "
                         "analytic model at that bandwidth)")
    ap.add_argument("--wallclock-sample-every", type=int, default=1,
                    help="with --net real: wait for the device only every "
                         "N steps and interpolate the Timeline in between "
                         "(1 = every program)")
    ap.add_argument("--adacomm-mode", default="iterations",
                    choices=["iterations", "time"],
                    help="adacomm block: 'iterations' (an interval of "
                         "steps) or 'time' (t0-second blocks on the --net "
                         "clock, the paper's form)")
    ap.add_argument("--adacomm-t0", type=float, default=1.0,
                    help="seconds per adacomm_mode=time block")
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
    ap.add_argument("--inner-period", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="write a final checkpoint (replica-averaged) here")
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate the replica-averaged model every N steps")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (needs --ckpt-path)")
    ap.add_argument("--ckpt-path", default=None,
                    help="directory for --ckpt-every checkpoints")
    ap.add_argument("--keep-replicas", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="periodic checkpoints keep the stacked replica "
                         "axis (resumable); --no-keep-replicas writes "
                         "replica-averaged export checkpoints")
    args = ap.parse_args(argv)
    if args.adacomm_mode == "time" and args.net in ("", "none"):
        ap.error("--adacomm-mode time needs a clock: pass --net "
                 "real|10gbps|100gbps|<x>gbps")
    if args.ckpt_every and not args.ckpt_path:
        ap.error("--ckpt-every needs --ckpt-path")
    if args.backend != "mesh" and (args.placement != "replica_ddp"
                                   or args.model_parallel):
        ap.error("--placement/--model-parallel are mesh-backend options "
                 "(use --backend mesh)")
    return args


class AuxLog(Callback):
    """Each step's replica-mean MoE aux losses (``moe_load_balance``,
    ``moe_z_loss``), kept on the device until the run ends, so that no
    step waits for them."""

    def __init__(self):
        self._aux = []

    def on_step_end(self, engine, k, metrics):
        self._aux.append({n: v for n, v in metrics.items()
                          if n.startswith("moe_")})

    def history(self):
        return [{n: float(v) for n, v in a.items()} for a in self._aux]


def build_engine(args: argparse.Namespace, callbacks=()):
    """The engine this CLI runs, and the model config it trains."""
    run = get_config(args.arch)
    cfg = reduced(run.model, max_seq_len=args.seq) if args.reduced \
        else dataclasses.replace(run.model, max_seq_len=args.seq)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    avg_cfg = AveragingConfig(
        method=args.method, p_init=args.p_init, p_const=args.p_const,
        warmup_full_sync_steps=args.warmup_sync, k_sample_frac=0.25,
        inner_period=args.inner_period, adacomm_mode=args.adacomm_mode,
        adacomm_t0=args.adacomm_t0)
    clock = make_clock(args.net,
                       wallclock_sample_every=args.wallclock_sample_every)
    lr = args.lr if args.lr is not None else min(run.learning_rate, 0.05)
    lr_fn = make_lr_schedule(
        "step", lr, args.steps,
        decay_steps=(args.steps // 2, 3 * args.steps // 4))
    opt = get_optimizer(run.optimizer, momentum_coef=run.momentum)
    use_kernel = {"auto": None, "on": True, "off": False}[args.sync_kernel]
    mesh_kw = ({"placement": args.placement, "model_cfg": cfg,
                "model_parallel": args.model_parallel or None}
               if args.backend == "mesh" else {})
    backend = make_backend(args.backend, use_kernel=use_kernel,
                           device=args.device, **mesh_kw)

    data = SyntheticTokens(cfg.vocab_size, args.seq,
                           n_samples=args.replicas * args.batch * 64,
                           seed=args.seed)
    data_fn = data.batches(n_replicas=args.replicas,
                           per_replica_batch=args.batch,
                           device=backend.device)
    params0 = M.init_params(args.seed, cfg, device=backend.device)
    loss_fn = make_loss_fn(cfg)
    callbacks = list(callbacks)
    if cfg.moe is not None:
        callbacks.append(AuxLog())
    if args.eval_every:
        callbacks.append(PeriodicEval(
            loss_fn, lambda: data.eval_batches(batch=args.batch * 4,
                                               device=backend.device),
            every=args.eval_every))
    if args.ckpt_every:
        callbacks.append(Checkpointer(args.ckpt_path, every=args.ckpt_every,
                                      keep_replicas=args.keep_replicas))
    engine = TrainerEngine(
        loss_fn=loss_fn, optimizer=opt, params0=params0,
        n_replicas=args.replicas, data_fn=data_fn, lr_fn=lr_fn,
        avg_cfg=avg_cfg, total_steps=args.steps,
        strategy=make_strategy(avg_cfg, args.steps), backend=backend,
        clock=clock, callbacks=callbacks,
        track_variance_every=max(1, args.steps // 50), seed=args.seed)
    return engine, cfg


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    engine, cfg = build_engine(args)
    try:
        return report(args, engine)
    finally:
        engine.backend.close()


def report(args: argparse.Namespace, engine: TrainerEngine):
    """Run, then print the run's summary and write its outputs (on the
    backend's writer process alone)."""
    t0 = time.time()
    hist = engine.run()
    dt = time.time() - t0
    backend = engine.backend
    if args.ckpt:          # collectives: every process takes part
        final = backend.collapse(hist.final_W)
        state = strategy_state(engine.strategy)
    by_rank = backend.rank_bytes(hist.final_W)
    if not backend.is_writer:
        return hist

    print(f"[{args.arch} / {args.method} / {args.backend}] "
          f"{args.steps} steps in {dt:.1f}s  ({engine.backend.describe()})")
    print(f"  loss {hist.losses[0]:.4f} -> "
          f"{np.mean(hist.losses[-10:]):.4f}")
    print(f"  syncs={hist.n_syncs} mean_period="
          f"{args.steps / max(1, hist.n_syncs):.2f} "
          f"final_p={hist.period_history[-1] if hist.period_history else 1}")
    if hist.inner_sync_steps:
        print(f"  inner_syncs={len(hist.inner_sync_steps)}")
    aux = next((cb.history() for cb in engine.callbacks
                if isinstance(cb, AuxLog)), [])
    if aux:
        first, last = aux[0], aux[-1]
        print("  aux " + " ".join(
            f"{n} {first[n]:.5f} -> {last[n]:.5f}" for n in sorted(first)))
    if backend.world > 1:
        whole = sum(math.prod(s) * x.element_size() for s, x in zip(
            backend.whole_shapes(hist.final_W), tree_leaves(hist.final_W)))
        print(f"  parameter bytes by rank: {by_rank} (one replica whole: "
              f"{whole // backend.n_local} B)")
    leaves = tree_leaves(hist.final_W)
    op = engine.strategy.sync_op()
    per_event = op.wire_bytes(backend.n_params(hist.final_W),
                              args.replicas, n_tensors=len(leaves))
    print(f"  wire: {op.name} ({op.wire.kind}, {op.wire.bits} bits) "
          f"{per_event:.3e} B/node per event x {hist.n_syncs} events")
    if hist.evals:
        print(f"  evals={len(hist.evals)} last@step{hist.eval_steps[-1]}: "
              + " ".join(f"{k}={v:.4f}" for k, v in hist.evals[-1].items()))
    print(f"  weighted-avg Var[W_k] (paper Eq.9) = "
          f"{hist.weighted_avg_variance():.3e}")
    if hist.timing:
        t = hist.timing
        print(f"  [{t['clock']} clock / {args.net}] "
              f"compute={t['compute_s']:.3f}s comm={t['comm_s']:.3f}s "
              f"total={t['sim_wall_s']:.3f}s "
              f"bytes/node={t['bytes']:.3e}")
    if args.ckpt:
        save_checkpoint(args.ckpt, final, step=args.steps,
                        controller_state=state)
        print(f"  checkpoint -> {args.ckpt}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "method": args.method,
                       "backend": args.backend,
                       "evals": hist.evals, "eval_steps": hist.eval_steps,
                       "losses": hist.losses, "s_k": hist.s_k,
                       "sync_steps": hist.sync_steps,
                       "periods": hist.period_history,
                       "inner_sync_steps": hist.inner_sync_steps,
                       "variances": hist.variances,
                       "variance_steps": hist.variance_steps,
                       "timing": hist.timing}, f)
        print(f"  history -> {args.out}")
    return hist


if __name__ == "__main__":
    main()
