"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line's numbers.

Set-up makes the weights and batches from the seed (``inputs.py``),
builds the port's engine as ``repro_torch/launch/train.py::build_engine``
does (the same ``TrainerEngine``, strategy, backend and optimizer, with
the cell's traffic), and drives it through iterations 0-3 with
``TrainerEngine.run``: the first three are the ones the reference follows
(the program's losses, its first gradient as adamw's first moment holds
it, S_k at each sync, and each leaf's change after three steps are read
there), the fourth ends in a sync, so the window starts at a period's
start.  The window
calls ``run(k, 1)`` an iteration at a time and ends at the end of the
first sync after ``seconds``; its time runs from its start to that point,
after a synchronize.  A traced run wraps every program of
``engine.strategy.programs`` in a span that ends in a synchronize, and
profiles the device over the whole window (``devtrace.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from bench import devtrace, inputs
from bench.cells import Cell

# engine seeds: the port's key stream takes seed + 17 below 2^32
ENGINE_SEED_MOD = 1 << 31
WARM_STEPS = 4          # iterations 0-3; the reference follows 0-2
FOLLOWED = 3


@dataclass
class Readings:
    """What the program produced in its first three iterations, per
    replica (a list over this process's replicas) and per leaf."""
    losses: List[float]
    s_k: List[float]                  # at each sync among the three
    grad_norms: List[List[float]]
    delta_norms: List[List[float]]


@dataclass
class Run:
    """Everything a metric reader may read."""
    cell: Cell
    chips: int
    setup_s: float
    window_s: float
    steps: int
    syncs: int
    tokens: int
    peak_bytes: int
    flops_per_step: float
    leaf_shapes: List[tuple]          # one replica's leaves, in tree order
    spans: List[tuple] = field(default_factory=list)   # harness.Spans.records
    trace: Optional[devtrace.DeviceTrace] = None


def sync() -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def port_config(cell: Cell, strict: bool = True):
    """The port's ModelConfig for the cell, every size taken from the
    configuration file.  ``strict``: the port's own registered config
    must state the same sizes but for the depth (a port config that no
    longer matches the file fails the run rather than measuring another
    model)."""
    import inspect
    from repro_torch.configs import MLAConfig, get_config
    from repro_torch.models import layers
    c, t, tr = cell.config, cell.traffic, cell.config["training"]
    base = get_config(c["port_arch"]).model
    kw = dict(n_layers=c["num_hidden_layers"], max_seq_len=t["seq"],
              d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
              n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
              vocab_size=c["vocab_size"], rope_theta=float(c["rope_theta"]),
              tie_embeddings=c["tie_word_embeddings"],
              norm_eps=c.get("rms_norm_eps", c.get("norm_eps")),
              param_dtype=tr["param_dtype"], compute_dtype=tr["compute_dtype"],
              remat=tr["remat"], remat_policy=tr["remat_policy"])
    if c.get("kv_lora_rank"):
        d = c["moe_dispatch"]
        kw["mla"] = MLAConfig(
            kv_lora_rank=c["kv_lora_rank"], q_lora_rank=c["q_lora_rank"] or 0,
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"])
        kw["moe"] = dataclasses.replace(
            base.moe, n_experts=c["n_routed_experts"],
            top_k=c["num_experts_per_tok"],
            d_ff_expert=c["moe_intermediate_size"],
            n_shared_experts=c["n_shared_experts"],
            first_k_dense=c["first_k_dense_replace"],
            d_ff_dense=c["intermediate_size"],
            capacity_factor=d["capacity_factor"],
            router_aux_coef=d["router_aux_coef"],
            router_z_coef=d["router_z_coef"])
        group = inspect.signature(layers.moe_forward).parameters["group_size"]
        if group.default != d["group_size"]:
            raise RuntimeError(f"the port's MoE groups hold {group.default} "
                               f"tokens, the file says {d['group_size']}")
    cfg = dataclasses.replace(base, **kw)
    if strict:
        want = dataclasses.replace(base, n_layers=kw["n_layers"],
                                   max_seq_len=kw["max_seq_len"])
        if cfg != want:
            diff = {k: (getattr(want, k), getattr(cfg, k)) for k in kw
                    if getattr(want, k) != getattr(cfg, k)}
            raise RuntimeError(f"the port's config differs from the file "
                               f"(port, file): {diff}")
    return cfg


def check_layout(params: Dict, cfg) -> None:
    """The benchmark's tree must be the port's: the same leaves, shapes
    and dtypes in the same order (compared on the meta device)."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    ref = M.init_params(0, cfg, device="meta")
    a = [(tuple(x.shape), x.dtype) for x in tree_leaves(params)]
    b = [(tuple(x.shape), x.dtype) for x in tree_leaves(ref)]
    if a != b:
        raise RuntimeError("the benchmark's parameter tree differs from the "
                           "port's layout")


def build_engine(cell: Cell, cfg, params0, tokens, seed: int, device):
    """The engine ``launch/train.py::build_engine`` builds, from the
    cell's traffic: the strategy, the backend (vmap, or mesh over this
    job's ranks), adamw and the step schedule over ``total_steps``."""
    from repro_torch.backends import make_backend
    from repro_torch.configs import AveragingConfig, get_config
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.optim import get_optimizer, make_lr_schedule
    from repro_torch.runtime.engine import TrainerEngine
    from repro_torch.strategies import make_strategy
    t = cell.traffic
    run = get_config(cell.config["port_arch"])
    avg_cfg = AveragingConfig(
        method=t["method"], p_init=t["p_init"], p_const=t["p_const"],
        warmup_full_sync_steps=t["warmup_sync"],
        k_sample_frac=t["k_sample_frac"],
        qsgd_bits=t.get("qsgd_bits", 8))
    total = t["total_steps"]
    lr_fn = make_lr_schedule(t["lr_schedule"], t["lr"], total,
                             decay_steps=(total // 2, 3 * total // 4))
    opt = get_optimizer(run.optimizer, momentum_coef=run.momentum)
    kw = {"device": device}
    if t["backend"] == "mesh":
        kw = {"placement": t["placement"], "model_cfg": cfg,
              "device": device if torch.device(device).type == "cpu"
              else None}
    backend = make_backend(t["backend"], **kw)
    engine = TrainerEngine(
        loss_fn=make_loss_fn(cfg), optimizer=opt, params0=params0,
        n_replicas=t["replicas"],
        data_fn=lambda k: inputs.batch_of(tokens, k), lr_fn=lr_fn,
        avg_cfg=avg_cfg, total_steps=total,
        strategy=make_strategy(avg_cfg, total), backend=backend,
        seed=seed % ENGINE_SEED_MOD)
    return engine


def _leaf_norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(x.to(torch.float32)))
            for x in tensors]


def warm_up(engine, params_host: List[torch.Tensor], b1: float) -> Readings:
    """Iterations 0-3 through ``engine.run``, reading the program's
    numbers after the first and the third (S_k as the engine's history
    recorded it at each sync)."""
    from repro_torch.tree import tree_leaves
    engine.run(0, 1)
    m = tree_leaves(engine.opt_state["m"])
    n_local = m[0].shape[0]
    grads = [_leaf_norms([x[r] / (1.0 - b1) for x in m])
             for r in range(n_local)]
    engine.run(1, FOLLOWED - 1)
    W = tree_leaves(engine.W)
    deltas = [[] for _ in range(n_local)]
    for x, x0 in zip(W, params_host):
        x0 = x0.to(x.device)
        for r in range(n_local):
            deltas[r].append(float(torch.linalg.vector_norm(x[r] - x0)))
        del x0
    hist = engine.history
    losses = [float(v) for v in hist.losses[:FOLLOWED]]
    s_k = [s for s, at in zip(hist.s_k, hist.sync_steps) if at < FOLLOWED]
    engine.run(FOLLOWED, WARM_STEPS - FOLLOWED)
    return Readings(losses, s_k, grads, deltas)


class Spans:
    """The benchmark's spans around the strategy's programs: each call
    ends in a synchronize and records (name, iteration, start, end) on
    the host's clocks (``perf_counter`` and ``time_ns``)."""

    def __init__(self, engine):
        self.records: List[tuple] = []
        self.k = -1
        self.on = False
        progs = engine.strategy.programs
        for name, fn in list(progs.items()):
            progs[name] = self._wrap(name, fn)

    def _wrap(self, name, fn):
        def spanned(*args):
            if not self.on:
                return fn(*args)
            t0, n0 = time.perf_counter(), time.time_ns()
            out = fn(*args)
            sync()
            self.records.append((name, self.k, t0, time.perf_counter(), n0,
                                 time.time_ns()))
            return out
        return spanned


def window(engine, seconds: float, spans: Optional[Spans],
           decide: Callable[[bool], bool],
           tracer: Optional[devtrace.Tracer]) -> Dict[str, Any]:
    """Whole iterations from WARM_STEPS on, one ``run`` call each, until
    the end of the first sync after ``seconds``.  ``decide`` turns this
    process's "time is up" into the job's (rank 0's on a mesh)."""
    strategy = engine.strategy
    k = WARM_STEPS
    events0 = strategy.n_comm_events
    if tracer is not None:
        tracer.start()
    sync()
    if spans is not None:
        spans.on = True
    t0, n0 = time.perf_counter(), time.time_ns()
    ends = []
    while True:
        before = strategy.n_comm_events
        if spans is not None:
            spans.k = k
        engine.run(k, 1)
        k += 1
        ends.append(time.perf_counter() - t0)
        if strategy.n_comm_events == before:
            continue
        if decide(time.perf_counter() - t0 >= seconds):
            break
    sync()
    t1, n1 = time.perf_counter(), time.time_ns()
    if spans is not None:
        spans.on = False
    if tracer is not None:
        tracer.stop(n0, n1, spans.records)
    hist = engine.history
    return {"window_s": t1 - t0, "steps": k - WARM_STEPS,
            "syncs": strategy.n_comm_events - events0,
            "periods": [p for s, p in zip(hist.sync_steps,
                                          hist.period_history)
                        if s >= WARM_STEPS],
            "losses": hist.losses[WARM_STEPS:],
            "iteration_ends_s": ends}


def free_program(engine) -> None:
    """Drop the program's state so that the reference has the card."""
    engine.W = engine.opt_state = None
    engine.history.final_W = engine.history.final_opt = None
    strategy = engine.strategy
    if hasattr(strategy, "_anchor"):
        strategy._anchor = None
    gc.collect()
    torch.cuda.empty_cache()


def flops_per_step(cell: Cell) -> float:
    from bench import yardstick
    t = cell.traffic
    return (yardstick.train_flops_per_sequence(cell.config, t["seq"])
            * t["replicas"] * t["batch"])


def describe_window(w: Dict[str, Any], cell: Cell) -> str:
    t = cell.traffic
    return (f"window: {w['steps']} iterations ({FOLLOWED + 1} warm-up "
            f"before), {w['syncs']} syncs, periods {w['periods']}, "
            f"{w['window_s']:.3f} s, {t['replicas']} replicas x "
            f"{t['batch']} x {t['seq']} tokens a step")
