"""The process groups of the mesh tests (``tests/test_torch_mesh*.py``).

``Group(world, scenarios, tmp_path)`` starts ``world`` processes of this
file as a script, one rank each, joined in a gloo group on a
``FileStore`` under ``tmp_path``; its ``wait()`` returns the ranks'
results, so the parent can compute its own baselines meanwhile.  Every rank runs each scenario through
the port (the mesh backend, and the vmap backend where a scenario asks)
and pickles its results; the parent reads every rank's.  The ranks import
the port alone, never jax, pin torch to one thread (the test runner's
workers share the host's cores) and leave nothing running: a group that
outlives its timeout is killed and its test fails.

A scenario is a dict: ``kind`` (a function of ``SCENARIOS``), ``name``
(its key in the results) and the kind's settings.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# the reference's setup8 (tests/test_backends.py): the CNN, widths (8, 16),
# SyntheticImages(256, seed 0), momentum, R = 8, batch 4; narrow OLMo:
# reduced olmo-1b (2 layers, d_model 128), seq 32, adamw, R = 4, batch 4
AVG = dict(p_init=2, p_const=4, k_sample_frac=0.25, warmup_full_sync_steps=2,
           inner_period=2, adacomm_interval=4, dasgd_delay=2)
# cnn16: the reference's placement matrix (tests/test_placements.py: 16
# steps, decay at 10); family: its reduced-transformer family cells (R = 4,
# batch 2, seq 32, momentum, lr 0.01, 6 steps), ``sc["arch"]`` the config
MODELS = {"cnn": dict(R=8, opt="momentum", lr=0.05, steps=24, decay=(14,)),
          "cnn16": dict(R=8, opt="momentum", lr=0.05, steps=16, decay=(10,)),
          "olmo": dict(R=4, opt="adamw", lr=4e-4, steps=16, decay=(8, 12)),
          "family": dict(R=4, opt="momentum", lr=0.01, steps=6, decay=())}
FAMILY_AVG = dict(method="adpsgd", p_init=2, warmup_full_sync_steps=2,
                  k_sample_frac=0.5)


class Group:
    """``world`` rank processes running ``scenarios``."""

    def __init__(self, world: int, scenarios, tmp_path,
                 timeout: float = TIMEOUT_S):
        self.world, self.timeout = world, timeout
        self.tmp = Path(tmp_path) / f"group{world}-{id(self)}"
        self.tmp.mkdir(parents=True)
        spec = self.tmp / "spec.pkl"
        spec.write_bytes(pickle.dumps(scenarios))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world),
             str(self.tmp / "store"), str(spec),
             str(self.tmp / f"out{r}.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def wait(self):
        """One {name: result} per rank; kills every rank still running
        at the timeout and raises with the ranks' output on a failure."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs)
               if p.returncode]
        if bad:
            raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(
                f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
        return [pickle.loads((self.tmp / f"out{r}.pkl").read_bytes())
                for r in range(self.world)]



# ------------------------------------------------------------------ ranks
def _setup(sc):
    """(loss_fn, optimizer, params0, data_fn, lr_fn, R, steps) of a
    scenario's model, its parameters from ``sc["params"]`` (numpy)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticImages, SyntheticTokens
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.optim import get_optimizer, make_lr_schedule

    m = MODELS[sc["model"]]
    R, steps = sc.get("R", m["R"]), sc.get("steps", m["steps"])
    lr_fn = make_lr_schedule("step", m["lr"], steps, decay_steps=m["decay"])
    if sc["model"].startswith("cnn"):
        loss_fn = cnn_loss
        data_fn = SyntheticImages(n_samples=256, seed=0).batches(
            n_replicas=R, per_replica_batch=4, device="cpu")
    elif sc["model"] == "family":
        cfg = model_cfg(sc)
        loss_fn = make_loss_fn(cfg)
        data_fn = family_data(cfg, R)
        lr_fn = (lambda k: m["lr"])
    else:
        cfg = model_cfg(sc)
        loss_fn = make_loss_fn(cfg)
        data_fn = SyntheticTokens(cfg.vocab_size, 32, n_samples=R * 4 * 64,
                                  seed=0).batches(
            n_replicas=R, per_replica_batch=4, device="cpu")
    return (loss_fn, get_optimizer(sc.get("opt", m["opt"])),
            params_from_numpy(sc["params"], "cpu"), data_fn, lr_fn, R, steps)


def model_cfg(sc):
    """The scenario's reduced transformer config (None for the CNN)."""
    from repro_torch.configs import get_config, reduced
    if sc.get("model", "cnn").startswith("cnn"):
        return None
    arch = sc.get("arch", "olmo-1b")
    return reduced(get_config(arch).model, max_seq_len=32,
                   **sc.get("overrides", {}))


def family_data(cfg, R):
    """The family cells' batches: SyntheticTokens(vocab, 32, 64 samples,
    seed 0), batch 2 a replica; an encoder-decoder adds seeded frames
    (``RandomState(1000 + k)``, as the reference's test draws them)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    base = SyntheticTokens(cfg.vocab_size, 32, n_samples=64, seed=0).batches(
        n_replicas=R, per_replica_batch=2, device="cpu")
    if cfg.encoder is None:
        return base

    def data_fn(k):
        b = dict(base(k))
        rng = np.random.RandomState(1000 + k)
        b["frames"] = torch.from_numpy(0.1 * rng.randn(
            R, 2, cfg.encoder.n_frames, cfg.d_model).astype("float32"))
        return b
    return data_fn


def backend_kw(sc, name="mesh"):
    """The mesh backend's placement settings of a scenario."""
    if name != "mesh" or "placement" not in sc:
        return {}
    return {"placement": sc["placement"], "model_parallel": sc.get("mp"),
            "model_cfg": model_cfg(sc)}


def make_engine(sc, backend=None, callbacks=(), clock=None):
    """The scenario's engine on ``backend`` (default: its ``backend``
    setting, "mesh" or "vmap", on the CPU) and ``clock`` (default: a
    SimulatedClock on the scenario's ``clock`` network, or none)."""
    from repro_torch.backends import make_backend
    from repro_torch.configs import AveragingConfig
    from repro_torch.runtime import clock as clk
    from repro_torch.runtime.engine import TrainerEngine

    loss_fn, opt, params0, data_fn, lr_fn, R, steps = _setup(sc)
    if backend is None:
        name = sc.get("backend", "mesh")
        backend = make_backend(name, device="cpu",
                               use_kernel=sc.get("use_kernel"),
                               **backend_kw(sc, name))
    cfg = (dict(FAMILY_AVG) if sc["model"] == "family"
           else dict(AVG, method=sc["method"]))
    cfg.update(sc.get("avg", {}))
    return TrainerEngine(
        loss_fn=loss_fn, optimizer=opt, params0=params0, n_replicas=R,
        data_fn=data_fn, lr_fn=lr_fn, avg_cfg=AveragingConfig(**cfg),
        total_steps=steps, backend=backend,
        clock=clock or (clk.SimulatedClock(sc["clock"]) if sc.get("clock")
                        else None),
        callbacks=list(callbacks))


def history(engine, hist):
    """The run's history and its final W over every replica (numpy)."""
    return {"losses": list(hist.losses), "s_k": list(hist.s_k),
            "sync_steps": list(hist.sync_steps),
            "periods": list(hist.period_history),
            "inner_sync_steps": list(hist.inner_sync_steps),
            "n_syncs": hist.n_syncs,
            "sim_wall_s": (hist.timing or {}).get("sim_wall_s"),
            "W": [x.numpy() for x in _leaves(engine.backend.get(engine.W))]}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def train(sc):
    """One run to the end (with ``sc["vmap_too"]``, also the vmap
    backend's run in this process, for the bitwise comparison)."""
    from repro_torch.backends import make_backend
    out = {}
    for name in ("mesh", "vmap") if sc.get("vmap_too") else ("mesh",):
        engine = make_engine(sc, make_backend(
            name, device="cpu", use_kernel=sc.get("use_kernel"),
            **backend_kw(sc, name)))
        out[name] = history(engine, engine.run())
        if name == "mesh":
            out["local_bytes"] = local_bytes(engine)
    return out


def skewed_clock(skew: float):
    """A wall clock (``kind == "wall"``) that reads ``skew`` seconds later
    at each read: processes given different skews see time pass at
    different rates, deterministically."""
    from repro_torch.runtime.clock import WallClock

    class SkewedClock(WallClock):
        def __init__(self):
            super().__init__()
            self.reads = 0

        def now(self) -> float:
            self.reads += 1
            return skew * self.reads

    return SkewedClock()


def adacomm_wall(sc):
    """AdaComm on time blocks under a wall clock of this rank's skew
    (``sc["skew"][rank]``) on the mesh: the history and the final W."""
    import torch.distributed as dist
    engine = make_engine(sc, clock=skewed_clock(sc["skew"][dist.get_rank()]))
    return history(engine, engine.run())


def local_bytes(engine):
    """(this rank's bytes of W, one replica's whole bytes × its local
    replicas, the bytes of the leaves the model axis shards)."""
    b = engine.backend
    leaves = _leaves(engine.W)
    whole = b.whole_shapes(engine.W)
    dims = b._dims(engine.W)
    size = [x.element_size() for x in leaves]
    import math
    return {"local": sum(x.numel() * e for x, e in zip(leaves, size)),
            "whole": sum(math.prod(s) * e for s, e in zip(whole, size)),
            "sharded_whole": sum(math.prod(s) * e for s, e, d in
                                 zip(whole, size, dims) if d is not None),
            "m": b.m}


class Counter:
    """Every torch.distributed collective call, with its op and the bytes
    of the tensors handed to it, in ``calls``."""

    OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
           "broadcast", "reduce_scatter", "reduce", "gather", "scatter",
           "all_to_all", "barrier")

    def __init__(self):
        import torch.distributed as dist
        self.calls = []
        self.groups = []
        self._orig = {}
        for op in self.OPS:
            fn = getattr(dist, op, None)
            if fn is not None:
                self._orig[op] = fn
                setattr(dist, op, self._wrap(op, fn))

    def _wrap(self, op, fn):
        import torch

        def call(*a, **kw):
            t = a[1] if op in ("all_gather", "all_gather_into_tensor") \
                else (a[0] if a else None)
            n = t.numel() * t.element_size() if isinstance(
                t, torch.Tensor) else 0
            self.calls.append((op, n))
            self.groups.append(kw.get("group"))
            return fn(*a, **kw)
        return call

    def close(self):
        import torch.distributed as dist
        for op, fn in self._orig.items():
            setattr(dist, op, fn)


def group_name(mesh, group):
    """'data', 'model' or 'world' (a data group that is the world, as at
    model size 1, is 'data')."""
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        group = mesh.group
    if group is mesh.data_group:
        return "data"
    if group is mesh.model_group:
        return "model"
    if group is mesh.group:
        return "world"
    return "sub"


def counts(sc):
    """Collective calls per program invocation on a short run: for each
    call of each program, (program, [(op, bytes)], metrics-mean calls).
    The metrics mean (``MeshBackend._metrics_mean``) is counted apart:
    it is the step's one small all-reduce, outside the local step."""
    from repro_torch.backends.mesh import MeshBackend

    engine = make_engine(sc)
    backend = engine.backend
    counter = Counter()
    in_metrics = [0]
    metrics_mean = backend._metrics_mean

    def tagged(m):
        in_metrics[0] += 1
        return metrics_mean(m)
    backend._metrics_mean = tagged
    log, groups = [], []
    for name, fn in list(engine.strategy.programs.items()):
        def wrapped(*a, _fn=fn, _name=name):
            before, tag = len(counter.calls), in_metrics[0]
            out = _fn(*a)
            log.append((_name, counter.calls[before:], in_metrics[0] - tag))
            groups.append([group_name(backend.mesh, g)
                           for g in counter.groups[before:]])
            return out
        engine.strategy.programs[name] = wrapped
    try:
        hist = engine.run()
    finally:
        counter.close()
    leaves = _leaves(engine.W)
    import torch.distributed as dist
    return {"log": log, "groups": groups, "n_leaves": len(leaves),
            "n_params": backend.n_params(engine.W),
            "n_local": backend.n_local, "is_mesh": isinstance(backend,
                                                              MeshBackend),
            "subgroups": {k: dist.get_process_group_ranks(g) for k, g in
                          getattr(backend, "_subgroups", {}).items()},
            **history(engine, hist)}


def exchange(sc):
    """One byte-true exchange on a seeded W (every rank draws all R and
    keeps its rows), against the vmap backend's on the same inputs in
    this process; the bytes handed to all_gather."""
    import numpy as np
    import torch
    from repro_torch.backends import make_backend
    from repro_torch.core import prng
    from repro_torch.tree import tree_map

    rng = np.random.RandomState(0)
    R = sc["R"]
    W = tree_map(lambda x: torch.from_numpy(
        np.broadcast_to(x.numpy()[None], (R,) + tuple(x.shape))
        + 0.01 * rng.randn(R, *x.shape).astype(np.float32)),
        _params(sc))
    key = prng.prng_key(42)
    out = {}
    for name in ("mesh", "vmap"):
        b = make_backend(name, device="cpu", use_kernel=sc.get("use_kernel"),
                         **backend_kw(sc, name))
        b.bind(R)
        anchor = tree_map(lambda x: x.mean(dim=0), W)
        Wb = b.put_params(b.own(b.local_replicas(W)))
        counter = Counter()
        try:
            Wn, an, s_k = b.quantized_all_mean(8)(Wb, anchor, key)
        finally:
            counter.close()
        out[name] = {"W": [x.numpy() for x in _leaves(b.get(Wn))],
                     "anchor": [x.numpy() for x in _leaves(an)],
                     "s_k": float(s_k), "calls": counter.calls,
                     "n_local": b.n_local}
    leaves = _leaves(W)
    out["n_params"] = sum(x[0].numel() for x in leaves)
    out["n_tensors"] = len(leaves)
    return out


def _params(sc):
    from repro_torch.interop import params_from_numpy
    return params_from_numpy(sc["params"], "cpu")


def inflight(sc):
    """DaSGD's snapshot on the mesh: dispatched, W written by a step, then
    fetched; the fetched (delta, S_k) against the vmap backend's snapshot
    of the pre-step W over every replica."""
    import torch
    from repro_torch.backends import make_backend
    from repro_torch.backends.ops import Deferred, InFlightOp
    from repro_torch.tree import tree_map

    engine = make_engine(sc)
    engine.run(num_steps=3)            # replicas apart
    b = engine.backend
    before = b.get(engine.W)           # every replica, on the host
    inflight_op = b.mean_delta(overlap=True)(engine.W)
    pending = (isinstance(inflight_op, InFlightOp)
               and not inflight_op.fetched
               and isinstance(inflight_op._outputs, Deferred))
    for x in _leaves(engine.W):        # a local step writes W meanwhile
        x.add_(1.0)
    delta, s_k = inflight_op.fetch()
    v = make_backend("vmap", device="cpu", use_kernel=sc.get("use_kernel"))
    v.bind(b.n_replicas)
    want, want_s_k = v.mean_delta()(tree_map(torch.clone, before))
    return {"pending_before_fetch": pending,
            "fetched": inflight_op.fetched,
            "delta": [x.numpy() for x in _leaves(b.get(delta))],
            "want": [x.numpy() for x in _leaves(want)],
            "s_k": float(s_k), "want_s_k": float(want_s_k)}


def save_half(sc):
    """Run ``sc["half"]`` steps and checkpoint them (``Checkpointer.save``:
    every rank gathers, the writer writes) into ``sc["path"]``."""
    from repro_torch.runtime.engine import Checkpointer
    engine = make_engine(sc)
    hist = engine.run(num_steps=sc["half"])
    in_flight = getattr(engine.strategy, "_apply_at", None)
    Checkpointer(sc["path"], 1).save(engine, sc["half"])
    return dict(history(engine, hist), in_flight=in_flight)


def resume(sc):
    """Load ``sc["path"]`` (every rank its rows) and run to the end."""
    from repro_torch.checkpoint.io import load_checkpoint
    engine = make_engine(sc)
    W, opt_state, meta = load_checkpoint(sc["path"], "cpu")
    engine.load_state(W, opt_state, strategy_state=meta["controller"],
                      clock_state=meta.get("clock"))
    restored = {"pending": getattr(engine.strategy, "_pending", None)
                is not None,
                "anchor": getattr(engine.strategy, "_anchor", None)
                is not None}
    return dict(history(engine, engine.run(start_step=meta["step"])),
                restored=restored)


def cli(sc):
    """The training CLI's engine (``train.build_engine``), run here."""
    from repro_torch.launch import train as cli_mod
    engine, _ = cli_mod.build_engine(cli_mod.parse_args(sc["argv"]))
    return history(engine, engine.run())


def topology(sc):
    """The mesh's guards and layout: ``bind`` of an R the ranks do not
    divide, ``describe``, and a two-pod production mesh's group size
    (``LOCAL_WORLD_SIZE`` = ``sc["per_node"]``)."""
    from repro_torch.backends.mesh import MeshBackend
    from repro_torch.launch import mesh as mesh_mod

    b = MeshBackend(device="cpu")
    try:
        b.bind(b.world + 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    b.bind(2 * b.world)
    tp = tp_builds()
    os.environ["LOCAL_WORLD_SIZE"] = str(sc["per_node"])
    pods = MeshBackend(mesh_mod.make_production_mesh(multi_pod=True,
                                                     device="cpu"))
    pods.bind(2 * b.world)
    return {"refused": refused, "describe": b.describe(),
            "default_group_size": b.default_group_size(),
            "pods_shape": dict(pods.mesh.shape),
            "pods_replicas": {plan: mesh_mod.n_replicas_for(pods.mesh, plan,
                                                            True)
                              for plan in ("replica_ddp", "fsdp")},
            "pods_group_size": pods.default_group_size(),
            "replicas": list(mesh_mod.replica_range(b.mesh, 2 * b.world)),
            **tp}


def tp_builds():
    """What the ``replica_tp`` calls build on this world: the backend at
    its default model size and with ``model_parallel=2``, the host mesh
    of model size 2, and the refusal of ``replica_tp`` on a mesh with no
    ``model`` axis."""
    import torch
    import torch.distributed as dist
    from repro_torch.backends.mesh import MeshBackend
    from repro_torch.launch import mesh as mesh_mod

    tp = MeshBackend(placement="replica_tp", device="cpu")
    tp.bind(8)
    mp2 = MeshBackend(model_parallel=2, device="cpu")
    host = mesh_mod.make_host_mesh(2, device="cpu")
    flat = mesh_mod.ReplicaMesh({"data": tp.world}, tp.rank, tp.world,
                                dist.group.WORLD, torch.device("cpu"))
    try:
        MeshBackend(flat, placement="replica_tp")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"tp_describe": tp.describe(), "mp2_describe": mp2.describe(),
            "tp_replicas": list(tp._ids()),
            "host_shape": dict(host.shape),
            "host_index": (host.data_index, host.model_index),
            "host_model_ranks": dist.get_process_group_ranks(
                host.model_group),
            "host_data_ranks": dist.get_process_group_ranks(
                host.data_group),
            "refused_no_model": refused}


def tp_fallback(sc):
    """One replica's loss and gradients through ``ModelShards`` on a
    column-sharded leaf, with a function DTensor has no strategy for
    (``Tensor.unfold``) and an einsum over the shard, against the plain
    computation on the whole leaf; the functions run on whole operands."""
    import torch
    from repro_torch.backends.mesh import MeshBackend
    from repro_torch.core import averaging as avg
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(0)
    params = {"fc1": {"w": torch.randn(8, 6, generator=gen),
                      "b": torch.randn(6, generator=gen)}}

    def loss_fn(p, batch):
        w = p["fc1"]["w"]
        u = w.unfold(1, 2, 2)
        loss = (u.square().sum() + (batch["x"] @ w + p["fc1"]["b"]).sum()
                + torch.einsum("ij,ik->jk", w, w).sum())
        return loss, {"u": u.sum()}

    b = MeshBackend(placement="replica_tp", model_parallel=sc["mp"],
                    device="cpu")
    b.bind(b.n_replica_devices)
    W = b.stack_params(params)
    batch = {"x": torch.randn(3, 8, generator=gen)}
    shards = b._shards().bind(W)
    loss, aux, grads = avg.value_and_grad(loss_fn, avg.replica_view(W, 0),
                                          batch, shards)
    whole = shards.whole([g.unsqueeze(0) for g in _leaves(grads)],
                         stacked=True)
    ploss, paux, pgrads = avg.value_and_grad(
        loss_fn, tree_map(torch.clone, params), batch)
    return {"loss": float(loss), "plain_loss": float(ploss),
            "u": float(aux["u"]), "plain_u": float(paux["u"]),
            "grads": [g[0].numpy() for g in whole],
            "plain_grads": [g.numpy() for g in _leaves(pgrads)],
            "whole": dict(b.whole)}


def remat(sc):
    """The scenario's run on each placement of ``sc["placements"]`` with
    remat off and with each policy of ``sc["policies"]`` (the layers
    grouped as ``scan_layers`` groups them; ``replica_tp`` on a model axis
    of ``sc["mp"]``, ``replica_ddp`` on data ranks alone): {placement:
    {policy or "off": its history}}."""
    out = {}
    for placement in sc["placements"]:
        out[placement] = {}
        for policy in ("off",) + tuple(sc["policies"]):
            over = dict(scan_layers=True, remat=policy != "off")
            if policy != "off":
                over["remat_policy"] = policy
            mp = sc["mp"] if placement == "replica_tp" else None
            engine = make_engine(dict(sc, placement=placement, mp=mp,
                                      overrides=over))
            out[placement][policy] = history(engine, engine.run())
    return out


def phases(sc):
    """The scenario's run with the engine's phase recorder
    (``runtime/phases.py``) off, then on: each run's history, final W and
    this rank's optimizer state, and the phases the recorder recorded in
    each iteration, with their counts."""
    out = {}
    for on in (False, True):
        engine = make_engine(sc)
        engine.phases.on = on
        hist = engine.run()
        counts_by_k = {}
        for r in engine.phases.records:
            c = counts_by_k.setdefault(r.k, {})
            c[r.name] = c.get(r.name, 0) + 1
        out[on] = dict(history(engine, hist), counts=counts_by_k,
                       opt=[x.numpy() for x in _leaves(engine.opt_state)])
    return out


SCENARIOS = {"train": train, "counts": counts, "exchange": exchange,
             "inflight": inflight, "save_half": save_half, "resume": resume,
             "cli": cli, "topology": topology, "tp_fallback": tp_fallback,
             "remat": remat,
             "adacomm_wall": adacomm_wall, "phases": phases}


def main(rank: int, world: int, store: str, spec: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        results = {}
        for sc in pickle.loads(Path(spec).read_bytes()):
            results[sc["name"]] = SCENARIOS[sc["kind"]](sc)
        Path(out).write_bytes(pickle.dumps(results))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
