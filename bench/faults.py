"""Faults planted in the program, for the checks that the comparison
fails them (``calibrate.py`` on the card, ``test_bench_faults.py`` on the
CPU).  Each is a context manager that patches the port while an engine is
built and run, and undoes the patch on exit."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def half_batch():
    """Every replica's loss is the mean over half of its batch: the first
    half of the rows, or of the tokens where a replica has one row."""
    from repro_torch.models import model as M
    orig = M.lm_loss

    def lm_loss(params, batch, cfg):
        tokens = batch["tokens"]
        b, S = tokens.shape
        tokens = tokens[: b // 2] if b > 1 else tokens[:, : S // 2]
        return orig(params, dict(batch, tokens=tokens), cfg)

    M.lm_loss = lm_loss
    try:
        yield
    finally:
        M.lm_loss = orig


@contextlib.contextmanager
def no_exchange():
    """The syncs average nothing: every replica keeps its own parameters
    (the vmap backend's mean, the mesh's all-reduce and the quantized
    exchange left out; the anchor stays where it was)."""
    from repro_torch.backends import mesh, vmap

    def lower_mean(self, op, *, sync_momentum=False):
        def all_mean(W, opt_state):
            return W, opt_state, torch.zeros((), device=self.device)
        return all_mean

    def lower_quantized(self, op):
        def qsync(W, anchor, key):
            return W, anchor, torch.zeros((), device=self.device)
        return qsync

    patches = [(cls, name, fn) for cls in (vmap.VmapBackend,
                                           mesh.MeshBackend)
               for name, fn in (("_lower_all_mean", lower_mean),
                                ("_lower_quantized_all_mean",
                                 lower_quantized))]
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patches]
    for cls, name, fn in patches:
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


@contextlib.contextmanager
def no_sqdev():
    """The syncs average as they should but report S_k as 0: the sqdev
    half of the mean + sqdev kernel (and on a mesh the S_k all-reduce)
    left out."""
    from repro_torch.backends import mesh, vmap

    def zero_s_k(lower):
        def lowered(self, op, **kw):
            fn = lower(self, op, **kw)

            def sync(*args):
                *out, s_k = fn(*args)
                return (*out, torch.zeros_like(torch.as_tensor(s_k)))
            return sync
        return lowered

    names = ("_lower_all_mean", "_lower_quantized_all_mean")
    saved = [(cls, name, getattr(cls, name))
             for cls in (vmap.VmapBackend, mesh.MeshBackend)
             for name in names]
    for cls, name, fn in saved:
        setattr(cls, name, zero_s_k(fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


@contextlib.contextmanager
def state_unchanged():
    """The local step computes its loss and gradients but returns the
    parameters and the optimizer state as they were."""
    from repro_torch.core import averaging as avg
    from repro_torch.optim.optimizers import Optimizer
    orig = avg.make_local_step

    def make_local_step(loss_fn, optimizer, tp=None):
        idle = Optimizer(optimizer.name, optimizer.init,
                         lambda grads, state, params, lr: (params, state))
        return orig(loss_fn, idle, tp)

    avg.make_local_step = make_local_step
    try:
        yield
    finally:
        avg.make_local_step = orig


FAULTS = {"half_batch": half_batch, "no_exchange": no_exchange,
          "no_sqdev": no_sqdev, "state_unchanged": state_unchanged}
