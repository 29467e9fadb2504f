"""What the benchmark knows of each model family, one module a family:
``bench/archs/<model_type>.py``, found by the configuration file's
``model_type``.  Each module provides

* ``port_config_kwargs(cfg, traffic, base)``: the port's ``ModelConfig``
  fields for the file's model sizes (``base`` is the port's registered
  config; the harness adds depth, sequence length and the training
  group's dtypes and remat);
* ``param_specs(cfg)``: every leaf of the model's tree in draw order, as
  (path, shape, scale of its standard normal draw; 0 for a norm scale,
  which starts at 1), and ``empty_tree(cfg)``, the tree's containers;
* ``matmul_macs_per_token(cfg)``: the multiply-adds of every weight
  matrix a token passes in a forward pass, and
  ``mixer_flops_per_sequence(cfg, seq)``: the FLOPs of a sequence's
  token mixing that no weight matrix counts (attention's q·k and p·v);
* ``TINY``: the sizes the CPU tests cut the family to.

Its plain reference is ``bench/reference/<model_type>.py``'s ``Ref``.
"""
from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Any, Dict, List, Tuple

Spec = Tuple[Tuple[Any, ...], Tuple[int, ...], float]   # path, shape, scale

INTERFACE = ("port_config_kwargs", "param_specs", "empty_tree",
             "matmul_macs_per_token", "mixer_flops_per_sequence", "TINY")


def arch_of(cfg: Dict) -> ModuleType:
    """The family module of ``cfg["model_type"]``."""
    name = cfg["model_type"]
    module = f"bench.archs.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            f"no model family '{name}' in the benchmark: add "
            f"bench/archs/{name}.py (and bench/reference/{name}.py)",
            name=module) from e


def dense(path, d_in: int, d_out: int) -> List[Spec]:
    """One dense weight ``(d_in, d_out)`` under ``path + ("w",)``."""
    return [(path + ("w",), (d_in, d_out), 1.0 / math.sqrt(d_in))]


def swiglu(path, d: int, f: int) -> List[Spec]:
    """A SwiGLU MLP's three weights: gate, up, down."""
    return (dense(path + ("w_gate",), d, f) + dense(path + ("w_up",), d, f)
            + dense(path + ("w_down",), f, d))
