"""Cells cut to a size that the CPU tests can run: the cell's traffic and
limits, its configuration's family at the family's ``TINY`` sizes
(``bench/archs/<model_type>.py``), f32 compute."""
from __future__ import annotations

import copy

from bench.archs import arch_of
from bench.cells import Cell, load_cell, load_json


def tiny_cell(name: str, traffic: str = None, config: str = None,
              compute_dtype: str = "float32", chips: int = None) -> Cell:
    """``name``'s cell (or another traffic / configuration by name) at
    its family's tiny sizes, 32 tokens a row, 2 rows a replica."""
    cell = load_cell(name)
    c = copy.deepcopy(load_json("configs", config) if config
                      else cell.config)
    c.update(arch_of(c).TINY)
    c["training"] = dict(c["training"], compute_dtype=compute_dtype)
    t = dict(load_json("traffic", traffic) if traffic else cell.traffic,
             seq=32, batch=2, data_steps=8)
    return Cell(cell.name, chips or cell.chips, c, t, cell.limits,
                cell.end_to_end, cell.per_layer)
