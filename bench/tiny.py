"""Cells cut to a size that the CPU tests can run: the cell's traffic and
limits, its configuration's kind of model at tiny widths, f32 compute."""
from __future__ import annotations

import copy

from bench.cells import Cell, load_cell, load_json

TINY_OLMO = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                 intermediate_size=128, num_hidden_layers=2, vocab_size=256)
TINY_DEEPSEEK = dict(hidden_size=64, num_attention_heads=4,
                     num_key_value_heads=4, kv_lora_rank=32,
                     qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                     intermediate_size=96, moe_intermediate_size=32,
                     n_routed_experts=8, num_experts_per_tok=2,
                     n_shared_experts=1, vocab_size=256)


def tiny_cell(name: str, traffic: str = None, config: str = None,
              compute_dtype: str = "float32", chips: int = None) -> Cell:
    """``name``'s cell (or another traffic / configuration by name) at
    tiny widths: 2 layers, 32 tokens a row, 2 rows a replica."""
    cell = load_cell(name)
    c = copy.deepcopy(load_json("configs", config) if config
                      else cell.config)
    c.update(TINY_DEEPSEEK if c.get("kv_lora_rank") else TINY_OLMO)
    c["training"] = dict(c["training"], compute_dtype=compute_dtype)
    t = dict(load_json("traffic", traffic) if traffic else cell.traffic,
             seq=32, batch=2, data_steps=8)
    return Cell(cell.name, chips or cell.chips, c, t, cell.limits,
                cell.end_to_end, cell.per_layer)
