"""OLMo (arXiv:2402.00838): a dense decoder with non-parametric layer
norms, multi-head attention with RoPE and a SwiGLU MLP in every layer, and
a tied or untied output head."""
from __future__ import annotations

import math
from typing import Dict, List

from bench.archs import Spec, dense, swiglu
from bench.yardstick import causal_pairs

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=128, num_hidden_layers=2, vocab_size=256)


def port_config_kwargs(cfg: Dict, traffic: Dict, base) -> Dict:
    return dict(d_model=cfg["hidden_size"],
                n_heads=cfg["num_attention_heads"],
                n_kv_heads=cfg["num_key_value_heads"],
                d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
                rope_theta=float(cfg["rope_theta"]),
                tie_embeddings=cfg["tie_word_embeddings"],
                norm_eps=cfg["norm_eps"])


def param_specs(cfg: Dict) -> List[Spec]:
    D, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    dh, K = D // H, cfg["num_key_value_heads"]
    specs: List[Spec] = [(("embed",), (V, D), 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        a = ("blocks", i, "attn")
        specs += (dense(a + ("wq",), D, H * dh) + dense(a + ("wk",), D, K * dh)
                  + dense(a + ("wv",), D, K * dh) + dense(a + ("wo",), H * dh, D))
        specs += swiglu(("blocks", i, "mlp"), D, cfg["intermediate_size"])
    if not cfg["tie_word_embeddings"]:
        specs.append((("lm_head",), (D, V), 1.0 / math.sqrt(D)))
    return specs


def empty_tree(cfg: Dict) -> Dict:
    """The norms have no parameters: empty dicts in the program's tree."""
    tree: Dict = {"blocks": [{} for _ in range(cfg["num_hidden_layers"])]}
    tree["final_norm"] = {}
    for blk in tree["blocks"]:
        blk["norm1"], blk["norm2"] = {}, {}
    return tree


def matmul_macs_per_token(cfg: Dict) -> int:
    """The output head, and in every layer the q, k, v and o projections
    and the MLP's three matrices."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dh, K = D // H, cfg["num_key_value_heads"]
    layer = D * H * dh + 2 * D * K * dh + H * dh * D \
        + 3 * D * cfg["intermediate_size"]
    return D * cfg["vocab_size"] + cfg["num_hidden_layers"] * layer


def mixer_flops_per_sequence(cfg: Dict, seq: int) -> int:
    """q·k and p·v of every layer: two multiply-adds per causal (query,
    key) pair, head and dimension of the key and of the value."""
    H = cfg["num_attention_heads"]
    width = 2 * (cfg["hidden_size"] // H)
    return 2 * width * H * causal_pairs(seq) * cfg["num_hidden_layers"]
