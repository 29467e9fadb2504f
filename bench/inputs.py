"""The inputs of a run, made from ``--seed`` on the run's device: the
initial weights (one tree, handed to the program as its ``params0`` and
to the reference) and the token batches.

The tree has the program's layout (nested dicts, a list of blocks, each
dense weight ``(d_in, d_out)`` under ``"w"``), written out here from the
configuration file's sizes.  All weights come from one ``torch.Generator``
on the device: one normal draw of every parameter at once into a flat f32
buffer, cut into the leaves and scaled leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Spec = Tuple[Tuple[Any, ...], Tuple[int, ...], float]   # path, shape, scale

SEED_MIX = 0x9E3779B97F4A7C15       # keeps the weights' and data's streams apart


def _dense(path, d_in, d_out) -> List[Spec]:
    return [(path + ("w",), (d_in, d_out), 1.0 / math.sqrt(d_in))]


def param_specs(cfg: Dict) -> List[Spec]:
    """Every leaf of the model's tree: its path, shape and the scale of
    its standard normal draw (0 for a norm scale, which starts at 1)."""
    D, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    specs: List[Spec] = [(("embed",), (V, D), 0.02)]
    rms = cfg["model_type"] == "deepseek_v2"
    if rms:
        specs.append((("final_norm", "scale"), (D,), 0.0))
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        if rms:
            specs += [(b + ("norm1", "scale"), (D,), 0.0),
                      (b + ("norm2", "scale"), (D,), 0.0)]
        if cfg.get("kv_lora_rank"):
            r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
            rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
            a = b + ("attn",)
            specs += _dense(a + ("wq",), D, H * (nope + rope))
            specs += _dense(a + ("wkv_a",), D, r + rope)
            specs.append((a + ("kv_norm", "scale"), (r,), 0.0))
            specs += _dense(a + ("wkv_b",), r, H * (nope + vd))
            specs += _dense(a + ("wo",), H * vd, D)
        else:
            dh, K = D // H, cfg["num_key_value_heads"]
            a = b + ("attn",)
            specs += _dense(a + ("wq",), D, H * dh)
            specs += _dense(a + ("wk",), D, K * dh)
            specs += _dense(a + ("wv",), D, K * dh)
            specs += _dense(a + ("wo",), H * dh, D)
        moe = (cfg.get("n_routed_experts")
               and i >= cfg.get("first_k_dense_replace", 0))
        if moe:
            E, Fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            m = b + ("moe",)
            specs += [(m + ("router",), (D, E), 1.0 / math.sqrt(D)),
                      (m + ("w_gate",), (E, D, Fe), 1.0 / math.sqrt(D)),
                      (m + ("w_up",), (E, D, Fe), 1.0 / math.sqrt(D)),
                      (m + ("w_down",), (E, Fe, D), 1.0 / math.sqrt(Fe))]
            Fs = Fe * cfg.get("n_shared_experts", 0)
            if Fs:
                s = m + ("shared",)
                specs += (_dense(s + ("w_gate",), D, Fs)
                          + _dense(s + ("w_up",), D, Fs)
                          + _dense(s + ("w_down",), Fs, D))
        else:
            F = cfg["intermediate_size"]
            p = b + ("mlp",)
            specs += (_dense(p + ("w_gate",), D, F) + _dense(p + ("w_up",), D, F)
                      + _dense(p + ("w_down",), F, D))
    if not cfg["tie_word_embeddings"]:
        specs.append((("lm_head",), (D, V), 1.0 / math.sqrt(D)))
    return specs


def empty_tree(cfg: Dict) -> Dict:
    """The tree's containers: every block a dict, OLMo's parameterless
    norms as empty dicts (the program's layout)."""
    tree: Dict = {"blocks": [{} for _ in range(cfg["num_hidden_layers"])]}
    if cfg["model_type"] != "deepseek_v2":
        tree["final_norm"] = {}
        for blk in tree["blocks"]:
            blk["norm1"], blk["norm2"] = {}, {}
    return tree


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        if isinstance(node, dict) and p not in node:
            node[p] = {}
        node = node[p]
    node[path[-1]] = value


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * SEED_MIX + stream) % (1 << 63))
    return g


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The initial weights, f32, from ``seed``: one normal draw of all
    drawn leaves, then each leaf's slice scaled; norm scales are ones.
    Each leaf is a view of the one buffer."""
    specs = param_specs(cfg)
    n = sum(math.prod(s) for _, s, sc in specs if sc)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(generator=generator(seed, 1, device))
    tree = empty_tree(cfg)
    at = 0
    for path, shape, scale in specs:
        if scale:
            k = math.prod(shape)
            leaf = flat[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        _put(tree, path, leaf)
    return tree


def make_tokens(vocab: int, steps: int, replicas: int, batch: int, seq: int,
                seed: int, device) -> torch.Tensor:
    """(steps, R, b, S) int32 token ids, uniform over the vocabulary: the
    batches of ``steps`` iterations, cycled by ``batch_of``."""
    return torch.randint(0, vocab, (steps, replicas, batch, seq),
                         generator=generator(seed, 2, device), device=device,
                         dtype=torch.int32)


def batch_of(tokens: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Iteration k's batch: (R, b, S) tokens."""
    return {"tokens": tokens[k % tokens.shape[0]]}
