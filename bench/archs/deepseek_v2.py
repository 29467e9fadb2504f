"""DeepSeek-V2 (arXiv:2405.04434): multi-head latent attention (MLA) with
a decoupled RoPE key, RMSNorm, dense SwiGLU layers up to
``first_k_dense_replace`` and MoE layers after them (a router over
``n_routed_experts`` SwiGLU experts, ``num_experts_per_tok`` chosen,
``n_shared_experts`` always on), run as the GShard capacity dispatch of
the file's ``moe_dispatch``; an untied output head."""
from __future__ import annotations

import math
from typing import Dict, List

from bench.archs import Spec, dense, swiglu
from bench.yardstick import causal_pairs

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            vocab_size=256)


def port_config_kwargs(cfg: Dict, traffic: Dict, base) -> Dict:
    """MLA and the MoE layer besides the common sizes; the port's MoE
    groups must hold the file's ``group_size`` tokens."""
    import dataclasses
    import inspect
    from repro_torch.configs import MLAConfig
    from repro_torch.models import layers
    c, d = cfg, cfg["moe_dispatch"]
    group = inspect.signature(layers.moe_forward).parameters["group_size"]
    if group.default != d["group_size"]:
        raise RuntimeError(f"the port's MoE groups hold {group.default} "
                           f"tokens, the file says {d['group_size']}")
    return dict(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], rope_theta=float(c["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"], norm_eps=c["rms_norm_eps"],
        mla=MLAConfig(
            kv_lora_rank=c["kv_lora_rank"], q_lora_rank=c["q_lora_rank"] or 0,
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"]),
        moe=dataclasses.replace(
            base.moe, n_experts=c["n_routed_experts"],
            top_k=c["num_experts_per_tok"],
            d_ff_expert=c["moe_intermediate_size"],
            n_shared_experts=c["n_shared_experts"],
            first_k_dense=c["first_k_dense_replace"],
            d_ff_dense=c["intermediate_size"],
            capacity_factor=d["capacity_factor"],
            router_aux_coef=d["router_aux_coef"],
            router_z_coef=d["router_z_coef"]))


def _is_moe(cfg: Dict, i: int) -> bool:
    return i >= cfg.get("first_k_dense_replace", 0)


def param_specs(cfg: Dict) -> List[Spec]:
    D, H, V = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    specs: List[Spec] = [(("embed",), (V, D), 0.02),
                         (("final_norm", "scale"), (D,), 0.0)]
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        specs += [(b + ("norm1", "scale"), (D,), 0.0),
                  (b + ("norm2", "scale"), (D,), 0.0)]
        a = b + ("attn",)
        specs += dense(a + ("wq",), D, H * (nope + rope))
        specs += dense(a + ("wkv_a",), D, r + rope)
        specs.append((a + ("kv_norm", "scale"), (r,), 0.0))
        specs += dense(a + ("wkv_b",), r, H * (nope + vd))
        specs += dense(a + ("wo",), H * vd, D)
        if _is_moe(cfg, i):
            E, Fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            m = b + ("moe",)
            specs += [(m + ("router",), (D, E), 1.0 / math.sqrt(D)),
                      (m + ("w_gate",), (E, D, Fe), 1.0 / math.sqrt(D)),
                      (m + ("w_up",), (E, D, Fe), 1.0 / math.sqrt(D)),
                      (m + ("w_down",), (E, Fe, D), 1.0 / math.sqrt(Fe))]
            Fs = Fe * cfg.get("n_shared_experts", 0)
            if Fs:
                specs += swiglu(m + ("shared",), D, Fs)
        else:
            specs += swiglu(b + ("mlp",), D, cfg["intermediate_size"])
    if not cfg["tie_word_embeddings"]:
        specs.append((("lm_head",), (D, V), 1.0 / math.sqrt(D)))
    return specs


def empty_tree(cfg: Dict) -> Dict:
    return {"blocks": [{} for _ in range(cfg["num_hidden_layers"])]}


def matmul_macs_per_token(cfg: Dict) -> int:
    """The output head, and in every layer MLA's projections and either
    the dense MLP or the router, the shared experts and
    ``num_experts_per_tok`` routed experts."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    Fe = cfg["moe_intermediate_size"]
    mla = (D * H * (nope + rope) + D * (r + rope) + r * H * (nope + vd)
           + H * vd * D)
    macs = D * cfg["vocab_size"]
    for i in range(cfg["num_hidden_layers"]):
        macs += mla
        if _is_moe(cfg, i):
            macs += (D * cfg["n_routed_experts"]
                     + 3 * D * Fe * cfg.get("n_shared_experts", 0)
                     + 3 * D * Fe * cfg["num_experts_per_tok"])
        else:
            macs += 3 * D * cfg["intermediate_size"]
    return macs


def mixer_flops_per_sequence(cfg: Dict, seq: int) -> int:
    """q·k over the key width (nope + rope) and p·v over the value width:
    two multiply-adds per causal (query, key) pair, head and dimension."""
    width = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
             + cfg["v_head_dim"])
    return (2 * width * cfg["num_attention_heads"] * causal_pairs(seq)
            * cfg["num_hidden_layers"])
