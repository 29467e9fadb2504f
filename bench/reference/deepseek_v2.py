"""DeepSeek-V2's forward pass and loss in plain PyTorch: RMSNorm, MLA
(the decoupled RoPE key shared by the heads, the latent's norm, K and V
from the latent), dense SwiGLU layers up to ``first_k_dense_replace`` and
after them the GShard capacity MoE of the file's ``moe_dispatch``."""
from __future__ import annotations

import torch

from bench.reference.model import Decoder


class Ref(Decoder):
    def __init__(self, cfg, precision: str = "f32"):
        super().__init__(cfg, precision)
        self.eps = cfg["rms_norm_eps"]

    def norm(self, p, x):
        return self.rms_norm(p, x, self.eps)

    def attention(self, p, x):
        c = self.c
        B, S, D = x.shape
        H = c["num_attention_heads"]
        nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        r, vd = c["kv_lora_rank"], c["v_head_dim"]
        q = self.mm(x, p["wq"]["w"]).view(B, S, H, nope + rope)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:],
                                               c["rope_theta"])], -1)
        kv_a = self.mm(x, p["wkv_a"]["w"])
        latent = self.norm(p["kv_norm"], kv_a[..., :r])
        k_rope = self.rope(kv_a[..., None, r:], c["rope_theta"])
        kv = self.mm(latent, p["wkv_b"]["w"]).view(B, S, H, nope + vd)
        k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rope)], -1)
        o = self.attend(q, k, kv[..., nope:])
        return self.mm(o.reshape(B, S, H * vd), p["wo"]["w"])

    def block(self, p, x):
        x = x + self.attention(p["attn"], self.norm(p.get("norm1"), x))
        h = self.norm(p.get("norm2"), x)
        if "moe" in p:
            c = self.c
            y, aux = self.gshard_moe(p["moe"], h, c["n_routed_experts"],
                                     c["num_experts_per_tok"],
                                     c["norm_topk_prob"], c["moe_dispatch"])
        else:
            y, aux = self.swiglu(p["mlp"], h), x.new_zeros(())
        return x + y, aux
