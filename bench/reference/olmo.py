"""OLMo's forward pass and loss in plain PyTorch: non-parametric layer
norms, multi-head attention with RoPE, a SwiGLU MLP in every layer."""
from __future__ import annotations

import torch

from bench.reference.model import Decoder


class Ref(Decoder):
    def __init__(self, cfg, precision: str = "f32"):
        super().__init__(cfg, precision)
        self.eps = cfg["norm_eps"]

    def norm(self, p, x):
        """Layer norm without affine parameters."""
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps)

    def attention(self, p, x):
        c = self.c
        B, S, D = x.shape
        H = c["num_attention_heads"]
        dh = D // H
        q, k, v = (self.mm(x, p[n]["w"]).view(B, S, H, dh)
                   for n in ("wq", "wk", "wv"))
        q, k = self.rope(q, c["rope_theta"]), self.rope(k, c["rope_theta"])
        return self.mm(self.attend(q, k, v).reshape(B, S, D), p["wo"]["w"])

    def block(self, p, x):
        x = x + self.attention(p["attn"], self.norm(p.get("norm1"), x))
        y = self.swiglu(p["mlp"], self.norm(p.get("norm2"), x))
        return x + y, x.new_zeros(())
