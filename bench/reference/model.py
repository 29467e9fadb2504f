"""The models' forward pass and loss in plain PyTorch, written from the
published descriptions and the configuration file (its ``reduced`` and
``assumed`` entries say where the file departs from the published model).

Parameters are the benchmark's tree (``bench/inputs.py``): dense weights
``(d_in, d_out)``, products ``x @ w``.  ``precision`` is ``"f32"`` (the
reference: f32 throughout, TF32 off) or ``"fp8"`` (the control: every
weight product as an fp8 GEMM computes it, both operands rounded to
float8 e4m3 with a per-tensor scale and the product rounded to bf16, the
gradient passed straight through; attention, norms, softmax and the loss
stay f32).  Each layer runs under an activation
checkpoint, which changes no value and keeps the f32 activations small.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.detach().to(torch.bfloat16).to(torch.float32)
                - x.detach())


class Ref:
    def __init__(self, cfg: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.c = cfg
        self.precision = precision
        self.mla = bool(cfg.get("kv_lora_rank"))
        self.eps = cfg.get("rms_norm_eps", cfg.get("norm_eps"))

    # -- pieces ---------------------------------------------------------
    def mm(self, x, w):
        if self.precision == "fp8":
            return _bf16(_fp8(x) @ _fp8(w))
        return x @ w

    def norm(self, p, x):
        if self.mla:                                   # RMSNorm, scaled
            return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                   + self.eps) * p["scale"]
        mu = x.mean(-1, keepdim=True)                  # OLMo: no affine
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps)

    def rope(self, x, theta):
        """Rotary embedding on (B, S, H, d), the halves convention: dims
        i and i + d/2 turn together by position / theta^(2i/d)."""
        S, d = x.shape[1], x.shape[-1]
        inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=x.device) / d)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
            * inv[None]
        cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
        a, b = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    @staticmethod
    def attend(q, k, v):
        """Causal softmax attention, q, k (B, S, H, dk), v (B, S, H, dv)."""
        S = q.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)

    def attention(self, p, x):
        c = self.c
        B, S, D = x.shape
        H = c["num_attention_heads"]
        if self.mla:
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
        dh = D // H
        q, k, v = (self.mm(x, p[n]["w"]).view(B, S, H, dh)
                   for n in ("wq", "wk", "wv"))
        q, k = self.rope(q, c["rope_theta"]), self.rope(k, c["rope_theta"])
        return self.mm(self.attend(q, k, v).reshape(B, S, D), p["wo"]["w"])

    def swiglu(self, p, x):
        return self.mm(F.silu(self.mm(x, p["w_gate"]["w"]))
                       * self.mm(x, p["w_up"]["w"]), p["w_down"]["w"])

    def moe(self, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """GShard dispatch with capacity (the file's ``moe_dispatch``):
        tokens in groups, softmax router, top-k (ties to the lower expert),
        the k gates renormalised, each (token, choice) queued at its
        expert in token-then-choice order and dropped past the capacity;
        one-hot dispatch and combine.  Returns (output, aux loss)."""
        c, d = self.c, self.c["moe_dispatch"]
        B, S, D = x.shape
        E, k = c["n_routed_experts"], c["num_experts_per_tok"]
        T = B * S
        Sg = min(d["group_size"], T)
        while T % Sg:
            Sg //= 2
        G = T // Sg
        C = min(max(4, int(Sg * k / E * d["capacity_factor"])), Sg)
        xg = x.reshape(G, Sg, D)
        logits = xg @ p["router"]
        probs = logits.softmax(-1)
        gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = gate[..., :k], idx[..., :k]
        if c["norm_topk_prob"]:
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        choice = F.one_hot(idx, E).to(torch.float32)          # (G, Sg, k, E)
        queue = choice.reshape(G, Sg * k, E).cumsum(1).reshape(G, Sg, k, E)
        slot = ((queue - 1) * choice).sum(-1)                  # (G, Sg, k)
        kept = (slot < C).to(torch.float32)
        pos = F.one_hot(slot.clamp(max=C - 1).long(), C).to(torch.float32)
        route = choice[..., None] * pos[..., None, :] * kept[..., None, None]
        dispatch = route.sum(2)                                # (G, Sg, E, C)
        combine = (route * gate[..., None, None]).sum(2)
        ex = torch.einsum("gsec,gsd->egcd", dispatch, xg).reshape(E, G * C, D)
        h = F.silu(self.mm(ex, p["w_gate"])) * self.mm(ex, p["w_up"])
        out = self.mm(h, p["w_down"])
        y = torch.einsum("gsec,egcd->gsd", combine, out.view(E, G, C, D))
        y = y.reshape(B, S, D)
        if "shared" in p:
            y = y + self.swiglu(p["shared"], x)
        balance = E * (choice.sum(2).mean((0, 1)) * probs.mean((0, 1))).sum()
        z = torch.logsumexp(logits, -1).square().mean()
        aux = d["router_aux_coef"] * balance + d["router_z_coef"] * z
        return y, aux

    def block(self, p, x):
        x = x + self.attention(p["attn"], self.norm(p.get("norm1"), x))
        h = self.norm(p.get("norm2"), x)
        if "moe" in p:
            y, aux = self.moe(p["moe"], h)
        else:
            y, aux = self.swiglu(p["mlp"], h), x.new_zeros(())
        return x + y, aux

    # -- the loss ------------------------------------------------------
    def loss(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy over (b, S) tokens, plus the MoE
        layers' aux losses."""
        x = params["embed"][tokens.long()]
        aux_total = x.new_zeros(())
        for blk in params["blocks"]:
            x, aux = checkpoint(self.block, blk, x, use_reentrant=False)
            aux_total = aux_total + aux
        x = self.norm(params.get("final_norm"), x)
        head = params["embed"].T if self.c["tie_word_embeddings"] \
            else params["lm_head"]
        logits = self.mm(x, head)
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             tokens[:, 1:].reshape(-1).long())
        return ce + aux_total
