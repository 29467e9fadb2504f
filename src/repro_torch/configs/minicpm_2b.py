"""MiniCPM-2B [dense] — WSD schedule, mup-style scaling (arch = llama-like)
[arXiv:2404.06395].

scale_emb=12, residual scale 1.4/sqrt(L), logits scaled by 1/(d/256) —
the MiniCPM tensor-program scalings."""
import math

from repro_torch.configs.base import ModelConfig, ParallelismPlan, RunConfig, register


@register("minicpm-2b")
def cfg() -> RunConfig:
    n_layers = 40
    d_model = 2304
    return RunConfig(
        model=ModelConfig(
            name="minicpm-2b",
            family="dense",
            source="arXiv:2404.06395",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=36,
            n_kv_heads=36,
            d_ff=5760,
            vocab_size=122753,
            max_seq_len=4096,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            pos_type="rope",
            rope_theta=10000.0,
            emb_scale=12.0,
            residual_scale=1.4 / math.sqrt(n_layers),
            logit_scale=256.0 / d_model,
            tie_embeddings=True,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="adamw",
        learning_rate=1e-2,
        lr_schedule="wsd",
        lr_warmup_steps=100,
    )
