"""Mixtral-8x22B [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

~141B total / ~39B active parameters.  The reference's plan is fsdp
(parameters sharded over 'data', experts over 'model'); the port's one
backend reads no plan, and on one card the model runs cut in depth."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, ParallelismPlan,
                                      RunConfig, register)


@register("mixtral-8x22b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="mixtral-8x22b",
            family="moe",
            source="arXiv:2401.04088",
            n_layers=56,
            d_model=6144,
            n_heads=48,
            n_kv_heads=8,
            d_head=128,
            d_ff=16384,
            vocab_size=32768,
            max_seq_len=65536,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            pos_type="rope",
            rope_theta=1e6,
            sliding_window=4096,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        ),
        parallelism=ParallelismPlan(plan="fsdp"),
        optimizer="adamw",
        learning_rate=3e-4,
        lr_schedule="cosine",
    )
