"""Jamba-1.5-Large-398B [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 [arXiv:2403.19887].

Each 8-layer period has one attention layer (index 4, per the Jamba paper)
and seven Mamba layers; MoE replaces the MLP on every second layer.  The
reference's plan is fsdp; the port's one backend reads no plan, and on one
card the model runs cut in depth."""
from repro_torch.configs.base import (MambaConfig, ModelConfig, MoEConfig,
                                      ParallelismPlan, RunConfig, register)


@register("jamba-1.5-large-398b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="jamba-1.5-large-398b",
            family="hybrid",
            source="arXiv:2403.19887",
            n_layers=72,
            d_model=8192,
            n_heads=64,
            n_kv_heads=8,
            d_head=128,
            d_ff=24576,
            vocab_size=65536,
            max_seq_len=524288,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            pos_type="none",          # Jamba uses no positional encoding
            layer_pattern=("mamba", "mamba", "mamba", "mamba",
                           "attn", "mamba", "mamba", "mamba"),
            mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
            moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                          moe_every=2),
        ),
        parallelism=ParallelismPlan(plan="fsdp"),
        optimizer="adamw",
        learning_rate=2e-4,
        lr_schedule="cosine",
    )
