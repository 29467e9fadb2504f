"""GLM4-9B [dense] — RoPE (partial, 0.5), extreme GQA kv=2 [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig, ParallelismPlan, RunConfig, register


@register("glm4-9b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="glm4-9b",
            family="dense",
            source="hf:THUDM/glm-4-9b",
            n_layers=40,
            d_model=4096,
            n_heads=32,
            n_kv_heads=2,
            d_ff=13696,
            vocab_size=151552,
            max_seq_len=131072,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            attn_qkv_bias=True,       # GLM-4 uses qkv bias
            pos_type="rope",
            partial_rotary_factor=0.5,
            rope_theta=10000.0,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="momentum",
        learning_rate=0.1,
        lr_schedule="step",
    )
