"""Qwen2.5-14B [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig, ParallelismPlan, RunConfig, register


@register("qwen2.5-14b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="qwen2.5-14b",
            family="dense",
            source="hf:Qwen/Qwen2.5-0.5B",
            n_layers=48,
            d_model=5120,
            n_heads=40,
            n_kv_heads=8,
            d_head=128,
            d_ff=13824,
            vocab_size=152064,
            max_seq_len=32768,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            attn_qkv_bias=True,
            pos_type="rope",
            rope_theta=1e6,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="momentum",
        learning_rate=0.1,
        lr_schedule="step",
    )
