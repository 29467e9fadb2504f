"""DeepSeek-V2-Lite-16B [moe] — MLA kv_lora=512, 2 shared + 64 routed
experts top-6, first layer dense [arXiv:2405.04434].

MLA caches only the 512-dim latent + 64-dim shared rope key per token."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      ParallelismPlan, RunConfig, register)


@register("deepseek-v2-lite-16b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="deepseek-v2-lite-16b",
            family="moe",
            source="arXiv:2405.04434",
            n_layers=27,
            d_model=2048,
            n_heads=16,
            n_kv_heads=16,
            d_ff=10944,               # dense first layer width
            vocab_size=102400,
            max_seq_len=32768,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            pos_type="rope",
            rope_theta=10000.0,
            attention_type="mla",
            mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                          qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128),
            moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                          n_shared_experts=2, first_k_dense=1,
                          d_ff_dense=10944),
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="adamw",
        learning_rate=4e-4,
        lr_schedule="cosine",
    )
