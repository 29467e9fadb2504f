"""Qwen2-VL-2B [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The transformer backbone only; the ViT vision encoder and its projector
are stubbed, as in the reference: a batch may carry pre-projected patch
embeddings (B, n_patches, D), prepended to the token sequence, and the 3D
(temporal / height / width) M-RoPE position ids.  head_dim 128 -> M-RoPE
sections (16, 24, 24) over the dh/2 = 64 frequency slots."""
from repro_torch.configs.base import (ModelConfig, ParallelismPlan, RunConfig,
                                      VisionStubConfig, register)


@register("qwen2-vl-2b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="qwen2-vl-2b",
            family="vlm",
            source="arXiv:2409.12191",
            n_layers=28,
            d_model=1536,
            n_heads=12,
            n_kv_heads=2,
            d_head=128,
            d_ff=8960,
            vocab_size=151936,
            max_seq_len=32768,
            norm_type="rmsnorm",
            mlp_type="swiglu",
            attn_qkv_bias=True,
            pos_type="mrope",
            rope_theta=1e6,
            vision=VisionStubConfig(n_patches=64, mrope_sections=(16, 24, 24)),
            tie_embeddings=True,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="momentum",
        learning_rate=0.1,
        lr_schedule="step",
    )
