"""Whisper-medium [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

The decoder: 24 layers, d 1024, 16 MHA heads, d_ff 4096, GELU, LayerNorm,
learned positions (sinusoidal in the reference, and so here); a 24-layer
encoder over stubbed post-conv frame embeddings (1500 frames = 30 s), and
cross-attention in every decoder layer."""
from repro_torch.configs.base import (EncoderConfig, ModelConfig,
                                      ParallelismPlan, RunConfig, register)


@register("whisper-medium")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="whisper-medium",
            family="audio",
            source="arXiv:2212.04356",
            n_layers=24,
            d_model=1024,
            n_heads=16,
            n_kv_heads=16,
            d_ff=4096,
            vocab_size=51865,
            max_seq_len=32768,
            norm_type="layernorm",
            mlp_type="gelu",
            pos_type="learned",
            encoder=EncoderConfig(n_layers=24, n_heads=16, n_frames=1500),
            tie_embeddings=True,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="adamw",
        learning_rate=1e-3,
        lr_schedule="cosine",
    )
