"""OLMo-1B [dense] — non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.configs.base import ModelConfig, RunConfig, register


@register("olmo-1b")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="olmo-1b",
            family="dense",
            source="arXiv:2402.00838",
            n_layers=16,
            d_model=2048,
            n_heads=16,
            n_kv_heads=16,
            d_ff=8192,
            vocab_size=50304,
            max_seq_len=4096,
            norm_type="nonparametric_ln",
            mlp_type="swiglu",
            pos_type="rope",
            rope_theta=10000.0,
            tie_embeddings=True,
        ),
        optimizer="adamw",
        learning_rate=4e-4,
        lr_schedule="cosine",
    )
