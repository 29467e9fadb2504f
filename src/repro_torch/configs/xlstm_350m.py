"""xLSTM-350M [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

Seven mLSTM blocks per sLSTM block (the sLSTM at index 3 of each 8);
d_ff=0 because both block types carry their own projections (mLSTM:
pre-up-projection x2; sLSTM: post-up-projection gated FFN).  Attention
free: decoding carries a fixed-size state per layer."""
from repro_torch.configs.base import ModelConfig, ParallelismPlan, RunConfig, register


@register("xlstm-350m")
def cfg() -> RunConfig:
    return RunConfig(
        model=ModelConfig(
            name="xlstm-350m",
            family="ssm",
            source="arXiv:2405.04517",
            n_layers=24,
            d_model=1024,
            n_heads=4,
            n_kv_heads=4,
            d_ff=0,
            vocab_size=50304,
            max_seq_len=524288,
            norm_type="layernorm",
            pos_type="none",
            layer_pattern=("mlstm", "mlstm", "mlstm", "slstm",
                           "mlstm", "mlstm", "mlstm", "mlstm"),
            tie_embeddings=True,
        ),
        parallelism=ParallelismPlan(plan="replica_dp"),
        optimizer="adamw",
        learning_rate=1e-3,
        lr_schedule="cosine",
    )
