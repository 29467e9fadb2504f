"""Configuration system (port of ``repro/configs/base.py``).

A run is a ``ModelConfig`` (architecture hyper-parameters), an
``AveragingConfig`` (the paper's Algorithm 2 hyper-parameters) and the
optimizer / schedule fields of ``RunConfig``.  Field names and defaults are
the reference's, so a config built on one side means the same on the
other.  ``ParallelismPlan`` is carried so a ``RunConfig`` transfers field
for field; the port's one backend (one device) does not read it yet.  The
dry-run ``InputShape`` tables are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style grouped dispatch)."""

    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    first_k_dense: int = 0
    d_ff_dense: int = 0
    moe_every: int = 1


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 24
    n_heads: int = 16
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionStubConfig:
    n_patches: int = 64
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 4096

    norm_type: str = "rmsnorm"    # rmsnorm | layernorm | nonparametric_ln
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"      # swiglu | gelu
    tie_embeddings: bool = False

    attention_type: str = "gqa"   # gqa | mla
    attn_qkv_bias: bool = False
    pos_type: str = "rope"        # rope | mrope | sinusoidal | learned | none
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0

    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0

    layer_pattern: Optional[Tuple[str, ...]] = None

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None

    # numerics; remat / scan / sharding fields are the reference's compile
    # and mesh knobs, carried so configs transfer field for field
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    use_flash: bool = False
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    act_dp_axis: str = ""
    act_seq_axis: str = ""
    vocab_pad_multiple: int = 1

    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return ((self.vocab_size + m - 1) // m) * m

    def block_kind(self, layer_idx: int) -> str:
        if self.layer_pattern is None:
            return "attn"
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def layer_uses_moe(self, layer_idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if layer_idx < m.first_k_dense:
            return False
        return (layer_idx % m.moe_every) == (m.moe_every - 1) if m.moe_every > 1 else True

    def scan_grouping(self) -> Optional[Tuple[int, int, int]]:
        """(prefix_len, period, n_groups) of the reference's ``lax.scan``
        over layers, or None: layers [prefix:] are n_groups repetitions
        of a ``period``-long block pattern with one parameter structure
        per slot.  The port runs a Python loop over layers; the dry run
        reads this to extrapolate a layer-cut build to full depth."""
        if not self.scan_layers:
            return None
        period = len(self.layer_pattern) if self.layer_pattern else 1
        if self.moe is not None:
            period = math.lcm(period, max(1, self.moe.moe_every))
        prefix = self.moe.first_k_dense if self.moe else 0
        body = self.n_layers - prefix
        if body <= 0 or body % period or body // period < 2:
            return None
        return prefix, period, body // period

    def is_subquadratic(self) -> bool:
        """True if a 500k-token decode is feasible (bounded attention
        state): recurrent layers only, a hybrid whose few attention
        layers bound the KV cache, or a sliding window."""
        if self.layer_pattern is not None:
            kinds = set(self.layer_pattern)
            if kinds <= {"mamba", "mlstm", "slstm"}:
                return True
            if "attn" in kinds and ("mamba" in kinds or "mlstm" in kinds):
                return True
        return self.sliding_window > 0

    def has_decoder(self) -> bool:
        return True  # every config has a decoder


PLANS = ("replica_dp", "fsdp", "replica_ddp")
PLACEMENTS = ("replica_ddp", "replica_tp")


@dataclass(frozen=True)
class ParallelismPlan:
    """How an architecture maps onto a mesh (the reference's fields).

    ``plan`` replica_dp | fsdp | replica_ddp picks the spec rules of
    ``launch/sharding.py`` (``base_spec``); the ``vmap`` backend ignores
    it, as the reference's does.  ``placement`` names how the mesh
    backend lays replicas out: ``replica_ddp`` keeps each replica a whole
    model on its ranks, ``replica_tp`` spreads one replica over the
    mesh's ``model`` axis.  ``vocab_parallel_embed`` is read by the spec
    rules (the embedding shards its vocab dim, else its d_model dim).
    ``shard_activations`` and ``remat_policy`` (full | dots | none) are
    carried as data: no module of the reference reads them either.  A
    plan that is none of the reference's is refused."""

    plan: str = "replica_dp"
    placement: str = "replica_ddp"
    shard_activations: bool = True
    remat_policy: str = "full"
    vocab_parallel_embed: bool = True

    def __post_init__(self):
        if self.plan not in PLANS:
            raise NotImplementedError(
                f"ParallelismPlan(plan={self.plan!r}): not a plan of the "
                f"reference's mesh backend ({', '.join(PLANS)})")
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"ParallelismPlan(placement={self.placement!r}): the mesh "
                f"backend's placements are {', '.join(PLACEMENTS)}")


@dataclass(frozen=True)
class AveragingConfig:
    """Paper technique hyper-parameters (Algorithm 2 + baselines)."""

    method: str = "adpsgd"
    p_init: int = 4
    p_const: int = 8
    k_sample_frac: float = 0.25
    warmup_full_sync_steps: int = 0
    lower: float = 0.7
    upper: float = 1.3
    p_min: int = 1
    p_max: int = 256
    sync_momentum: bool = False
    qsgd_bits: int = 8
    decreasing_p0: int = 20
    decreasing_p1: int = 5
    inner_period: int = 1
    group_size: int = 0
    adacomm_interval: int = 20
    adacomm_mode: str = "iterations"
    adacomm_t0: float = 1.0
    dasgd_delay: int = 2


@dataclass(frozen=True)
class InputShape:
    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"           # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    parallelism: ParallelismPlan = field(default_factory=ParallelismPlan)
    averaging: AveragingConfig = field(default_factory=AveragingConfig)
    optimizer: str = "momentum"   # sgd | momentum | adamw
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_schedule: str = "step"     # step | cosine | wsd | constant
    lr_warmup_steps: int = 0
    lr_decay_steps: Tuple[int, ...] = ()
    lr_decay_factor: float = 0.1
    total_steps: int = 1000
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> RunConfig:
    if name not in _REGISTRY:
        import importlib
        mod = name.replace("-", "_").replace(".", "_")
        try:
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ImportError as exc:
            raise KeyError(
                f"unknown config '{name}'; available: {sorted(_REGISTRY)}"
            ) from exc
    return _REGISTRY[name]()


def available_configs() -> Sequence[str]:
    """Every registered config name, after importing each module of
    ``repro_torch/configs``."""
    import importlib
    import pkgutil
    import repro_torch.configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "base":
            importlib.import_module(f"repro_torch.configs.{m.name}")
    return sorted(_REGISTRY)


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/block pattern, tiny dims."""
    changes: Dict[str, Any] = dict(
        n_layers=2,
        d_model=min(model.d_model, 128),
        n_heads=4,
        n_kv_heads=min(model.n_kv_heads, 4) or 4,
        d_head=32,
        d_ff=min(model.d_ff, 256) if model.d_ff else 0,
        vocab_size=min(model.vocab_size, 512),
        max_seq_len=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        scan_layers=False,
    )
    if model.moe is not None:
        changes["moe"] = dataclasses.replace(
            model.moe,
            n_experts=min(model.moe.n_experts, 4),
            top_k=min(model.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_dense=64 if model.moe.d_ff_dense else 0,
            first_k_dense=min(model.moe.first_k_dense, 1),
        )
    if model.mla is not None:
        changes["mla"] = dataclasses.replace(
            model.mla, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
        changes["d_head"] = 0
    if model.encoder is not None:
        changes["encoder"] = dataclasses.replace(
            model.encoder, n_layers=2, n_heads=4, n_frames=32)
    if model.vision is not None:
        changes["vision"] = dataclasses.replace(
            model.vision, n_patches=8, mrope_sections=(4, 6, 6))
    if model.layer_pattern is not None and len(model.layer_pattern) > 2:
        kinds = list(dict.fromkeys(model.layer_pattern))
        changes["layer_pattern"] = tuple(kinds[:2]) if len(kinds) >= 2 else model.layer_pattern
    changes.update(overrides)
    return dataclasses.replace(model, **changes)
