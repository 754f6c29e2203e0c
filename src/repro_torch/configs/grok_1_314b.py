"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  Adafactor optimizer (AdamW state is
too large at this size).  [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok_1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    eos_id=2,  # <|eos|>
    head_dim=128,
    n_experts=8,
    top_k=2,
    act="swiglu",
    norm="rmsnorm",
    optimizer="adafactor",
    fsdp_pods=True,
)
