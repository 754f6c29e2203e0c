"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
per expert, vocab=49155, MoE 40 experts top-8 (the reference's reading of
its assignment line: the explicit "MoE 40e top-8" field).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    eos_id=0,  # <|end_of_text|>
    head_dim=64,
    n_experts=40,
    top_k=8,
    act="swiglu",
    norm="rmsnorm",
)
