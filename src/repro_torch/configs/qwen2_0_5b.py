"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; GQA + QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_0_5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    eos_id=151643,  # <|endoftext|>
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
