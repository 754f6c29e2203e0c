"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE, LayerNorm + GeLU MLP. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    eos_id=0,  # <|endoftext|>
    head_dim=128,
    qkv_bias=True,
    rope_theta=100_000.0,
    act="gelu",
    norm="layernorm",
)
