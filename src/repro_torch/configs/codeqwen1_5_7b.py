"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (MHA, kv=32) d_ff=13440
vocab=92416; qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1_5_7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    eos_id=2,  # </s> (codeqwen sentencepiece)
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    norm="rmsnorm",
)
