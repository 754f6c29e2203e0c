"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_5_14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    eos_id=151643,  # <|endoftext|>
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    norm="rmsnorm",
    # speculative decoding pair: the 0.5B shares the Qwen2 tokenizer (its
    # 151936-entry vocab is a prefix of the 14B's padded 152064 table)
    draft_arch="qwen2_0_5b",
)
