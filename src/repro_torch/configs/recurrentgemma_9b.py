"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention in a 1:2 pattern (rec, rec, attn)
with window 2048. Sub-quadratic -> runs the long_500k decode cell.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    eos_id=1,  # <eos> (gemma sentencepiece)
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    window=2048,
    rglru_dim=4096,
    act="gelu",
    norm="rmsnorm",
)
