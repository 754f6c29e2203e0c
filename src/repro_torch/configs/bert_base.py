"""BERT-base — the paper's gradual-pruning target (Table 2). Used by the
reproduction benchmarks for exact weight shapes; runnable as a causal-LM
variant of the same dims for end-to-end sanity (the HiNM/gyro machinery is
orientation-agnostic)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert_base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=30522,
    head_dim=64,
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
)
