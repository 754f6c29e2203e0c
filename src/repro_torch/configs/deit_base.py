"""DeiT-base — the paper's second-order one-shot target (Table 1).
Patch-embedding frontend stub (196 tokens @ 224px/16), transformer encoder
dims; the benchmarks use its Linear shapes with a synthetic Fisher
saliency."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deit_base",
    family="vlm",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=1000,          # classifier head as vocab
    head_dim=64,
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    frontend="patch",
    frontend_tokens=196,
)
