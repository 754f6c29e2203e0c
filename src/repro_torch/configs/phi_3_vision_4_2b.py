"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUB (the caller supplies
576 precomputed patch embeddings, placed before the prompt's tokens).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi_3_vision_4_2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    eos_id=2,  # </s> (llama sentencepiece)
    head_dim=96,
    frontend="patch",
    frontend_tokens=576,
    act="swiglu",
    norm="rmsnorm",
)
