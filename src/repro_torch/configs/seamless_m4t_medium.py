"""seamless-m4t-medium [audio] — 12L enc + 12L dec, d_model=1024 16H
(MHA kv=16) d_ff=4096 vocab=256206; encoder-decoder, speech frontend STUB
(the caller supplies precomputed frame embeddings, the encoder's input).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    eos_id=3,  # </s> (nllb fairseq)
    head_dim=64,
    frontend="frames",
    act="gelu",
    norm="layernorm",
)
