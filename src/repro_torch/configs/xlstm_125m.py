"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; alternating
mLSTM + sLSTM blocks (blocks carry their own projections, no separate FFN).
Recurrent state is O(1) in sequence length.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    eos_id=0,  # <|endoftext|> (gpt-neox style)
    head_dim=192,
    block_pattern=("mlstm", "slstm"),
    norm="layernorm",
)
