"""Architecture config schema (port of `repro.configs.base`).

Only the ported configurations load; the others wait for their slice
(ROADMAP.md, Queue 1 item 8) and `load_arch` raises `KeyError` for them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.core.types import HiNMConfig

# the reference package's configs; only PORTED_IDS load here
ARCH_IDS = (
    "qwen2_5_14b",
    "starcoder2_15b",
    "qwen2_0_5b",
    "codeqwen1_5_7b",
    "recurrentgemma_9b",
    "xlstm_125m",
    "phi_3_vision_4_2b",
    "seamless_m4t_medium",
    "grok_1_314b",
    "granite_moe_3b_a800m",
)
PAPER_IDS = ("bert_base", "deit_base")
PORTED_IDS = ("qwen2_0_5b",)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # tokenizer end-of-sequence id; -1 = none (generation runs to
    # max_new_tokens). Serving ignores ids outside [0, vocab).
    eos_id: int = -1
    n_experts: int = 0
    top_k: int = 0
    block_pattern: tuple[str, ...] = ()
    window: int = 0                       # local-attention window (0 = full)
    rglru_dim: int = 0
    n_enc_layers: int = 0
    draft_arch: str = ""
    frontend: str = ""
    frontend_tokens: int = 0
    # --- numerics / sparsity ---
    dtype: Any = torch.bfloat16
    hinm: HiNMConfig = HiNMConfig()
    max_seq: int = 32768
    optimizer: str = "adamw"
    fsdp_pods: bool = False
    skip_shapes: tuple[str, ...] = ()

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's TP-16 rule;
        kept so both packages share one logits width)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def attn_out_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_out_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern))),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            window=min(self.window, 64) if self.window else 0,
            rglru_dim=128 if self.rglru_dim else 0,
            max_seq=256,
            dtype=torch.float32,
            hinm=HiNMConfig(v=8, n=2, m=4, vector_sparsity=0.5),
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def load_arch(name: str) -> ArchConfig:
    """Load `src/repro_torch/configs/<name>.py` and return its CONFIG."""
    if name not in PORTED_IDS:
        known = name in ARCH_IDS + PAPER_IDS
        raise KeyError(
            f"arch {name!r} " + ("is not ported yet; see ROADMAP.md (Queue 1) "
                                 if known else "is unknown; ")
            + f"ported: {PORTED_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
