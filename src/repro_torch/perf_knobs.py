"""Process-wide knobs (port of `repro.perf_knobs`).

Each knob picks between the paper's realisation and an optimisation the
reference measured, with the reference's defaults: the paged-attention
backend and telemetry (serving), causal block skipping (training
attention), and the distributed knobs that `distributed.sharding`, the
T-sharded packed matmul (`kernels.ops`) and sequence-parallel decode
attention (`models.layers`) read under a mesh.  The reference's
`xent_chunk`, `kv_block` and `q_block` are read nowhere in it, so they
have no port.

`knobs(**overrides)` swaps in a modified copy for the duration of a
``with`` block, as the reference's does.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class Knobs:
    # Embedding table sharding (`distributed.sharding`): False = vocab over
    # 'model' and features over 'data'; True = features over 'model'.
    embed_feature_shard: bool = False
    # Packed HiNM tile sharding: "both" = T over ('model', 'data');
    # "model" = T over 'model' + the trailing dim over 'data'; "model_only"
    # = T over 'model', trailing dims whole (what the T-sharded K1 needs:
    # each tile's contraction wants its full K).
    packed_t_axes: str = "model_only"
    # The T-sharded packed matmul (`ops.hinm_spmm_shard_map`): each rank
    # runs K1 over its own tiles, with no collective inside.
    packed_shard_map: bool = True
    # Decode attention: shard a stripe cache's sequence axis over 'model'
    # even where the KV heads divide it.
    decode_seq_shard: bool = True
    # Sequence-parallel decode attention (`layers._seq_parallel_decode_attn`):
    # each 'model' rank attends over its slice of the cache and the ranks
    # combine max / sum statistics.
    seq_parallel_decode: bool = True
    # Paged-attention backend (kernels/ops.paged_attention): "auto" = the
    # K2 kernel on a CUDA tensor, its plain PyTorch version on a CPU one;
    # "cuda" = the kernel (raises on a CPU tensor); "torch" = the plain
    # version on any device.  A scheduler resolves it once, at construction.
    paged_attn: str = "auto"
    # Replicate the page pools in `distributed.sharding.cache_specs` (the
    # "page" role) instead of splitting their page axis over the data
    # ranks; the reference needs it to run K2 under such a mesh.  The
    # port's pool storage is whole on every rank either way (`serve.kv`),
    # so here it changes the specs alone.
    paged_attn_sharded: bool = False
    # Serving telemetry (serve/telemetry): False = only the instruments
    # counted once per program built (prefill programs, kernel dispatch
    # decisions); True = schedulers default to wall-clock histograms and
    # request-lifecycle tracing.  Per scheduler: Scheduler(telemetry=...).
    telemetry: bool = False
    # Causal block skipping in training attention (`layers._attn_chunked`
    # with ``aligned``): query chunk i attends only to the static prefix of
    # KV blocks its causal (and window) mask reaches, instead of every
    # block with the rest masked.  Off by default, as the reference's.
    causal_block_skip: bool = False


KNOBS = Knobs()


@contextlib.contextmanager
def knobs(**overrides):
    global KNOBS
    prev = KNOBS
    KNOBS = dataclasses.replace(KNOBS, **overrides)
    try:
        yield KNOBS
    finally:
        KNOBS = prev
