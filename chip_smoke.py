#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py          # the whole check, one card

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — needs CUDA; prints torch/CUDA versions and the card's
               `nvidia-smi` name and power limit.
  2. build   — compiles the three hand-written kernels from
               src/repro_torch/csrc with nvcc for sm_90a into
               build/repro_torch_kernels/.
  3. kernels — holds each kernel against its plain PyTorch version on the
               card at the main path's full-width shapes (stated tolerances;
               nm_select bit for bit) and times kernel, plain version, one
               library call where there is one (timed here only; the port
               never calls it) and the bound; K2 at the verify's s = 4 and
               K1 at its B 16 held bitwise against their single-row /
               B 4 calls; K2 at the extension widths s 16-256 (row tiles)
               and K1 at the extension's B 256 and 1,024; the threefry
               PRNG and sampler on CUDA held equal to the CPU.
  4. prune   — full-width qwen2-0.5b (24 layers, bf16, random weights from
               seed 0): `ops.nm_apply` over its 24 down projections (the
               nm_select path, launch count asserted); `prune_model`
               gyro-permutation (OCP + ICP, PRUNE_ITERS iterations) on the
               card, then noperm: wall times, mean retained saliency (gyro >=
               noperm - 5e-3), every searched permutation re-checked
               against its constraints, and hinm_spmm held on gyro-pruned
               projections (permuted vec_idx).  It also starts phase 11's
               gyro searches in a child process beside its own and, once
               its own is done, phase 13's in another; and the entry
               points' subprocesses (phases 6 and 10 check them) on a
               thread.
  5. serve   — the gyro-pruned, packed model served by `Scheduler` over the
               paged KV pool, whose decode chunk, spec cycles and prefills
               run as captured CUDA graphs under double-buffered admission:
               each served workload runs once to capture its graphs, once
               replaying them (launch counts, counted through replays,
               asserted) and once as its eager twin (`graphs._eager()`);
               graphed and eager streams must be equal or part only at a
               near tie, and each path prints before (eager) and after
               (graphs): decode tok/s, p50 step, p50 TTFT, the device idle
               share, captures and replays.  First 8 greedy requests; then,
               on a live 4-slot pool, the speculative verify held against
               four decode steps, eagerly and as captured graphs (bit-equal;
               a captured decode step against the eager one), and the
               profiles (host vs device time, the kernels' share) of a
               greedy decode step, a sampled one and a speculative cycle,
               greedy and sampled; then examples/serve_hinm.py's own mix
               (every fourth request at T 0.8, top-k 16, seed = rid)
               served plain, with SpecConfig(k=3) fused and unfused: launch
               counts per verify asserted, acceptance and tokens per verify
               printed, streams identical or every parting a near tie.
               Then the share workload (12 requests, 9 over one 72-token
               system prompt, 3 long ones over its first 32 tokens) with
               prefix sharing off, on, on with prefill_chunk=64, and that
               with SpecConfig(k=3, fused=False): hits, copy-on-write,
               fewer prefill rows and held page-steps than sharing off, the
               chunked per-step bound, refcount conservation and a pristine
               pool after `clear_prefix_cache()`, K2 at an extension width
               over 98 rows; streams equal across runs or parted at a near
               tie (the extension path's measured logit noise).
  6. observe — telemetry and the flight recorder on the same model and
               Scheduler(max_slots=4, max_seq=256, page=16, decode_chunk=8):
               the main flow's mix and the share workload (sharing on,
               prefill_chunk=64) served with telemetry=True, flightrec=True
               on a fresh scheduler, first run recorded and dumped, then a
               graphed run whose streams and launch counts (from 0; 7L
               hinm_spmm and L paged_decode_attn per decode step of each
               chunk graph) must equal the serve phase's observability-off
               graphed run; each record replayed on a fresh scheduler
               (event- and token-identical) and the mix's on decode_chunk 4
               (first divergence: `config`); the metrics snapshot and a
               Chrome trace (the reference's validity checks) under
               chiprun_out/; decode tok/s and p50 step of the 8 greedy
               requests with telemetry off, on, and on with the recorder;
               torch.profiler over a few decode chunks, greedy and sampled,
               graphed and as the eager twin, top device ops per step; and
               examples/serve_hinm_torch.py as a subprocess at its defaults
               with --compare-dense, recording (exit 0, identical: True),
               then replaying the record (exit 0, replay OK), both run
               beside phase 4.
  7. agree   — teacher-forced prefill + 4 paged decode steps with the
               kernels, with the plain versions and with the masked-dense
               twin (torch.matmul): logits must agree.
  8. dense   — RMSNorm and LayerNorm rows bitwise across calls of 1, 4,
               16 and 64 rows at every ported d_model; qwen2.5-14b at its
               published widths and 8 of its 48 layers, inited
               on the card (seeded) and packed with no permutation (peak
               memory, packed and dense bytes); K1 on its projections at B
               4, 16 ("rows", the verify's) and 512, per projection and
               per layer, and K2 at KV 8, G 5, hd 128, s 1/4/64/256, held
               and timed; a verify row bitwise its decode step; prefill +
               4 decode steps against the plain versions and a float32
               forward of the same masked weights, layer by layer; 8
               greedy requests served plain and with SpecConfig(k=3) and
               the gyro-pruned 0.5B as ModelDrafter, fused (and its eager
               twin) and unfused, graphed: launches per cycle asserted,
               pools drained, streams equal to plain or parted at a near
               tie; the 0.5B drafting for itself (acceptance 1.0, or each
               rejection at a position where its stripe path and the paged
               one part, within their measured gap);
               codeqwen1.5-7b and starcoder2-15b (full width, 2 layers)
               and bert-base: packed, K1 at B 4, 16 ("rows") and 512 and
               K2 at s 1/4/64/256 at their shapes, prefill + 4 decode
               steps against the plain versions.
  9. moe     — granite-3.0 MoE (d_model 1536, 40 experts of d_ff 512,
               top-8) at full width, MOE_LAYERS (16) of its 32 layers,
               inited on the card (seeded):
               layer 0 (attention and all 40 experts of each stack)
               gyro-pruned by `prune_model` (PRUNE_ITERS), then noperm
               (retained gyro >= noperm - 5e-3, every permutation checked),
               the other 31 layers packed noperm; K1 over its expert stacks
               (one launch a stack) at C 8 and 128, bf16 and f32, held against
               its plain version, each expert bitwise a launch of it alone,
               timed beside the bound and torch.bmm; the router, softmax,
               top-k weights and k-sum bitwise across row counts; a verify
               against decode; prefill + 4 decode steps against the plain
               versions and a float32 forward; 8 greedy requests served from
               graphs (and the eager twin; 112 K1 and 16 K2 launches a decode
               step asserted) and with SpecConfig(k=3) fused: capacity drops
               counted, streams equal to plain or parted at a near tie
               within the gap the verify's drops open from decode.
 10. train   — training runs no kernel of the three (masked-dense, dense
               matmuls and PyTorch ops, as the reference's training): the
               full-width qwen2-0.5b train step (bf16, AdamW, remat; batch
               8 x 512 of SyntheticLMData, 30 steps; the loss must fall by
               0.1): p50 step, tokens/s, peak memory and the model-FLOPs
               share of the bf16 peak; microbatches=2 against one batch
               (grads); the reduced config's three f32 steps on the card
               against the CPU, and a TF32 control that each gate of that
               comparison must refuse; the loop's retry, restore-and-skip and
               resume against an uninterrupted run; gradual HiNM pruning at
               full width cut to 1 layer, gyro (the virtual refresh) and
               noperm: densities on schedule, the refresh's time, PermCache
               hits, the masks' HiNM structure, recovery gaps;
               examples/train_hinm_lm_torch.py --steps 40 as a subprocess
               (run beside phase 4).  Then the five other families, one
               after another: each at reduced() in f32 on the card against
               the CPU (step-0 grads within GRAD_TOL of each leaf's max,
               three AdamW steps' losses within LOSS_TOL); each at full
               width with its depth cut (granite 4 layers, phi-3 2 with
               576 patch rows, seamless 2 + 2 with 256 frames, xlstm 4,
               recurrentgemma 3; bf16, 10 steps; finite, the loss down by
               0.1): p50 step, tokens/s, peak memory, forward + backward
               against clip + AdamW, a profiled step's device time by op
               class, its share of the bf16 peak in its own model FLOPs;
               granite's gradual masks over its expert stacks at full
               width (each expert's mask its own, density on schedule);
               and causal block skipping on the 0.5B at 2 x 2,048, the
               knob off and on (loss and grads within MICRO_TOL, step ms
               and peak memory of each).
 11. frontend — the frontend-stub families at full width, inited on the
               card (seeded), frontend rows seeded N(0, 1): phi-3-vision-4.2b
               (32 layers, d 3072, 32/32 heads, hd 96, d_ff 8192; 576
               patch rows before the prompt) and seamless-m4t-medium (12
               encoder + 12 decoder layers, d 1024, 16/16 heads, hd 64,
               d_ff 4096, vocab 256,206; frames through the encoder, the
               decoder's cross-attention over each slot's enc_out of
               T_ENC rows).  Each: layer 0 of each stack gyro-pruned by
               `prune_model` (MOE_PRUNE_ITERS), then noperm (retained gyro
               >= noperm - 5e-3, every permutation checked), in a child
               process started in phase 4 beside its own search (phi-3's
               takes ~150 s), tied to this phase's model by a digest of
               the weights; the rest packed noperm; K1 on its projections at B 4, 16 ("rows")
               and a prefill's width (seamless' cross-attention k/v also
               at 4 x T_ENC rows) and K2 at its head layout, s 1/4/64/256,
               held and timed; a verify row bitwise its decode step on a
               live pool of frontend requests; frontend rows + prefill +
               4 decode steps against the plain versions and a float32
               twin; 8 greedy requests (phi-3: every other one after 576
               patch rows; seamless: 64-256 frames, 8-64 tokens) on
               Scheduler(max_slots=4, max_seq=1024, page=16,
               decode_chunk=8), graphed and eager (launches per decode
               step and admission group asserted: phi-3 224 K1 and 32 K2
               a step; seamless 120 K1 a step, 192 a group, 12 K2), and
               SpecConfig(k=3) fused: streams equal or parted at a near
               tie.  Phase 8's norm rows cover their d_model 3072 and 1024.
 12. ssm     — xlstm-125m at full width (12 layers, mLSTM/sLSTM, d 768, 4
               heads of state width 192, vocab 50,304, LayerNorm, bf16),
               inited on the card (seeded): the first period (layer 0 of
               each pattern-position stack) gyro-pruned by `prune_model`
               (MOE_PRUNE_ITERS), then noperm (retained gyro >= noperm -
               5e-3, every permutation checked), the rest packed noperm;
               K1 on the 5 planned projections of each block kind at B 4
               and at one exact prefill group's rows (2 x 37), held and
               timed beside torch.matmul and the bound; prefill + 4 decode
               steps against the plain versions and a float32 twin;
               Scheduler(max_slots=4, max_seq=256, page=16,
               decode_chunk=8) on stripes (the page falls back): 8 greedy
               requests of 4 distinct prompt lengths (16-128, two
               arriving a step, so exact-length groups of two form) and 2
               sampled ones, 32 new tokens each, graphed and eager, streams
               equal; 60 K1 and 0 K2 a decode step and 60 K1 an admission
               group asserted; the prefill graphs keyed by exact length,
               each prefill length's eager, capture and replay times;
               SpecConfig(k=3) and bucket=True refused.
 13. hybrid  — recurrentgemma-9b at full width (d 4096, RG-LRU width 4096,
               16 heads over one KV head of hd 256, d_ff 12288 gelu, vocab
               256,000, window 2,048) cut to 8 of its 38 layers: two full
               (rec, rec, attn) periods and the partial (rec, rec) one,
               inited on the card (seeded).  Layers 0 (RG-LRU) and 2
               (attention) gyro-pruned by `prune_model` (MOE_PRUNE_ITERS),
               then noperm, in a child process started after phase 4 and tied
               to this phase's model by a digest; the rest packed noperm.
               K1 on each distinct projection shape of those layers at B 4
               ("rows": decode, and each step of the sequential verify)
               and B 2,100 ("mma": the longest prefill); K2 at hd 256, KV
               1, G 16, window 2,048 over wrapped rings of 128 pages of 16
               rows, s 1 and 4; a sequential verify bitwise its four decode
               steps on a live pool whose rings wrap mid-verify; prefill +
               4 decode steps against the plain versions and a float32
               twin; 8 greedy requests (prompts of 16-80 tokens, one of
               2,000 whose decode crosses position 2,048 and one of 2,100,
               rolled into the ring at prefill; 64 new each) on
               Scheduler(max_slots=4, max_seq=2304, page=16,
               decode_chunk=8): graphed = eager = each request alone,
               exactly; SpecConfig(k=3) fused and unfused equal to plain;
               launches a decode step (54 K1, 2 K2), a verify (4 steps)
               and an admission group (54 K1) asserted.
Each phase prints its seconds.  The line before the last holds the
per-kernel JSON; the last line is {"ok": true, "device": {...}}.
"""
import atexit
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}     # relative to max|y|
# absolute; outputs are O(1) (a softmax-weighted mean of N(0, 1) values),
# so 1e-2 is a few bf16 ulps
K2_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# kernels vs plain versions through the bf16 layers: both round every
# projection output to bf16 but sum in different orders, so logits drift
# by bf16 rounding compounded over depth (relative to max|logit|)
AGREE_TOL = 5e-2
EOS = 151643


_PHASE = {}


def phase(name=None):
    """Open phase `name` (None: close the last), printing the seconds the
    phase before it took."""
    now = time.perf_counter()
    if _PHASE:
        print(f"--- phase {_PHASE['name']} took {now - _PHASE['t0']:.1f} s", flush=True)
        SECONDS[_PHASE["name"]] = now - _PHASE["t0"]
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"\n=== {name} ===", flush=True)


SECONDS = {}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_FLUSH = None


def time_ms(fn, iters=10):
    """Median device time of one call, L2 cold: a 64 MB write (over the
    50 MB L2) between calls, CUDA events around each call only.  The
    device first spins for ~0.1 s so the host enqueues every call ahead of
    it: the events then bracket device work, not host launch gaps (valid
    for calls of up to a few hundred launches: more fill the launch queue
    and stall the host until the spin ends)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for s, e in ev:
        _FLUSH.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

# the four distinct full-width projection shapes (n_out, n_in) and how
# often each runs per layer: q/o, k/v, gate/up, down
PROJ = {"q/o": (896, 896, 2), "k/v": (128, 896, 2), "gate/up": (4864, 896, 2),
        "down": (896, 4864, 1)}


def k1_case(label, p, b, gen, variant=None):
    """Hold K1 against its plain version on packed weight `p` at batch `b`
    (x random, in p's dtype) and time kernel (`variant`, or the one its
    dispatch picks), plain version, `torch.matmul` on the masked-dense
    weight and the bound."""
    from repro_torch.core import packing
    from repro_torch.kernels import hinm_spmm as hs

    dtype, n_out, n_in, v = p.vals.dtype, p.n_out, p.n_in, p.config.v
    x = torch.randn((b, n_in), generator=gen, device="cuda").to(dtype)
    y = hs.hinm_spmm(x, p, variant=variant)
    torch.cuda.synchronize()
    y_ref = hs.hinm_spmm_ref(x, p)
    torch.cuda.synchronize()
    scale = float(y_ref.float().abs().max())
    err = float((y.float() - y_ref.float()).abs().max())
    rel = err / max(scale, 1e-30)
    w_dense = packing.unpack(p)                       # masked-dense (n_out, n_in)
    ms = time_ms(lambda: hs.hinm_spmm(x, p, variant=variant))
    plain_ms = time_ms(lambda: hs.hinm_spmm_ref(x, p))
    lib_ms = time_ms(lambda: torch.matmul(x, w_dense.T))
    isz = x.element_size()
    nbytes = (x.numel() * isz + p.packed_bytes() + b * n_out * isz)
    ops = 2.0 * p.vals.numel() * b
    b_ms, b_by = bound(nbytes, ops, dtype)
    tol = K1_TOL[dtype]
    variant = variant or hs.variant(b, p, dtype)
    line = dict(case=label, shape=[n_out, n_in], B=b, dtype=str(dtype).split(".")[-1],
                V=v, variant=variant, max_abs_err=err, max_rel_err=rel, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K1 {label:12s} {n_out}x{n_in} B={b:<4d} {line['dtype']:8s} V={v:<2d} "
          f"{variant:4s} rel_err={rel:.2e} (tol {tol:.0e}) kernel {ms*1e3:8.1f} us  plain "
          f"{plain_ms*1e3:8.1f} us  matmul {lib_ms*1e3:8.1f} us  bound "
          f"{b_ms*1e3:7.1f} us ({b_by})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"K1 {label} B={b}: relative error {rel} > {tol}")
    return line


def k1_random(label, n_out, n_in, b, dtype, v, gen):
    """K1 on a random weight packed with no permutation (ascending vec_idx)."""
    from repro_torch.core import packing
    from repro_torch.core.types import HiNMConfig

    p = packing.pack(torch.randn((n_out, n_in), generator=gen, device="cuda").to(dtype),
                     HiNMConfig(v=v))
    return k1_case(label, p, b, gen)


def paged_case(b, s, kvh, g, hd, page, n_bt, n_pages, dtype, seed, sweep=2, full=False,
               idle=None, extend=False):
    """Randomly allocated paged pool with sentinel pages (unallocated table
    tail) and swept rows (kpos reset to the sentinel, as a rollback leaves).
    `full`: every slot's table allocated and every row live.  `idle`: that
    slot becomes an idle lane — its whole table the sentinel page (whose V
    is random like every page's), its position 0.  `extend`: an extension
    prefill's layout — every table entry allocated, each slot's s query
    rows starting mid-table (after 16 to 128 prefix rows) at consecutive
    positions, the rows up to the last query's (or the view's end) live,
    the rest unwritten."""
    from repro_torch.models import paging

    rng = np.random.default_rng(seed)
    pool_shape = (n_pages, page, kvh, hd)
    kp = rng.normal(size=pool_shape).astype(np.float32)
    vp = rng.normal(size=pool_shape).astype(np.float32)
    kpos = np.full((n_pages, page), paging.KPOS_SENTINEL, np.int32)
    bt = np.full((b, n_bt), paging.SENTINEL_PAGE, np.int32)
    free = list(range(paging.N_RESERVED, n_pages))
    rng.shuffle(free)
    positions = []
    for bi in range(b):
        if extend:
            pages = [free.pop() for _ in range(n_bt)]
            bt[bi] = pages
            start = int(rng.integers(16, 129))
            for r in range(min(start + s, n_bt * page)):
                kpos[pages[r // page], r % page] = r
            positions.append([start + i for i in range(s)])
            continue
        n_alloc = n_bt if full else int(rng.integers(1, n_bt + 1))
        pages = [free.pop() for _ in range(n_alloc)]
        bt[bi, :n_alloc] = pages
        live = n_alloc * page if full else int(rng.integers(1, n_alloc * page + 1))
        for r in range(live):
            kpos[pages[r // page], r % page] = r
        for r in rng.choice(live, size=min(sweep, live), replace=False):
            if r != live - 1:
                kpos[pages[r // page], r % page] = paging.KPOS_SENTINEL
        positions.append([live - 1 + i for i in range(s)])
    if idle is not None:
        bt[idle] = paging.SENTINEL_PAGE
        positions[idle] = list(range(s))
    q = rng.normal(size=(b, s, kvh * g, hd)).astype(np.float32)

    def dev(a, dt=None):
        t = torch.from_numpy(a).cuda()
        return t.to(dt) if dt is not None else t

    return (dev(q, dtype), dev(kp, dtype), dev(vp, dtype), dev(kpos), dev(bt),
            dev(np.asarray(positions, np.int32)))


def sdpa_args(q, kp, vp, kpos, bt, q_pos, window):
    """scaled_dot_product_attention's arguments over the gathered view:
    q, K and V (GQA-expanded) as (B, H, len, hd) views, and the mask."""
    from repro_torch.models import paging

    h = q.shape[2]
    kvh = kp.shape[2]
    k = paging.gather_view(kp, bt).repeat_interleave(h // kvh, dim=2)
    v = paging.gather_view(vp, bt).repeat_interleave(h // kvh, dim=2)
    p = paging.gather_view(kpos, bt)
    m = p[:, None, :] <= q_pos[:, :, None]
    if window:
        m &= p[:, None, :] > q_pos[:, :, None] - window
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), m[:, None]


def sdpa_view(q, kp, vp, kpos, bt, q_pos, window):
    """Yardstick: scaled_dot_product_attention over the gathered view
    (gather, GQA expansion and mask inside the timed call)."""
    import torch.nn.functional as F

    qt, k, v, m = sdpa_args(q, kp, vp, kpos, bt, q_pos, window)
    return F.scaled_dot_product_attention(qt, k, v, attn_mask=m)


def k2_case(label, b, s, window, dtype, seed, n_bt=16, hd=64, full=False, idle=None,
            extend=False, kvh=2, g=7, case=None):
    """Hold K2 against its plain version on a random paged pool (B slots,
    KV `kvh`, G `g`, page 16; qwen2-0.5b's 2 and 7 unless given), or on
    the inputs `case` (q, k pool, v pool, kpos, bt, q_pos) of those
    shapes, and time kernel, plain version, SDPA over the gathered view,
    SDPA alone (its inputs gathered and GQA-expanded before the timed
    window) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paging

    page = 16
    n_pages = b * n_bt + 2
    q, kp, vp, kpos, bt, q_pos = case or paged_case(b, s, kvh, g, hd, page, n_bt, n_pages,
                                                    dtype, seed, full=full, idle=idle,
                                                    extend=extend)
    out = pa.paged_decode_attn(q, kp, vp, kpos, bt, q_pos, window=window)
    n_splits, n_tiles = pa.paged_decode_attn.last_splits, pa.paged_decode_attn.last_tiles
    torch.cuda.synchronize()
    ref = pa.paged_decode_attn_ref(q, kp, vp, kpos, bt, q_pos, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ms = time_ms(lambda: pa.paged_decode_attn(q, kp, vp, kpos, bt, q_pos, window=window))
    plain_ms = time_ms(lambda: pa.paged_decode_attn_ref(q, kp, vp, kpos, bt, q_pos,
                                                        window=window))
    lib_ms = time_ms(lambda: sdpa_view(q, kp, vp, kpos, bt, q_pos, window))
    args = [a.contiguous() for a in sdpa_args(q, kp, vp, kpos, bt, q_pos, window)]
    only_ms = time_ms(lambda: F.scaled_dot_product_attention(*args[:3], attn_mask=args[3]))
    isz = q.element_size()
    # what the function needs: each distinct page's k, v, kpos read once
    # (the shared sentinel page once, however many table entries name it),
    # and scores only for the (query, key) pairs the mask keeps
    page_rows = torch.unique(bt).numel() * page
    nbytes = (2 * q.numel() * isz + page_rows * (2 * kvh * hd * isz + 4)
              + bt.numel() * 4 + q_pos.numel() * 4)
    view = paging.gather_view(kpos, bt)
    keep = view[:, None, :] <= q_pos[:, :, None]
    if window:
        keep &= view[:, None, :] > q_pos[:, :, None] - window
    ops = 4.0 * kvh * g * int(keep.sum()) * hd       # q.k and p.v, f32 in-kernel
    b_ms, b_by = bound(nbytes, ops, dtype)
    tol = K2_TOL[dtype]
    line = dict(case=label, B=b, s=s, window=window, KV=kvh, G=g, hd=hd, page=page,
                n_bt=n_bt, dtype=str(dtype).split(".")[-1], n_splits=n_splits, n_tiles=n_tiles,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                sdpa_only_ms=only_ms, bound_ms=b_ms, bound_by=b_by)
    if idle is not None:
        line["idle_row_err"] = float(diff[idle].max())
    if s > 1:
        rows = torch.cat([pa.paged_decode_attn(q[:, i:i + 1].contiguous(), kp, vp, kpos, bt,
                                               q_pos[:, i:i + 1].contiguous(), window=window)
                          for i in range(s)], dim=1)
        line["rows_bit_equal_s1"] = bool(torch.equal(out, rows))
        if not line["rows_bit_equal_s1"] and not window:
            raise AssertionError(f"K2 {label} {dtype}: s={s} rows are not bitwise the s=1 "
                                 "calls' (a verify would not be decode)")
    print(f"K2 {label:18s} B={b:<3d} s={s} window={window:<3d} n_bt={n_bt:<4d} hd={hd:<3d} "
          f"KV={kvh} G={g} {line['dtype']:8s} splits {n_splits:<3d} tiles {n_tiles} err={err:.2e} (tol {tol:.0e}) "
          f"kernel "
          f"{ms*1e3:7.1f} us  plain {plain_ms*1e3:8.1f} us  sdpa(view) {lib_ms*1e3:7.1f} us  "
          f"sdpa alone {only_ms*1e3:7.1f} us  bound {b_ms*1e3:6.2f} us ({b_by})"
          + (f"  rows bitwise the single-row calls' {line['rows_bit_equal_s1']}"
             if "rows_bit_equal_s1" in line else ""), flush=True)
    if not err <= tol:
        raise AssertionError(f"K2 {label} s={s} window={window} n_bt={n_bt} {dtype}: "
                             f"error {err} > {tol}")
    return line


def k2_cases():
    """Every K2 case: s 1/3 x window 0/64 x bf16/f32 at the served shape
    (B 4, n_bt 16, 1-16 pages allocated per slot at random); the
    speculative verify's s = k+1 = 4 (window 0, both dtypes); an idle lane
    (one slot's table all sentinel, position 0) at s 1 and 4 in both
    dtypes; the context sweep (n_bt 16/64/256, every table full); one split
    (the direct-output path: B * KV over one wave, 4 entries); a head dim
    whose rows are not 16-byte aligned (the scalar path) in both dtypes.
    Every case of s > 1 also holds the kernel's rows bitwise against s
    single-row calls (what makes a verify's row i decode step i's)."""
    bf16, f32 = torch.bfloat16, torch.float32
    out, seed = [], 0
    for dtype in (bf16, f32):
        for s in (1, 3):
            for window in (0, 64):
                out.append(k2_case(f"s={s} window={window}", 4, s, window, dtype, seed))
                seed += 1
        out.append(k2_case("verify s=4", 4, 4, 0, dtype, seed))
        seed += 1
    for dtype in (bf16, f32):
        for s in (1, 4):
            out.append(k2_case(f"idle lane s={s}", 4, s, 0, dtype, seed, idle=1))
            seed += 1
    for n_bt in (16, 64, 256):
        out.append(k2_case(f"context n_bt={n_bt}", 4, 1, 0, bf16, seed, n_bt=n_bt, full=True))
        seed += 1
    out.append(k2_case("one split", 72, 1, 0, bf16, seed, n_bt=4))
    for dtype in (bf16, f32):
        seed += 1
        out.append(k2_case("unaligned hd", 4, 3, 0, dtype, seed, hd=18))
    if {c["n_splits"] == 1 for c in out} != {True, False}:
        raise AssertionError("K2 cases do not cover both the one-split and the combine path")
    if {c["n_tiles"] for c in out} != {1}:
        raise AssertionError("a decode or verify shape of K2 ran in row tiles")
    return out


# the extension prefill's widths: a chunk (16, 64) or a suffix bucket (128,
# 256) of query rows per slot
K2_EXTENSION_S = (16, 64, 128, 256)


def k2_extension_cases():
    """K2 at the extension widths, s 16, 64, 128 and 256 query rows per
    slot over B 4, KV 2, G 7, hd 64, page 16, n_bt 16 (every entry
    allocated), bf16 and f32, each slot's rows starting mid-table (after
    16-128 prefix rows): held against the plain version and timed beside
    SDPA over the gathered view, SDPA alone and the bound; each s > 1 case
    also holds its rows bitwise against single-row calls (a row tile keeps
    a row's bits).  Every s here runs in row tiles (over TILE_ROWS rows a
    block)."""
    out = []
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        for j, s in enumerate(K2_EXTENSION_S):
            out.append(k2_case(f"extension s={s}", 4, s, 0, dtype, 100 + 10 * i + j,
                               extend=True))
    tiled = {c["s"] for c in out if c["n_tiles"] > 1}
    if tiled != set(K2_EXTENSION_S):
        raise AssertionError(f"K2 extension cases ran row tiles only at s {sorted(tiled)}")
    return out


def k2_tile_sweep():
    """K2 (bf16) at s 16, 64 and 256 in the extension layout, through the
    wrapper's private launch at forced rows a block (the plan's splits):
    what the plan's TILE_ROWS cap rests on.  Each held against the plain
    version."""
    from repro_torch.kernels import paged_attn as pa

    sweep = {}
    for s in (16, 64, 256):
        args = paged_case(4, s, 2, 7, 64, 16, 16, 4 * 16 + 2, torch.bfloat16, 7, extend=True)
        ref = pa.paged_decode_attn_ref(*args).float()
        row = {}
        for rows in (r for r in (28, 56, 112, 224, 448) if r <= 7 * s):
            run = lambda: pa._launch(*args, 0, None, rows)  # noqa: E731
            err = float((run()[0].float() - ref).abs().max())
            if not err <= K2_TOL[torch.bfloat16]:
                raise AssertionError(f"K2 at {rows} rows a block, s={s}: error {err}")
            row[rows] = time_ms(run)
        pa.paged_decode_attn(*args)
        sweep[f"s={s}"] = {"plan_tiles": pa.paged_decode_attn.last_tiles, "ms_by_rows": row}
        print(f"K2 tile sweep s={s} (plan: {pa.paged_decode_attn.last_tiles} tiles): " + "  ".join(
            f"{r} rows: {ms*1e3:.1f} us" for r, ms in row.items()), flush=True)
    return {"tile_sweep": sweep}


def k2_split_sweep():
    """K2 (bf16) at forced split counts, through the wrapper's private
    launch, at the decode shape (s 1 and 3) and at n_bt 256 (every table
    full): what the split plan's TARGET_BLOCKS and MAX_SPLIT_PAGES rest on."""
    from repro_torch.kernels import paged_attn as pa

    sweep = {}
    for s, n_bt, full, counts in ((1, 16, False, (1, 2, 4, 8, 16)),
                                  (3, 16, False, (1, 2, 4, 8, 16)),
                                  (1, 256, True, (8, 16, 32, 64))):
        args = paged_case(4, s, 2, 7, 64, 16, n_bt, 4 * n_bt + 2, torch.bfloat16, 0,
                          full=full)
        ref = pa.paged_decode_attn_ref(*args).float()
        row = {}
        for n in counts:
            err = float((pa._launch(*args, 0, n)[0].float() - ref).abs().max())
            if not err <= K2_TOL[torch.bfloat16]:
                raise AssertionError(f"K2 at {n} splits, s={s} n_bt={n_bt}: error {err}")
            row[n] = time_ms(lambda: pa._launch(*args, 0, n))
        pa.paged_decode_attn(*args)
        chosen = pa.paged_decode_attn.last_splits
        sweep[f"s={s} n_bt={n_bt}"] = {"chosen": chosen, "ms_by_splits": row}
        print(f"K2 split sweep s={s} n_bt={n_bt:<3d} (plan: {chosen}): " + "  ".join(
            f"{n}: {ms*1e3:.1f} us" for n, ms in row.items()), flush=True)
    return {"split_sweep": sweep}


# K3: every full-width projection shape of the model (HiNM orientation,
# N:M along the last axis), both dtypes, every (N, M) the reference tests
K3_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
K3_NM = ((2, 4), (1, 4), (1, 2))


def k3_input(shape, dtype, gen):
    """Random weight whose first rows hold exact ties: all equal values,
    +0.0 against -0.0, and x against -x (equal magnitudes)."""
    w = torch.randn(shape, generator=gen, device="cuda")
    cols = shape[-1]
    w[0] = 0.75
    w[1] = torch.where(torch.arange(cols, device="cuda") % 3 == 0, -0.0, 0.0)
    w[2] = torch.where(torch.arange(cols, device="cuda") % 2 == 0, 1.5, -1.5)
    return w.to(dtype)


def k3_case(label, w, nn, mm, run=None):
    """Hold K3 bit for bit against its plain version and time both; `run`
    is the call under test (default: the kernel wrapper on `w`)."""
    from repro_torch.kernels import nm_select as nms

    run = run or (lambda: nms.nm_select(w, nn, mm))
    out = run()
    torch.cuda.synchronize()
    ref = nms.nm_select_ref(w, nn, mm)
    torch.cuda.synchronize()
    bits = torch.int16 if w.dtype == torch.bfloat16 else torch.int32
    equal = bool(torch.equal(out.view(bits), ref.view(bits)))
    err = float((out.float() - ref.float()).abs().max())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: nms.nm_select_ref(w, nn, mm))
    b_ms, b_by = bound(2 * w.numel() * w.element_size(), 0, w.dtype)
    line = dict(case=label, shape=list(w.shape), N=nn, M=mm,
                dtype=str(w.dtype).split(".")[-1], bit_equal=equal, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"K3 {label:10s} {'x'.join(map(str, w.shape)):14s} {nn}:{mm} {line['dtype']:8s} "
          f"bit-equal {equal}  kernel {ms*1e3:8.1f} us  plain {plain_ms*1e3:9.1f} us  "
          f"bound {b_ms*1e3:7.1f} us ({b_by}; {b_ms / ms:.1%} of the kernel's time)",
          flush=True)
    if not equal:
        raise AssertionError(f"K3 {label} {tuple(w.shape)} {nn}:{mm} {w.dtype}: not "
                             f"bit-equal to the plain version (max abs err {err})")
    return line


# the C dispatch's crossover: bf16 batches up to it run the "rows" variant,
# larger ones "mma" (csrc/hinm_spmm.cu ROWS_MAX_B; chosen from k1_layer's
# crossover sweep)
K1_CROSSOVER = 8


def kernels_phase():
    gen = torch.Generator(device="cuda").manual_seed(1)
    k1 = []
    # both variants and their edges: decode, the crossover, prefill buckets
    for label, (n_out, n_in, _) in PROJ.items():
        wide = label in ("gate/up", "down")
        for b in ((1, 4, K1_CROSSOVER, K1_CROSSOVER + 1, 16, 64, 512) if wide else (4, 512)):
            k1.append(k1_random(label, n_out, n_in, b, torch.bfloat16, 32, gen))
    for b in (16, 512):                 # f32 runs "rows" at every batch
        k1.append(k1_random("gate/up", 4864, 896, b, torch.float32, 32, gen))
    for b in (4, 512):                  # V = 8 (reduced configs): N = 8 on the MMA
        k1.append(k1_random("q/o", 896, 896, b, torch.bfloat16, 8, gen))
    for b in (4, 129):                  # a CPU-sweep shape: Kn = 12, rows not 16-byte aligned
        k1.append(k1_random("unaligned", 64, 48, b, torch.bfloat16, 8, gen))
    at = {c["B"]: c["variant"] for c in k1 if c["case"] == "down" and c["dtype"] == "bfloat16"}
    if (at[K1_CROSSOVER], at[K1_CROSSOVER + 1]) != ("rows", "mma"):
        raise AssertionError(f"K1 dispatch crossover is not K1_CROSSOVER = {K1_CROSSOVER}: {at}")
    layer, crossover, ps, dense = k1_layer(gen)
    layer["verify"] = k1_verify_layer(gen, ps, dense)
    layer["extension"] = {b: k1_layer_at("extension", gen, ps, dense, b) for b in (256, 1024)}
    k2 = k2_cases() + k2_extension_cases()
    k2_sweep = k2_split_sweep() | k2_tile_sweep()
    k3 = [k3_case("random", k3_input(shape, dtype, gen), nn, mm)
          for dtype in (torch.bfloat16, torch.float32) for shape in K3_SHAPES
          for nn, mm in K3_NM]
    return k1, layer, crossover, k2, k2_sweep, k3


def k1_layer(gen):
    """One decode layer's seven projections (q, k, v, o, gate, up, down) at
    B = 4 in bf16, V = 32: checked, then timed as one call of seven
    launches (kernel, plain version, and `torch.matmul` on the masked-dense
    weights); the bound counts each distinct input once.  Then the
    crossover: the same seven projections at B around K1_CROSSOVER, timed
    through each variant."""
    from repro_torch.core import packing
    from repro_torch.core.types import HiNMConfig
    from repro_torch.kernels import hinm_spmm as hs

    b, dt = 4, torch.bfloat16
    xs_by_n = {n: torch.randn((b, n), generator=gen, device="cuda").to(dt)
               for n in (896, 4864)}
    xs, ps = [], []
    for n_out, n_in, reps in PROJ.values():
        for _ in range(reps):
            xs.append(xs_by_n[n_in])
            ps.append(packing.pack(torch.randn((n_out, n_in), generator=gen,
                                               device="cuda").to(dt), HiNMConfig(v=32)))
    dense = [packing.unpack(p) for p in ps]

    def run(fn):
        return [fn(x, p) for x, p in zip(xs, ps)]

    ys = run(hs.hinm_spmm)
    torch.cuda.synchronize()
    refs = run(hs.hinm_spmm_ref)
    torch.cuda.synchronize()
    err = max(float((y.float() - r.float()).abs().max()) for y, r in zip(ys, refs))
    rel = max(float((y.float() - r.float()).abs().max()) / float(r.float().abs().max())
              for y, r in zip(ys, refs))
    ms = time_ms(lambda: run(hs.hinm_spmm))
    plain_ms = time_ms(lambda: run(hs.hinm_spmm_ref))
    lib_ms = time_ms(lambda: [torch.matmul(x, w.T) for x, w in zip(xs, dense)])
    isz = xs[0].element_size()
    nbytes = (sum(x.numel() * isz for x in xs_by_n.values())
              + sum(p.packed_bytes() + b * p.n_out * isz for p in ps))
    ops = sum(2.0 * p.vals.numel() * b for p in ps)
    b_ms, b_by = bound(nbytes, ops, dt)
    tol = K1_TOL[dt]
    print(f"K1 one decode layer (7 projections, B={b}, bf16, V=32, one call, "
          f"{hs.variant(b, ps[0], dt)}): rel_err={rel:.2e} (tol {tol:.0e}) kernel "
          f"{ms*1e3:8.1f} us  plain {plain_ms*1e3:8.1f} us  matmul {lib_ms*1e3:8.1f} us  "
          f"bound {b_ms*1e3:7.2f} us ({b_by})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"K1 decode layer: relative error {rel} > {tol}")
    crossover = {}
    for bx in (4, K1_CROSSOVER, K1_CROSSOVER + 1, 16, 24):
        xs_b = {n: torch.randn((bx, n), generator=gen, device="cuda").to(dt)
                for n in (896, 4864)}
        row = {var: time_ms(lambda: [hs.hinm_spmm(xs_b[p.n_in], p, variant=var) for p in ps])
               for var in hs.VARIANTS}
        crossover[bx] = row
        print(f"K1 crossover: one layer's 7 projections at B={bx:<3d} rows "
              f"{row['rows']*1e3:7.1f} us  mma {row['mma']*1e3:7.1f} us  (dispatch: "
              f"{hs.variant(bx, ps[0], dt)})", flush=True)
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by), crossover, ps, dense


def k1_verify_layer(gen, ps, dense, b=16, label="verify"):
    """The speculative verify's decode layer: a layer's projections `ps`
    (the kernels phase's seven at 0.5B widths) at B = slots x (k+1) = 16
    rows, bf16, V 32.  The verify runs them on the
    variant decode runs for 4 slots ("rows": its sums do not depend on the
    batch, so row i is bitwise what decode computes; asserted here against
    four B = 4 calls); the dispatch's own choice at B 16 ("mma") is held and
    timed beside it.  Each: checked against the plain version, timed as one
    call of seven launches, with `torch.matmul` and the bound."""
    from repro_torch.kernels import hinm_spmm as hs

    dt = torch.bfloat16
    xs_by_n = {n: torch.randn((b, n), generator=gen, device="cuda").to(dt)
               for n in sorted({p.n_in for p in ps})}
    xs = [xs_by_n[p.n_in] for p in ps]
    refs = [hs.hinm_spmm_ref(x, p) for x, p in zip(xs, ps)]
    lib_ms = time_ms(lambda: [torch.matmul(x, w.T) for x, w in zip(xs, dense)])
    isz = 2
    nbytes = (sum(x.numel() * isz for x in xs_by_n.values())
              + sum(p.packed_bytes() + b * p.n_out * isz for p in ps))
    b_ms, b_by = bound(nbytes, sum(2.0 * p.vals.numel() * b for p in ps), dt)
    out = {}
    for var in ("rows", hs.variant(b, ps[0], dt)):
        ys = [hs.hinm_spmm(x, p, variant=var) for x, p in zip(xs, ps)]
        torch.cuda.synchronize()
        rel = max(float((y.float() - r.float()).abs().max()) / float(r.float().abs().max())
                  for y, r in zip(ys, refs))
        ms = time_ms(lambda: [hs.hinm_spmm(x, p, variant=var) for x, p in zip(xs, ps)])
        line = dict(B=b, variant=var, max_rel_err=rel,
                    max_abs_err=max(float((y.float() - r.float()).abs().max())
                                    for y, r in zip(ys, refs)),
                    ms=ms, plain_ms=None, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if var == "rows":
            line["plain_ms"] = time_ms(lambda: [hs.hinm_spmm_ref(x, p) for x, p in zip(xs, ps)])
            quarters = [torch.cat([hs.hinm_spmm(x[i:i + 4].contiguous(), p)
                                   for i in range(0, b, 4)]) for x, p in zip(xs, ps)]
            line["rows_bit_equal_b4"] = all(torch.equal(y, q) for y, q in zip(ys, quarters))
            if not line["rows_bit_equal_b4"]:
                raise AssertionError(f"K1 {label} rows at B 16 is not bitwise four B 4 calls")
        print(f"K1 {label} layer ({len(ps)} projections, B={b}, bf16, V=32, {var}): "
              f"rel_err={rel:.2e} "
              f"(tol {K1_TOL[dt]:.0e}) kernel {ms*1e3:7.1f} us  matmul {lib_ms*1e3:7.1f} us  "
              f"bound {b_ms*1e3:6.2f} us ({b_by})"
              + (f"  plain {line['plain_ms']*1e3:7.1f} us  rows bitwise B4 "
                 f"{line['rows_bit_equal_b4']}" if var == "rows" else ""), flush=True)
        if not rel <= K1_TOL[dt]:
            raise AssertionError(f"K1 {label} layer {var}: relative error {rel}")
        out[var] = line
    return out


def k1_layer_at(label, gen, ps, dense, b):
    """A layer's projections `ps` at batch `b`, bf16, V 32, the variant the
    dispatch picks: checked against the plain version, timed as one call
    (kernel, plain version, `torch.matmul` on the masked-dense weights
    `dense`, the bound; each distinct input counted once).  The kernels
    phase runs the 0.5B's seven at an extension's B = 4 slots x the width
    bucket (256 = 4 x 64, a chunk; 1,024 = 4 x 256, a long suffix, "mma")."""
    from repro_torch.kernels import hinm_spmm as hs

    dt = torch.bfloat16
    xs_by_n = {n: torch.randn((b, n), generator=gen, device="cuda").to(dt)
               for n in sorted({p.n_in for p in ps})}
    xs = [xs_by_n[p.n_in] for p in ps]
    ys = [hs.hinm_spmm(x, p) for x, p in zip(xs, ps)]
    torch.cuda.synchronize()
    refs = [hs.hinm_spmm_ref(x, p) for x, p in zip(xs, ps)]
    rel = max(float((y.float() - r.float()).abs().max()) / float(r.float().abs().max())
              for y, r in zip(ys, refs))
    err = max(float((y.float() - r.float()).abs().max()) for y, r in zip(ys, refs))
    ms = time_ms(lambda: [hs.hinm_spmm(x, p) for x, p in zip(xs, ps)])
    plain_ms = time_ms(lambda: [hs.hinm_spmm_ref(x, p) for x, p in zip(xs, ps)])
    lib_ms = time_ms(lambda: [torch.matmul(x, w.T) for x, w in zip(xs, dense)])
    nbytes = (sum(x.numel() * 2 for x in xs_by_n.values())
              + sum(p.packed_bytes() + b * p.n_out * 2 for p in ps))
    b_ms, b_by = bound(nbytes, sum(2.0 * p.vals.numel() * b for p in ps), dt)
    var = hs.variant(b, ps[0], dt)
    print(f"K1 {label} layer ({len(ps)} projections, B={b}, bf16, V=32, {var}): "
          f"rel_err={rel:.2e} (tol {K1_TOL[dt]:.0e}) kernel {ms*1e3:8.1f} us  plain "
          f"{plain_ms*1e3:8.1f} us  matmul {lib_ms*1e3:8.1f} us  bound {b_ms*1e3:7.2f} us "
          f"({b_by}; {b_ms / ms:.1%} of the kernel's time)", flush=True)
    if not rel <= K1_TOL[dt]:
        raise AssertionError(f"K1 {label} layer B {b}: relative error {rel}")
    return dict(B=b, variant=var, max_rel_err=rel, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def k1_prefill_layer(k1, launches):
    """K1 at prefill, from the kernels phase's B 512 cases (bf16, V 32, the
    "mma" variant its dispatch picks): one layer's seven projections, so
    the sum over PROJ of each shape's case times its count per layer —
    kernel, plain version, `torch.matmul` and bound — beside the launches
    one admission prefill made in the served run."""
    cases = {c["case"]: c for c in k1 if c["B"] == 512 and c["dtype"] == "bfloat16"
             and c["V"] == 32 and c["case"] in PROJ}
    line = {key: sum(cases[label][key] * reps for label, (_, _, reps) in PROJ.items())
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    line.update(B=512, variant=sorted({c["variant"] for c in cases.values()}),
                bound_by=sorted({c["bound_by"] for c in cases.values()}),
                launches_per_admission=launches)
    print(f"K1 one prefill layer (7 projections, B=512, bf16, V=32, {line['variant']}, "
          f"summed from the per-projection cases): kernel {line['ms']*1e3:8.1f} us  plain "
          f"{line['plain_ms']*1e3:8.1f} us  matmul {line['library_ms']*1e3:8.1f} us  bound "
          f"{line['bound_ms']*1e3:7.1f} us; {launches:.0f} launches per admission prefill")
    return line


# the Random123 known-answer vector of threefry2x32 (key, counter, output)
THREEFRY_KAT = ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))


def sampler_check(vocab):
    """The port's threefry PRNG and sampler on CUDA tensors against the same
    functions on CPU tensors (which the CPU tests hold integer-equal to
    jax.random): the known-answer vector, then per-slot keys and the full
    vocabulary's random bits integer-equal, then draws on full-vocab logits
    under the main flow's parameters equal."""
    from repro_torch.serve import prng, sampler

    (k1, k2), (c1, c2), want = THREEFRY_KAT
    got = prng.threefry2x32(*(torch.tensor(v, dtype=torch.int64, device="cuda")
                              for v in (k1, k2, c1, c2)))
    if tuple(int(v) for v in got) != want:
        raise AssertionError(f"threefry2x32 on CUDA: {[hex(int(v)) for v in got]} != "
                             f"{[hex(v) for v in want]}")
    seeds = torch.tensor([0, 3, 7, 2**31 + 11, 2**32 - 1, 123456789], dtype=torch.int64)
    gens = torch.tensor([0, 1, 5, 17, 2**31, 4095], dtype=torch.int64)
    keys = {d: sampler.fold_keys(prng.PRNGKey(0, d), seeds.to(d), gens.to(d))
            for d in ("cpu", "cuda")}
    keys_eq = bool(torch.equal(keys["cuda"].cpu(), keys["cpu"]))
    bits_eq = bool(torch.equal(prng.random_bits(keys["cuda"], vocab).cpu(),
                               prng.random_bits(keys["cpu"], vocab)))
    logits = torch.randn((6, vocab), generator=torch.Generator().manual_seed(5)) * 4
    temp = torch.tensor([0.8, 0.8, 0.0, 0.8, 1.2, 0.5])
    topk = torch.tensor([16, 16, 0, 0, 50, 16], dtype=torch.int32)
    topp = torch.tensor([0.0, 0.9, 0.0, 0.95, 0.0, 0.5])
    draws = {d: sampler.sample(keys[d], logits.to(d), temp.to(d), topk.to(d), topp.to(d)).cpu()
             for d in ("cpu", "cuda")}
    draws_eq = bool(torch.equal(draws["cuda"], draws["cpu"]))
    gum = float((prng.gumbel(keys["cuda"], vocab).cpu() - prng.gumbel(keys["cpu"], vocab))
                .abs().max())
    print(f"threefry2x32 known-answer vector on CUDA: ok; keys integer-equal CUDA vs CPU: "
          f"{keys_eq}; {vocab} random words per key integer-equal: {bits_eq}; draws "
          f"(T 0.8 top-k 16 and others) equal: {draws_eq} {draws['cuda'].tolist()}; Gumbel "
          f"noise max |CUDA - CPU| {gum:.2e} (log's last bit)", flush=True)
    if not (keys_eq and bits_eq and draws_eq):
        raise AssertionError("the PRNG or the sampler on CUDA differs from the CPU")
    return dict(keys_equal=keys_eq, bits_equal=bits_eq, draws_equal=draws_eq,
                gumbel_max_abs_diff=gum)


# --------------------------------------------------------------------------
# phases 4-6: the main path at full width
# --------------------------------------------------------------------------

def full_model():
    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo

    cfg = load_arch("qwen2_0_5b")
    t0 = time.perf_counter()
    model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"qwen2_0_5b: {cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab {cfg.vocab} -> "
          f"{cfg.vocab_padded}, {cfg.dtype}, HiNM {cfg.hinm}; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


# the reference's bound for gyro against noperm (tests/test_prune_model.py:84)
GYRO_MARGIN = 5e-3
# (ocp_iters, icp_iters) of the prune phase, cut from prune_model's 8/8,
# whose full-width search took up to 10.6 minutes on the H100 (PERF.md),
# then from 4/4 (295-455 s) to the other phases' 2/2 to keep the whole
# script within its time limit on a slow host; width and depth stay full
PRUNE_ITERS = (2, 2)


def nm_apply_path(model):
    """K3's path, the public entry point `ops.nm_apply`: N:M select over
    the stack of all L down projections in HiNM orientation, (L, 896,
    4864) bf16 — the mask refresh a gradual-pruning step runs.  Counts set
    to 0 just before and read just after; then held bit for bit against
    the plain version and timed."""
    from repro_torch.kernels import nm_select as nms
    from repro_torch.kernels import ops

    stack = torch.stack([blk.mlp.wd.w.T for blk in model.blocks]).contiguous()
    torch.cuda.synchronize()
    nms.nm_select.launches = 0
    ops.nm_apply(stack)
    torch.cuda.synchronize()
    launches = nms.nm_select.launches
    print(f"ops.nm_apply over {tuple(stack.shape)} {stack.dtype}: nm_select launched "
          f"{launches} time(s)")
    if launches < 1:
        raise AssertionError("ops.nm_apply did not launch nm_select on a CUDA tensor")
    line = k3_case("nm_apply", stack, 2, 4, run=lambda: ops.nm_apply(stack))
    return launches, line


def check_perms(cfg, report):
    """Every out_perm the engine returned, re-checked by the engine's own
    validator against the graph's constraints.  Returns the number
    checked."""
    from repro_torch.models import zoo
    from repro_torch.perm.engine import validate_out_perm

    containers = {c.tag: c for c in zoo.perm_graph(cfg).containers}
    for what, perm in report.out_perms.items():
        graph = containers[what.split("[", 1)[0]].graph
        validate_out_perm(graph.nodes[what.split("/", 1)[1]], graph, perm, what)

    def n_layers(c):
        # an encoder-decoder's encoder stack; a recurrent family's stack of
        # one pattern position holds one layer a period
        if c.key == "enc":
            return cfg.n_enc_layers or cfg.n_layers
        return cfg.n_layers // len(containers) if c.key.startswith("stack") else cfg.n_layers

    expected = sum(n_layers(c) * len(c.graph.nodes) for c in containers.values())
    if len(report.out_perms) != expected:
        raise AssertionError(f"{len(report.out_perms)} searched perms, expected {expected}")
    return expected


def prune_phase(cfg, model, gen):
    """Gyro-permutation pruning of the full-width model on the card
    (`prune_model` at PRUNE_ITERS), then noperm on the same weights; K1
    held on gyro-pruned (permuted vec_idx) projections."""
    from repro_torch.models.module import get_path
    from repro_torch.train import pruning

    out = {}
    for method in ("gyro", "noperm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        permuted, masks, packed, rep = pruning.prune_model(
            model, cfg, method=method, rng=np.random.default_rng(0), ocp_iters=PRUNE_ITERS[0],
            icp_iters=PRUNE_ITERS[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ph = rep.phase_seconds
        kinds = "  ".join(f"{path} {sec:.1f} s" for path, sec in rep.item_seconds.items())
        print(f"prune_model(method={method!r}, ocp_iters={PRUNE_ITERS[0]}, icp_iters="
              f"{PRUNE_ITERS[1]}): {wall:.1f} s "
              f"(search {ph['search']:.1f} s, realize {ph['realize']:.1f} s); "
              f"{rep.searches_run} searches; mean retained saliency "
              f"{rep.mean_retained:.6f}", flush=True)
        print(f"  search host seconds per projection kind, summed over "
              f"{cfg.n_layers} layers: {kinds}")
        out[method] = dict(packed=packed, masks=masks, report=rep, wall_s=wall)
        del permuted
    gyro, noperm = out["gyro"]["report"], out["noperm"]["report"]
    n = check_perms(cfg, gyro)
    print(f"gyro {gyro.mean_retained:.6f} vs noperm {noperm.mean_retained:.6f} mean "
          f"retained (gain {gyro.mean_retained - noperm.mean_retained:+.6f}); {n} "
          f"searched perms pass their constraint checks")
    if not gyro.mean_retained >= noperm.mean_retained - GYRO_MARGIN:
        raise AssertionError(f"gyro retained {gyro.mean_retained} < noperm "
                             f"{noperm.mean_retained} - {GYRO_MARGIN}")
    packed = out["gyro"]["packed"]
    k1 = []
    for label, path in (("gyro wd", "mlp/wd"), ("gyro wg", "mlp/wg")):
        p = get_path(packed.blocks[0], path).w
        vi = p.vec_idx
        if bool((vi[:, 1:] > vi[:, :-1]).all()):
            raise AssertionError(f"{label}: vec_idx is ascending, ICP permuted nothing")
        for b in (4, 512):
            k1.append(k1_case(label, p, b, gen))
    return packed, out, k1


# prompts of the serve workload that the step profile keeps live in the pool
PROFILE_LENS = (40, 64, 80, 96)


def graphed(fn):
    """`fn` through the package's graph cache (`repro_torch.serve.graphs`):
    the first call runs it eagerly and captures it, every later call
    replays the graph."""
    from repro_torch.serve import graphs

    cache = graphs.GraphCache(torch.device("cuda"))
    return lambda: cache.run(None, fn)


# draft tokens per verify in the spec runs and profiles: the main flow's
# --spec-k 3 (examples/serve_hinm.py)
SPEC_K = 3


def live_pool(cfg, model, kv, reserve):
    """The PROFILE_LENS prompts prefilled into the served `SlotKVCache`
    (each slot reserving `reserve` rows past its prompt); returns the slots
    and each one's greedy first token (B, 1)."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler

    b = len(PROFILE_LENS)
    rng = np.random.default_rng(3)
    tokens = np.zeros((b, max(PROFILE_LENS)), np.int32)
    for i, n in enumerate(PROFILE_LENS):
        tokens[i, :n] = rng.integers(0, cfg.vocab, n)
    n_rows = torch.tensor(PROFILE_LENS, dtype=torch.int32, device="cuda")
    stripe = kv.template(b)
    last = zoo.prefill(model, cfg, torch.from_numpy(tokens).cuda(), stripe, n_rows=n_rows)
    tok = sampler.greedy(zoo.logits_fn(model, cfg, last)[:, : cfg.vocab].float())[:, None]
    slots = [kv.acquire() for _ in range(b)]
    for row, (slot, n) in enumerate(zip(slots, PROFILE_LENS)):
        kv.insert(slot, stripe, n, row=row, reserve=n + reserve)
    return slots, tok


def rewind(cfg, cache, pos0):
    """Sweep every row written since `pos0` and rewind the pool there, so
    each profile runs at the same context length."""
    from repro_torch.models import zoo

    n = int((zoo.cache_position(cfg, cache) - pos0).max())
    if n > 0:
        zoo.cache_rollback(cfg, cache, None, pos0, torch.zeros_like(pos0), n)


@torch.no_grad()
def spec_bits(cfg, model, cache, tok, drops=None, restore=None):
    """The speculative verify against sequential decode on the live pool:
    four greedy `decode_step`s from the pending token (each feeding back
    its argmax), rewound, then one `verify_step` over [pending + the three
    tokens decode chose].  Row i of the verify must be decode step i: the
    max |dlogit| over the 4 x 4 x vocab logits, whether they are bit-equal,
    and the smallest top-2 margin of the decode logits (bf16 logits tie
    often).  Both run eagerly, then again as captured CUDA graphs (the
    scheduler's programs): the captured verify must be bitwise the
    captured decode steps, and a captured decode step is held against the
    eager one (max |dlogit|: what the graphed-vs-eager gate allows a
    stream to part by).  For an MoE model `drops` (a `DropCounter`, reset
    by the caller) counts the verify's capacity drops, which part a verify
    row from its decode step (the reference's semantics): with any, the
    captured verify may differ from the captured decode steps.  `restore`
    puts the pool back as it was before each run (default: `rewind` to
    its positions, a parallel verifier's sweep)."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler

    pos0 = zoo.cache_position(cfg, cache)
    if restore is None:
        def restore():
            rewind(cfg, cache, pos0)
    b, n = tok.shape[0], SPEC_K + 1
    seq = torch.zeros((b, n + 1), dtype=torch.int32, device="cuda")
    seq[:, :1] = tok
    dec = torch.zeros((b, n, cfg.vocab_padded), dtype=cfg.dtype, device="cuda")
    ver = torch.zeros_like(dec)

    def decode():
        for i in range(n):
            logits = zoo.decode_step(model, cfg, seq[:, i: i + 1], cache)
            dec[:, i].copy_(logits)
            seq[:, i + 1].copy_(sampler.greedy(logits[:, : cfg.vocab].float()))

    def verify():
        ver.copy_(zoo.verify_step(model, cfg, seq[:, :n], cache)[0])

    runs = {}
    for mode in ("eager", "graphed"):
        got = []
        for fn in (decode, verify):
            run = fn if mode == "eager" else graphed(fn)
            if mode == "graphed":
                run()                     # eager first use, then captured
                restore()
            run()
            got.append((dec if fn is decode else ver)[..., : cfg.vocab].clone())
            restore()
        runs[mode] = got + [seq.clone()]
    (dec_e, ver_e, seq_e), (dec_g, ver_g, seq_g) = runs["eager"], runs["graphed"]
    top2 = torch.topk(dec_e.float(), 2, dim=-1).values
    # the steps whose inputs agree (all four where every argmax agrees)
    same = n if torch.equal(seq_e, seq_g) else 1
    out = dict(max_abs_dlogit=float((ver_e.float() - dec_e.float()).abs().max()),
               bit_equal=bool(torch.equal(ver_e, dec_e)),
               graph_bit_equal=bool(torch.equal(ver_g, dec_g)),
               graph_max_abs_dlogit=float((ver_g.float() - dec_g.float()).abs().max()),
               graph_vs_eager_max_abs_dlogit=float(
                   (dec_g[:, :same].float() - dec_e[:, :same].float()).abs().max()),
               graph_vs_eager_bit_equal=bool(torch.equal(dec_g[:, :same], dec_e[:, :same])),
               graph_vs_eager_steps=same,
               min_top2_margin=float((top2[..., 0] - top2[..., 1]).min()),
               positions=int(dec_e.shape[0] * dec_e.shape[1]))
    print(f"spec bits: verify_step over [pending + {SPEC_K} drafts] vs {n} decode "
          f"steps on the live pool: bit-equal {out['bit_equal']}, max |dlogit| "
          f"{out['max_abs_dlogit']:.3e} over {out['positions']} positions x {cfg.vocab} "
          f"(smallest decode top-2 margin {out['min_top2_margin']:.3e}); as captured "
          f"graphs: bit-equal {out['graph_bit_equal']}, max |dlogit| "
          f"{out['graph_max_abs_dlogit']:.3e}; captured vs eager decode ({same} step(s)): "
          f"bit-equal {out['graph_vs_eager_bit_equal']}, max |dlogit| "
          f"{out['graph_vs_eager_max_abs_dlogit']:.3e}", flush=True)
    if drops is not None:
        out["verify_drops"] = drops.read()["verify"][0]
        print(f"spec bits: (token, slot)s dropped for capacity in the verify forwards "
              f"{out['verify_drops']}", flush=True)
    if not out["graph_bit_equal"] and not out.get("verify_drops"):
        raise AssertionError("the captured verify is not bitwise the captured decode steps")
    return out


def host_and_device(fn, chunk=8):
    """One call of `fn` on the host clock over two chunks of `chunk` calls
    with one sync each, as the scheduler runs them (wall includes the sync,
    host only the enqueueing), and its device time replayed as a CUDA
    graph.  Returns (wall_ms, host_ms, device_ms)."""
    walls, hosts = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        hosts.append((t1 - t0) / chunk * 1e3)
        walls.append((time.perf_counter() - t0) / chunk * 1e3)
    return float(np.mean(walls)), float(np.mean(hosts)), time_ms(graphed(fn))


@torch.no_grad()
def step_profile(cfg, model, kv):
    """Where a decode step's time goes, on a live pool (`live_pool`), each
    part rewound to the same context length before the next:
    greedy / sampled — one `decode_step` with argmax, or with every lane
                sampled at T 0.8, top-k 16 (the main flow's sampled
                requests: `sampler.sample` on per-slot keys);
    verify / verify_sampled — one speculative cycle as the fused loop runs
                it: n-gram proposal, `verify_step` over k+1 = 4 rows per
                slot, acceptance, history append and rollback (greedy, or
                every lane "match"-sampled as above);
    each with wall_ms / host_ms (`host_and_device`) and device_ms (one
    call captured as a CUDA graph and replayed); k1_ms / k2_ms — device
    time of the step's 7 x L hinm_spmm and L paged_decode_attn launches
    alone (B 4, s 1), captured on the same weights and pool, and
    verify_k1_ms / verify_k2_ms the same for the verify (B 16 on the
    verify's variant, s 4); k*_host_us — host cost of one kernel-wrapper
    call at decode shapes."""
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import zoo
    from repro_torch.serve import prng, sampler
    from repro_torch.serve import spec as spec_mod

    b, v = len(PROFILE_LENS), cfg.vocab
    slots, tok0 = live_pool(cfg, model, kv, reserve=48)
    cache = kv.cache
    pos0 = zoo.cache_position(cfg, cache)
    bits = spec_bits(cfg, model, cache, tok0)

    def dev(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device="cuda")

    key = prng.PRNGKey(0, "cuda")
    seeds = dev(list(range(b)), torch.int64)
    temp, topk = dev([0.8] * b, torch.float32), dev([16] * b, torch.int32)
    topp = dev([0.0] * b, torch.float32)
    tok, gens = tok0.clone(), dev([1] * b, torch.int32)

    def greedy_step():
        logits = zoo.decode_step(model, cfg, tok, cache)
        tok.copy_(sampler.greedy(logits[:, :v].float())[:, None])

    def sampled_step():
        logits = zoo.decode_step(model, cfg, tok, cache)
        keys = sampler.fold_keys(key, seeds, gens)
        tok.copy_(sampler.sample(keys, logits[:, :v].float(), temp, topk, topp)[:, None])
        gens.add_(1)

    # the n-gram corpus: each slot's prompt tail and its pending token
    hist = torch.zeros((b, kv.max_seq), dtype=torch.int32, device="cuda")
    hlen = dev([8] * b, torch.int32)
    rem, keff = dev([1 << 20] * b, torch.int32), dev([SPEC_K] * b, torch.int32)
    active, match = dev([True] * b, torch.bool), dev([True] * b, torch.bool)
    eos = dev([-1] * b, torch.int32)

    def cycle(sampled):
        drafts = spec_mod.ngram_propose(hist, hlen, tok, SPEC_K)
        p0 = zoo.cache_position(cfg, cache)
        logits, undo = zoo.verify_step(model, cfg, torch.cat([tok, drafts], dim=1), cache)
        emits, cnt, _, tok2, _, _, gens2 = spec_mod.acceptance(
            logits[..., :v].float(), drafts, tok, base_key=key, seeds=seeds, gens=gens,
            temp=temp if sampled else torch.zeros_like(temp), topk=topk, topp=topp, eos=eos,
            rem=rem, active=active, k_eff=keff, match=match, stochastic=sampled,
            any_reject=False)
        h2, l2 = spec_mod.append_history(hist, hlen, emits, cnt)
        zoo.cache_rollback(cfg, cache, undo, p0, cnt, SPEC_K + 1)
        tok.copy_(tok2)
        gens.copy_(gens2)
        hist.copy_(h2)
        hlen.copy_(torch.clamp(l2, max=kv.max_seq - SPEC_K - 1))

    out = {"spec_bits": bits}
    for name, fn in (("greedy", greedy_step), ("sampled", sampled_step),
                     ("verify", lambda: cycle(False)), ("verify_sampled", lambda: cycle(True))):
        tok.copy_(tok0)
        gens.fill_(1)
        hist.zero_()
        hist[:, :8] = tok0
        # a cycle writes up to k+1 rows: fewer of them keep a part's rows
        # inside the 48 each slot reserves
        wall, host, device = host_and_device(fn, chunk=4 if name.startswith("verify") else 8)
        out[name] = {"wall_ms": wall, "host_ms": host, "device_ms": device}
        rewind(cfg, cache, pos0)

    blk0 = model.blocks[0]

    def k1_launches(rows, variant=None):
        x_d = torch.zeros((rows, blk0.attn.wq.w.n_in), dtype=cfg.dtype, device="cuda")
        x_f = torch.zeros((rows, blk0.mlp.wd.w.n_in), dtype=cfg.dtype, device="cuda")

        def run():
            for blk in model.blocks:
                a, m = blk.attn, blk.mlp
                for lin in (a.wq, a.wk, a.wv, a.wo, m.wg, m.wu):
                    hs.hinm_spmm(x_d, lin.w, variant)
                hs.hinm_spmm(x_f, m.wd.w, variant)
        return run

    def k2_launches(s):
        q = torch.zeros((b, s, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda")
        qpos = (cache["pos"][0][:, None]
                + torch.arange(s, dtype=torch.int32, device="cuda")[None, :]).contiguous()

        def run():
            for i in range(cfg.n_layers):
                pa.paged_decode_attn(q, cache["k"][i], cache["v"][i], cache["kpos"][i],
                                     cache["bt"][i], qpos)
        return run, q, qpos

    verify_variant = hs.variant(b, blk0.mlp.wd.w, cfg.dtype)
    out["k1_ms"] = time_ms(graphed(k1_launches(b)))
    out["verify_k1_ms"] = time_ms(graphed(k1_launches(b * (SPEC_K + 1), verify_variant)))
    k2_run, q, qpos = k2_launches(1)
    out["k2_ms"] = time_ms(graphed(k2_run))
    out["verify_k2_ms"] = time_ms(graphed(k2_launches(SPEC_K + 1)[0]))
    out["verify_k1_variant"] = verify_variant

    def host_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return res

    x_d = torch.zeros((b, blk0.attn.wq.w.n_in), dtype=cfg.dtype, device="cuda")
    out["k1_host_us"] = host_us(lambda: hs.hinm_spmm(x_d, blk0.mlp.wg.w))
    out["k2_host_us"] = host_us(lambda: pa.paged_decode_attn(
        q, cache["k"][0], cache["v"][0], cache["kpos"][0], cache["bt"][0], qpos))
    # the greedy step's fields where earlier runs kept them
    out.update({k: out["greedy"][k] for k in ("wall_ms", "host_ms", "device_ms")})
    for slot in slots:
        kv.release(slot)
    return out


def serve_phase(cfg, model):
    from repro_torch.serve import Request, SamplingParams, Scheduler

    t0 = time.perf_counter()
    # `model` arrives gyro-pruned and packed by the prune phase
    sched = Scheduler(cfg, model, max_slots=4, max_seq=256, page=16, decode_chunk=8)
    torch.cuda.synchronize()
    print(f"Scheduler built in {time.perf_counter() - t0:.1f} s on the gyro-pruned, "
          f"packed model (async admission {sched.async_admission})")
    pb, db = sched.stats.packed_param_bytes, sched.stats.dense_param_bytes
    print(f"weights: {pb / 1e6:.1f} MB packed vs {db / 1e6:.1f} MB dense-equivalent; "
          f"KV pool {sched.kv.pool_bytes() / 1e6:.1f} MB ({sched.kv.n_pages} pages)")
    rng = np.random.default_rng(0)
    # warm-up request (CUDA context, cuBLAS handle, kernel module loads)
    sched.run([Request(rid=99, prompt=rng.integers(0, cfg.vocab, 16).astype(np.int32),
                       params=SamplingParams(max_new_tokens=4))])
    lens = [16, 24, 40, 64, 96, 128, 33, 80]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=32), arrival=i)
                for i, p in enumerate(prompts)]

    runs = serve_run("greedy", sched, requests)
    reqs, line = runs["graphed"]
    for r in reqs:
        print(f"req {r.rid}: prompt {len(r.prompt):4d} -> {r.n_generated:3d} tokens "
              f"({r.finish_reason})  TTFT {r.ttft * 1e3:8.1f} ms  "
              f"{r.tokens_per_second:7.1f} tok/s")
    steps, k1_n, k2_n = line["decode_steps"], line["hinm_spmm"], line["paged_decode_attn"]
    print(f"launches (graphed run, counted through replays): hinm_spmm {k1_n} "
          f"({k1_n / max(steps, 1):.1f}/decode step), paged_decode_attn {k2_n} "
          f"({k2_n / max(steps, 1):.1f}/decode step)")
    per_step_k1 = 7 * cfg.n_layers
    if steps == 0 or k1_n < per_step_k1 * steps or k2_n < cfg.n_layers * steps:
        raise AssertionError(f"the main path skipped a kernel: {k1_n} hinm_spmm and "
                             f"{k2_n} paged_decode_attn launches for {steps} steps")
    n_groups = len(set(admission_groups(reqs).values()))
    prefill_k1 = (k1_n - per_step_k1 * steps) / n_groups
    print(f"hinm_spmm launches per admission prefill: {prefill_k1:.1f} ({n_groups} groups)")
    if prefill_k1 != per_step_k1:
        raise AssertionError(f"{prefill_k1} hinm_spmm launches per prefill, expected "
                             f"{per_step_k1}")
    # the served runs left their prompts' pages in the prefix index
    sched.clear_prefix_cache()
    prof = step_profile(cfg, model, sched.kv)
    dev, w = prof["device_ms"], prof["wall_ms"]
    print(f"step profile, live pool of {len(PROFILE_LENS)} slots (prompts "
          f"{'/'.join(map(str, PROFILE_LENS))}, decoding), eager: wall {w:.2f} ms per step "
          f"(host enqueue {prof['host_ms']:.2f} ms); device {dev:.3f} ms (one step "
          f"replayed as a CUDA graph) -> device idle {1 - dev / w:.1%} of the wall step; "
          f"of the device step: hinm_spmm x{per_step_k1} {prof['k1_ms']:.3f} ms "
          f"({prof['k1_ms'] / dev:.1%}), paged_decode_attn x{cfg.n_layers} "
          f"{prof['k2_ms']:.3f} ms ({prof['k2_ms'] / dev:.1%}), rest "
          f"{dev - prof['k1_ms'] - prof['k2_ms']:.3f} ms; wrapper host cost per "
          f"launch: hinm_spmm {prof['k1_host_us']:.1f} us, paged_decode_attn "
          f"{prof['k2_host_us']:.1f} us")
    for name, what in (("sampled", "decode step, every lane sampled (T 0.8, top-k 16)"),
                       ("verify", f"spec cycle (propose, verify k+1={SPEC_K + 1}, accept, "
                                  "rollback), greedy"),
                       ("verify_sampled", "spec cycle, every lane match-sampled")):
        q = prof[name]
        print(f"step profile, {what}, eager: wall {q['wall_ms']:.2f} ms (host enqueue "
              f"{q['host_ms']:.2f} ms); device {q['device_ms']:.3f} ms (greedy decode step "
              f"{dev:.3f} ms) -> device idle {1 - q['device_ms'] / q['wall_ms']:.1%}")
    vd = prof["verify"]["device_ms"]
    print(f"verify forward's kernels: hinm_spmm x{per_step_k1} at B {4 * (SPEC_K + 1)} "
          f"({prof['verify_k1_variant']}) {prof['verify_k1_ms']:.3f} ms ({prof['verify_k1_ms'] / vd:.1%} "
          f"of the greedy cycle's device time), paged_decode_attn x{cfg.n_layers} at s "
          f"{SPEC_K + 1} {prof['verify_k2_ms']:.3f} ms ({prof['verify_k2_ms'] / vd:.1%})")
    twins = twins_gate("greedy", cfg, model, sched, prompts, runs, prof["spec_bits"])
    before_after("greedy", runs)
    mixed = mixed_phase(cfg, model, sched, prof)
    shared = share_phase(cfg, model, sched, prof["spec_bits"], mixed["prefill_width_noise"])
    return {"hinm_spmm": k1_n, "paged_decode_attn": k2_n, "sched": sched,
            "greedy_requests": requests, "greedy_prompts": prompts, "greedy_reqs": reqs,
            "decode_tok_s": line["decode_tok_s"], "served_p50_step_ms": line["p50_step_ms"],
            "profile": prof, "wall_s": line["wall_s"], "prefill_k1_per_admission": prefill_k1,
            "runs": {mode: ln for mode, (_, ln) in runs.items()}, "twins": twins,
            "mixed": mixed, "shared": shared}


# examples/serve_hinm.py's workload (build_workload at its defaults: 10
# requests, 32-token prompts, one arriving per scheduler step)
MIXED_REQUESTS, MIXED_PROMPT = 10, 32


def mixed_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, MIXED_PROMPT).astype(np.int32)
            for _ in range(MIXED_REQUESTS)]


def mixed_requests(prompts):
    """The main flow's mix: every fourth request sampled at temperature 0.8
    and top-k 16, the rest greedy; 24 new tokens for every third request,
    8 for the others; seed = rid."""
    from repro_torch.serve import Request, SamplingParams

    return [Request(rid=i, prompt=p, arrival=i, params=SamplingParams(
        max_new_tokens=24 if i % 3 == 0 else 8, temperature=0.8 if i % 4 == 3 else 0.0,
        top_k=16 if i % 4 == 3 else 0, seed=i)) for i, p in enumerate(prompts)]


def admission_groups(reqs) -> dict:
    """rid -> the rids prefilled with it, in queue order (a group's members
    share one admit_time)."""
    by_time: dict = {}
    for r in sorted(reqs, key=lambda r: (r.arrival, r.rid)):
        by_time.setdefault(r.admit_time, []).append(r.rid)
    return {rid: tuple(g) for g in by_time.values() for rid in g}


class DeviceClock:
    """CUDA events around every replay the scheduler's graph cache makes
    (`timed`): the summed device time of the decode programs' replays (the
    chunk, the fused spec loop, the unfused proposal and verify) and, apart,
    of the extension programs'.  A replay is one host call, so its events
    bracket device work only; the unfused chain's eager rollbacks and the
    group prefills are not counted.  Every key run, replayed or not, is
    kept in ``keys``."""

    def __init__(self, sched, timed=True):
        self.pairs = {"decode": [], "extend": []}
        self.keys = []
        cache, run = sched.graphs, sched.graphs.run

        def timed_run(key, body):
            self.keys.append(key)
            if not timed or key[0] == "prefill":
                return run(key, body)
            n = cache.replays
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run(key, body)
            end.record()
            if cache.replays > n:
                self.pairs["extend" if key[0] == "extend" else "decode"].append((start, end))
        cache.run = timed_run
        self._restore = lambda: delattr(cache, "run")

    def stop(self) -> dict:
        """Stop timing; the summed device ms of the decode and of the
        extension replays, and the number of extension replays."""
        self._restore()
        torch.cuda.synchronize()
        ms = {k: float(sum(s.elapsed_time(e) for s, e in v)) for k, v in self.pairs.items()}
        return dict(ms, extend_replays=len(self.pairs["extend"]))


def drive(sched, reqs):
    """`Scheduler.run`'s loop, sampling the pool after every step: the
    live page-steps (pages live slots map, summed over steps; what
    serve_bench's replay integrates), the held page-steps (those plus the
    pages pending admission groups have reserved), the most prefill rows
    one step computed, and the refcount conservation law, asserted."""
    kv = sched.kv
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    t = live = held = most = 0
    while pending or sched.n_pending:
        while pending and pending[0].arrival <= t:
            sched.submit(pending.pop(0))
        rows = sched.stats.prefill_rows
        sched.step()
        t += 1
        most = max(most, sched.stats.prefill_rows - rows)
        live += kv.n_live_pages
        held += kv.n_live_pages + sched._pending_pages
        if kv.paged and kv.n_free_pages + kv.n_referenced_pages != kv.n_alloc_pages:
            raise AssertionError(f"step {t}: {kv.n_free_pages} free + {kv.n_referenced_pages} "
                                 f"referenced pages != {kv.n_alloc_pages}")
    return dict(live_page_steps=live, held_page_steps=held, max_prefill_rows_step=most,
                steps=t)


def serve_run(label, sched, make_requests, eager=True):
    """Serve `make_requests()` on `sched` three times, reset before each: a
    warm-up run, whose first use of each program runs it eagerly and
    captures it; the graphed run, which replays them; and, with `eager`,
    its eager twin under `graphs._eager()`.  Launch counts are set to 0 just before each
    measured run and read just after.  Each run goes through `drive`
    (page-steps, the busiest step's prefill rows, refcount conservation).
    Checks every request ran to its budget.  The graphed run's decode and
    extension programs are timed on the device (`DeviceClock`); the eager
    twin runs the same device work, so both runs' idle share is 1 - that
    decode device time per decode step / the run's wall time per decode
    step.  Returns {"graphed" [| "eager"]: (requests, line)}."""
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.serve import graphs

    g = sched.graphs
    sched.reset()
    drive(sched, make_requests())
    warm = g.captures
    runs = {}
    # the graphed run's; its eager twin does the same device work
    device_ms = extend_ms = extend_n = None
    for mode in ("graphed", "eager") if eager else ("graphed",):
        sched.reset()
        reqs = make_requests()
        c0, r0 = g.captures, g.replays
        o0 = sched.telemetry.registry.value("serve_overlap_admissions")
        torch.cuda.synchronize()
        hs.hinm_spmm.launches = 0
        pa.paged_decode_attn.launches = 0
        clock = DeviceClock(sched, timed=mode == "graphed")
        t0 = time.perf_counter()
        with graphs._eager() if mode == "eager" else contextlib.nullcontext():
            pool = drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = clock.stop()
        if mode == "graphed":
            device_ms, extend_ms, extend_n = ms["decode"], ms["extend"], ms["extend_replays"]
        k1_n, k2_n = hs.hinm_spmm.launches, pa.paged_decode_attn.launches
        st = sched.stats
        for r in reqs:
            if not (r.n_generated == r.params.max_new_tokens
                    or (r.finish_reason == "eos" and r.tokens[-1] == sched.cfg.eos_id)):
                raise AssertionError(f"{label} ({mode}) request {r.rid}: {r.n_generated} "
                                     f"tokens, finish {r.finish_reason}")
        line = dict(wall_s=wall, decode_tok_s=st.decode_tokens_per_second,
                    p50_step_ms=st.step_time_percentile(50) * 1e3,
                    p50_ttft_ms=st.ttft_percentile(50) * 1e3, decode_steps=st.decode_steps,
                    decode_tokens=st.decode_tokens, verify_steps=st.verify_steps,
                    acceptance_rate=st.acceptance_rate,
                    tokens_per_verify_step=st.tokens_per_verify_step,
                    hinm_spmm=k1_n, paged_decode_attn=k2_n,
                    rollback_sweeps=sched.kv.rollback_sweeps,
                    overlapped_groups=sched.telemetry.registry.value(
                        "serve_overlap_admissions") - o0,
                    graphs_captured_warmup=warm, graphs_captured=g.captures - c0,
                    graph_replays=g.replays - r0,
                    mean_step_ms=st.decode_seconds / st.decode_steps * 1e3,
                    device_step_ms=device_ms / st.decode_steps,
                    prefill_rows=st.prefill_rows, prefix_hit_tokens=st.prefix_hit_tokens,
                    prefix_hit_rate=st.prefix_hit_rate, prefill_chunks=st.prefill_chunks,
                    cow_copies=getattr(sched.kv, "cow_copies", 0),
                    extend_widths=sorted({k[1] for k in clock.keys if k[0] == "extend"}),
                    extend_device_ms=extend_ms, extend_replays=extend_n, **pool)
        line["idle_share"] = 1 - line["device_step_ms"] / line["mean_step_ms"]
        print(f"{label:19s} {mode:7s}: {len(reqs)} requests in {wall:.2f} s, "
              f"{st.decode_tokens} decode tokens, {st.decode_steps} decode steps "
              f"({st.verify_steps} verify forwards), {line['decode_tok_s']:.1f} decode tok/s, "
              f"p50 step {line['p50_step_ms']:.2f} ms, p50 TTFT {line['p50_ttft_ms']:.1f} ms; "
              + (f"acceptance {st.acceptance_rate:.3f} ({st.draft_accepted}/"
                 f"{st.draft_proposed}), {st.tokens_per_verify_step:.3f} tokens per verify; "
                 if st.verify_steps else "")
              + (f"prefix hit rate {st.prefix_hit_rate:.3f} ({st.prefix_hit_tokens} rows), "
                 f"{st.prefill_chunks} extension chunks (widths {line['extend_widths']}; "
                 f"{extend_n} replays, {extend_ms:.3f} ms of device time), "
                 f"{line['cow_copies']} copy-on-write; "
                 if sched.prefix is not None else "")
              + f"prefill rows {st.prefill_rows} (most in one step {pool['max_prefill_rows_step']}), "
              f"page-steps live {pool['live_page_steps']} held {pool['held_page_steps']}; "
              f"launches hinm_spmm {k1_n}, paged_decode_attn {k2_n}; overlapped admission "
              f"groups {line['overlapped_groups']}; graphs captured {line['graphs_captured']} "
              f"(warm-up run {warm}), replays {line['graph_replays']}; mean step "
              f"{line['mean_step_ms']:.2f} ms against {line['device_step_ms']:.3f} ms of "
              f"device time (the graphed run's replays): idle {line['idle_share']:.1%}",
              flush=True)
        runs[mode] = (reqs, line)
    if runs["graphed"][1]["graph_replays"] == 0 or warm == 0:
        raise AssertionError(f"{label}: the graphed run replayed no graph")
    return runs


def before_after(label, runs):
    """The path's eager twin (before) beside its graphed run (after):
    decode tok/s, p50 step, p50 TTFT, the device idle share (`serve_run`),
    graphs captured and replays."""
    parts = []
    for mode, tag in (("eager", "before"), ("graphed", "after")):
        ln = runs[mode][1]
        parts.append(f"{tag} ({mode}) {ln['decode_tok_s']:.1f} tok/s, p50 step "
                     f"{ln['p50_step_ms']:.2f} ms, p50 TTFT {ln['p50_ttft_ms']:.1f} ms, idle "
                     f"{ln['idle_share']:.1%}")
    g = runs["graphed"][1]
    print(f"before/after {label}: " + "; ".join(parts) + f"; device {g['device_step_ms']:.3f} "
          f"ms per decode step; graphs captured {g['graphs_captured_warmup']} (in the "
          f"warm-up run), replays {g['graph_replays']}", flush=True)


def twins_gate(label, cfg, model, sched, prompts, runs, bits):
    """Graphed streams against their eager twin's, request by request:
    equal, or parted only at a near tie — the eager run's draw at the
    parting point (`parting_margin`: its admission group re-prefilled and
    decoded eagerly) must be what the eager run drew, with a top-2 margin
    within the captured decode step's max |dlogit| against the eager one
    (`spec_bits`; a parting with none is a fault)."""
    e_reqs, g_reqs = runs["eager"][0], runs["graphed"][0]
    delta = bits["graph_vs_eager_max_abs_dlogit"]
    groups = admission_groups(e_reqs)
    partings = []
    for a, b in zip(e_reqs, g_reqs):
        if a.tokens == b.tokens:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y),
                 min(len(a.tokens), len(b.tokens)))
        margin, drawn, _ = parting_margin(cfg, model, sched, prompts, a, groups[a.rid], j)
        partings.append(dict(rid=a.rid, index=j, margin=margin,
                             replay_matches=drawn == a.tokens[j],
                             near_tie=drawn == a.tokens[j] and margin <= delta and delta > 0))
    same = sum(a.tokens == b.tokens for a, b in zip(e_reqs, g_reqs))
    print(f"{label}: graphed streams equal to the eager twin's {same}/{len(e_reqs)}; "
          f"captured vs eager decode step max |dlogit| {delta:.3e}; {len(partings)} "
          f"parting point(s)" + "".join(
              f"\n  request {p['rid']} at token {p['index']}: eager top-2 margin "
              f"{p['margin']:.3e}, replay draws the eager token {p['replay_matches']}, near "
              f"tie {p['near_tie']}" for p in partings), flush=True)
    bad = [p for p in partings if not p["near_tie"]]
    if bad:
        raise AssertionError(f"{label}: graphed streams part from the eager ones beyond the "
                             f"near-tie rule: {bad}")
    return {"identical": same, "requests": len(e_reqs), "threshold": delta,
            "partings": partings}


@torch.no_grad()
def prefill_width_noise(cfg, model, sched, prompts, steps=24):
    """How far a request's logits move when admission prefills it in a
    group of another width (the speculative and plain runs free their slots
    at different steps, so their admission groups can differ): the first
    prompt prefilled alone, as row 0 of a group of 2 and of 4 (K1's "mma"
    variant at 32, 64 and 128 rows), then `steps` paged decode steps fed the
    width-1 run's greedy tokens.  Returns the max |dlogit| against width 1."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler
    from repro_torch.serve.kv import SlotKVCache

    runs, forced = [], None
    for width in (1, 2, 4):
        kv = SlotKVCache(cfg, 4, sched.max_seq, page=16, n_pages=None, device="cuda")
        st = kv.template(width)
        n = len(prompts[0])
        toks = torch.from_numpy(np.stack(prompts[:width])).cuda()
        last = zoo.prefill(model, cfg, toks, st, n_rows=torch.full(
            (width,), n, dtype=torch.int32, device="cuda"))
        logits = [zoo.logits_fn(model, cfg, last)[:1, : cfg.vocab]]
        kv.insert(kv.acquire(), st, n, row=0, reserve=n + steps + 1)
        if forced is None:
            forced = [sampler.greedy(logits[0].float())]
        tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
        for i in range(steps):
            tok[0, 0] = forced[i][0]
            logits.append(zoo.decode_step(model, cfg, tok, kv.cache)[:1, : cfg.vocab])
            if len(forced) <= i + 1:
                forced.append(sampler.greedy(logits[-1].float()))
        runs.append(torch.cat(logits).float())
    return max(float((r - runs[0]).abs().max()) for r in runs[1:])


def regroup(cfg, model, sched, prompts, group):
    """Prefill admission group `group` (rids, indexes into `prompts`)
    exactly as `Scheduler` did: same members, bucket and padded width, so
    bitwise the same rows.  Returns the stripe and the last-token pre-logits."""
    from repro_torch.models import zoo

    rows = [prompts[r] for r in group]
    k_b = 1
    while k_b < len(rows):
        k_b *= 2
    s_b = sched._bucket_len(len(rows[0]))
    toks = np.zeros((k_b, s_b), np.int32)
    n_rows = np.zeros((k_b,), np.int32)
    for i in range(k_b):
        p = rows[min(i, len(rows) - 1)]
        toks[i, : len(p)] = p
        n_rows[i] = len(p)
    st = zoo.make_cache(cfg, k_b, sched.max_seq, device="cuda")
    last = zoo.prefill(model, cfg, torch.from_numpy(toks).cuda(), st,
                       n_rows=torch.from_numpy(n_rows).cuda())
    return st, last


@torch.no_grad()
def parting_margin(cfg, model, sched, prompts, req, group, j, other=None):
    """The top-2 margin, in logits, of the plain run's draw of token j of
    `req`: its admission group re-prefilled exactly as `Scheduler` did
    (same members, bucket and padded width, so bitwise the same rows), its
    row inserted into a 4-slot pool of the served geometry, then decode
    steps fed its own tokens up to j.  A sampled request's margin is taken
    on its Gumbel-perturbed, top-k-masked scores (its key at index j),
    scaled back by T.  A sampled draw also flips where a logit crosses the
    top-k cut, which the top-2 margin does not see; with `other` (the token
    the other run drew there): outside the plain run's top k, its logit
    must cross the cut and its perturbed score then beat the draw's, so the
    margin is the larger of those two gaps; the runner-up, the draw itself
    may fall below the cut, so the margin is the smaller of the top-2
    margin and the draw's logit above the (k+1)-th.  Returns (margin, the
    token the replay draws, `other`'s rank in the plain run's logits or
    None)."""
    from repro_torch.models import zoo
    from repro_torch.serve import prng, sampler
    from repro_torch.serve.kv import SlotKVCache

    st, last = regroup(cfg, model, sched, prompts, group)
    kv = SlotKVCache(cfg, 4, sched.max_seq, page=16, n_pages=None, device="cuda")
    row = group.index(req.rid)
    logits = zoo.logits_fn(model, cfg, last)[row: row + 1, : cfg.vocab].float()
    kv.insert(kv.acquire(), st, len(req.prompt), row=row, reserve=len(req.prompt) + j + 1)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    for t in range(j):
        tok[0, 0] = req.tokens[t]
        logits = zoo.decode_step(model, cfg, tok, kv.cache)[:1, : cfg.vocab].float()
    p = req.params
    scores = logits
    if p.temperature > 0:
        key = sampler.fold_keys(prng.PRNGKey(0, "cuda"),
                                torch.tensor([p.seed], device="cuda"),
                                torch.tensor([j], device="cuda"))
        masked = sampler.mask_logits(logits / p.temperature,
                                     torch.tensor([p.top_k], device="cuda"),
                                     torch.tensor([p.top_p], device="cuda"))
        scores = (masked + prng.gumbel(key, cfg.vocab)) * p.temperature
    top2 = torch.topk(scores[0], 2)
    # the draw as the sampler makes it: argmax takes the first of tied
    # maxima, where topk's order among ties is unspecified
    margin, drawn = float(top2.values[0] - top2.values[1]), int(scores[0].argmax())
    rank = None
    if other is not None:
        lg = logits[0]
        rank = int((lg > lg[other]).sum())
        if p.temperature > 0 and p.top_k > 0:
            edge = torch.topk(lg, p.top_k + 1).values      # the k-th and (k+1)-th logits
            if rank >= p.top_k:
                lifted = float((lg[other] / p.temperature + prng.gumbel(key, cfg.vocab)[0, other])
                               * p.temperature)
                margin = max(float(edge[-2] - lg[other]), float(top2.values[0]) - lifted)
            elif other == int(top2.indices[1]):
                margin = min(margin, float(lg[drawn] - edge[-1]))
    return margin, drawn, rank


def spec_vs_plain(label, cfg, model, plain_sched, prompts, plain, spec, delta_fn,
                  prefix=False, verify_parts=False):
    """Spec streams against the plain run's, request by request: equal, or
    parted only where the admission group differed (the one source of
    other bits; with `verify_parts`, also wherever a verify row parts from
    its decode step: an MoE verify's capacity drops) at a near tie
    (`parting_margin`).  Both runs have the same
    budgets, so streams of other lengths that agree as far as the shorter
    goes are a fault (one run missed a stop), unless `prefix`: the spec run
    was asked for more tokens, and its stream's first len(plain) tokens are
    what is compared."""
    groups0 = admission_groups(plain)
    groups = admission_groups(spec)
    partings = []
    for a, b in zip(plain, spec):
        toks = b.tokens[: len(a.tokens)] if prefix else b.tokens
        if a.tokens == toks:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, toks)) if x != y), None)
        if j is None:
            raise AssertionError(f"{label}: request {a.rid} emitted {len(toks)} tokens "
                                 f"against the plain run's {len(a.tokens)}, equal as far as "
                                 "the shorter goes: one run missed a stop")
        margin, drawn, _ = parting_margin(cfg, model, plain_sched, prompts, a, groups0[a.rid], j)
        delta = delta_fn()
        partings.append(dict(rid=a.rid, index=j, margin=margin, threshold=delta,
                             group_plain=groups0[a.rid], group_spec=groups[a.rid],
                             replay_matches=drawn == a.tokens[j],
                             near_tie=((groups[a.rid] != groups0[a.rid] or verify_parts)
                                       and drawn == a.tokens[j] and margin <= delta)))
    same = sum(a.tokens == (b.tokens[: len(a.tokens)] if prefix else b.tokens)
               for a, b in zip(plain, spec))
    print(f"{label}: streams equal to the plain run's {same}/{len(plain)}; {len(partings)} "
          f"parting(s)" + "".join(
              f"\n  request {p['rid']} at token {p['index']}: plain-run top-2 margin "
              f"{p['margin']:.3e} (threshold {p['threshold']:.3e}), group {p['group_plain']} -> "
              f"{p['group_spec']}, replay draws the plain token {p['replay_matches']}, near tie "
              f"{p['near_tie']}" for p in partings), flush=True)
    if any(not p["near_tie"] for p in partings):
        raise AssertionError(f"{label}: streams part from plain beyond the near-tie rule")
    return dict(identical=same, requests=len(plain), partings=partings)


def mixed_phase(cfg, model, sched, prof):
    """The main flow's own workload on the gyro-pruned packed model, each
    path served from graphs and as an eager twin (`serve_run`, held by
    `twins_gate`): without speculation (`sched`, reset), then with
    SpecConfig(k=3) fused and unfused.  Launches of both kernels are
    asserted per verify forward.  The three graphed runs' streams must be
    identical.  Where one parts, the request's admission group must differ
    between the runs (else a fault), and the parting draw must be a near
    tie: its top-2 margin in the plain run (`parting_margin`, exact) within
    the measured max |dlogit| of the paths that differ (the verify against
    decode, `spec_bits`; prefill widths, `prefill_width_noise`)."""
    from repro_torch.serve import Scheduler, SpecConfig

    bits = prof["spec_bits"]
    prompts = mixed_prompts(cfg.vocab)
    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    runs = {"plain": serve_run("mixed plain", sched, lambda: mixed_requests(prompts))}
    for label, fused in (("spec fused", True), ("spec unfused", False)):
        spec_sched = Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K, fused=fused), **geom)
        runs[label] = serve_run(f"mixed {label}", spec_sched, lambda: mixed_requests(prompts))
        line = runs[label]["graphed"][1]
        per_k1, per_k2 = 7 * cfg.n_layers, cfg.n_layers
        v = line["verify_steps"]
        if (v == 0 or line["hinm_spmm"] < per_k1 * v or line["paged_decode_attn"] < per_k2 * v
                or line["rollback_sweeps"] != v):
            raise AssertionError(f"{label}: {line['hinm_spmm']} hinm_spmm and "
                                 f"{line['paged_decode_attn']} paged_decode_attn launches, "
                                 f"{line['rollback_sweeps']} rollbacks for {v} verify forwards")
    twins = {label: twins_gate(f"mixed {label}", cfg, model, sched, prompts, r, bits)
             for label, r in runs.items()}
    for label, r in runs.items():
        before_after(f"mixed {label}", r)
    plain = runs["plain"]["graphed"][0]
    noise = prefill_width_noise(cfg, model, sched, prompts)
    delta = max(bits["max_abs_dlogit"], noise)
    print(f"near-tie threshold {delta:.3e} (verify vs decode {bits['max_abs_dlogit']:.3e}, "
          f"prefill width {noise:.3e})", flush=True)
    streams = {label: spec_vs_plain(f"mixed {label}", cfg, model, sched, prompts, plain,
                                    runs[label]["graphed"][0], lambda: delta)
               for label in ("spec fused", "spec unfused")}
    same = {label: v["identical"] for label, v in streams.items()}
    partings = [dict(p, run=label) for label, v in streams.items() for p in v["partings"]]
    return {"runs": {k: {mode: ln for mode, (_, ln) in v.items()} for k, v in runs.items()},
            "tokens": {k: [r.tokens for r in v["graphed"][0]] for k, v in runs.items()},
            "identical": same, "near_tie_threshold": delta, "prefill_width_noise": noise,
            "partings": partings, "twins": twins}


# the share phase's workload: 12 requests, one arriving per step, 24 new
# tokens each, every fourth sampled as in the mix; nine open with one
# 72-token system prompt (4 full pages and 8 rows of a fifth) and a private
# tail of 12-40 tokens, three (rids 2, 6 and 10, after the first two
# sharers have registered their pages) with only its first 32 tokens and a
# private tail of 140-180
SHARE_REQUESTS, SHARE_SYSTEM, SHARE_HEAD, SHARE_LONG = 12, 72, 32, (2, 6, 10)
SHARE_CHUNK = 64


def share_prompts(vocab):
    rng = np.random.default_rng(4)
    system = rng.integers(0, vocab, SHARE_SYSTEM).astype(np.int32)
    out = []
    for i in range(SHARE_REQUESTS):
        if i in SHARE_LONG:
            head, n_tail = system[:SHARE_HEAD], int(rng.integers(140, 181))
        else:
            head, n_tail = system, int(rng.integers(12, 41))
        out.append(np.concatenate([head, rng.integers(0, vocab, n_tail).astype(np.int32)]))
    return out


def share_requests(prompts):
    from repro_torch.serve import Request, SamplingParams

    return [Request(rid=i, prompt=p, arrival=i, params=SamplingParams(
        max_new_tokens=24, temperature=0.8 if i % 4 == 3 else 0.0,
        top_k=16 if i % 4 == 3 else 0, seed=i)) for i, p in enumerate(prompts)]


@torch.no_grad()
def extension_noise(cfg, model, sched, prompts, steps=24):
    """How far a request's logits move when admission serves it through the
    extension path instead of a group prefill of its own: rid 1 (4 pages
    mapped from rid 0's, an 8-row copy-on-write tail, its suffix in one
    extension) and rid 2 (2 pages mapped, its 141-row suffix in one
    extension, then in chunks of SHARE_CHUNK), each extension written from
    its lane in a 4-lane batch as the scheduler runs it; the first token's
    logits and `steps` paged decode steps fed the group path's greedy
    tokens.  Returns the max |dlogit| against the group path."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler
    from repro_torch.serve.kv import SlotKVCache

    vocab, page = cfg.vocab, 16

    def group(prompt, reserve):
        kv = SlotKVCache(cfg, 4, sched.max_seq, page=page, n_pages=None, device="cuda")
        n, s_b = len(prompt), sched._bucket_len(len(prompt))
        toks = torch.zeros((1, s_b), dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.from_numpy(prompt).cuda()
        st = kv.template(1)
        last = zoo.prefill(model, cfg, toks, st,
                           n_rows=torch.tensor([n], dtype=torch.int32, device="cuda"))
        slot = kv.acquire()
        kv.insert(slot, st, n, row=0, reserve=reserve)
        return kv, slot, zoo.logits_fn(model, cfg, last)[:, :vocab]

    def extended(prompt, n_shared, cow_rows, chunk):
        kv, donor, _ = group(prompts[0], len(prompts[0]) + 1)
        n = len(prompt)
        pages = kv.slot_pages(donor)
        slot = kv.acquire()
        kv.map_slot(slot, pages[:n_shared], n_shared * page, n + steps + 1,
                    cow_src=pages[n_shared] if cow_rows else None, cow_rows=cow_rows)
        cur = n_shared * page + cow_rows
        while cur < n:
            w = min(n - cur, chunk)
            w_b = sched._bucket_len(w)
            toks = torch.zeros((4, w_b), dtype=torch.int32, device="cuda")
            toks[slot, :w] = torch.from_numpy(prompt[cur:cur + w]).cuda()
            keep = torch.zeros((4,), dtype=torch.int32, device="cuda")
            keep[slot] = w
            pos0 = zoo.cache_position(cfg, kv.cache)
            x, undo = zoo.extend_step(model, cfg, toks, kv.cache)
            zoo.cache_rollback(cfg, kv.cache, undo, pos0, keep, w_b)
            cur += w
        return kv, slot, zoo.logits_fn(model, cfg, x[slot, w - 1][None])[:, :vocab]

    def decode(kv, slot, first, forced):
        logits = [first]
        tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
        for i in range(steps):
            tok[slot, 0] = forced[i]
            logits.append(zoo.decode_step(model, cfg, tok, kv.cache)[slot: slot + 1, :vocab])
        return torch.cat(logits).float()

    worst = 0.0
    for rid, n_shared, cow_rows, chunks in ((1, 4, 8, (sched.max_seq,)),
                                            (2, 2, 0, (sched.max_seq, SHARE_CHUNK))):
        prompt = prompts[rid]
        kv, slot, first = group(prompt, len(prompt) + steps + 1)
        forced, logits = [], first
        for _ in range(steps):        # the group path's own greedy tokens
            forced.append(sampler.greedy(logits[-1:].float()))
            tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
            tok[slot, 0] = forced[-1][0]
            logits = zoo.decode_step(model, cfg, tok, kv.cache)[slot: slot + 1, :vocab]
        base = decode(*group(prompt, len(prompt) + steps + 1), forced)
        for chunk in chunks:
            got = decode(*extended(prompt, n_shared, cow_rows, chunk), forced)
            worst = max(worst, float((got - base).abs().max()))
    return worst


def share_phase(cfg, model, sched0, bits, width_noise):
    """The share workload on the gyro-pruned packed model, through
    `Scheduler(max_slots=4, max_seq=256, page=16, decode_chunk=8)`, four
    runs, each graphed beside its eager twin (`serve_run`, `twins_gate`):
    prefix sharing off; on; on with prefill_chunk=SHARE_CHUNK; and that with
    SpecConfig(k=3, fused=False).  Asserted: K1 and K2 launched on every
    run; refcount conservation at every step and a pristine pool after
    `clear_prefix_cache()`; hits, copy-on-write and fewer prefill rows than
    sharing off on the sharing runs; fewer held page-steps on the
    unchunked sharing run (as serve_bench's replay asserts of its
    unchunked run: a chunked admission holds its pages for every step its
    chunks take, so the chunked runs hold more; live and held page-steps
    are printed for every run); the chunked run's most prefill rows in a
    step within SHARE_CHUNK x 4 slots and below the unchunked run's; an
    unchunked extension wider than 98 rows (K2 in row tiles).  Streams must equal the sharing-off run's, or
    part at a near tie: a request served another way (an extension, or
    another group) whose draw in the sharing-off run (`parting_margin`,
    exact) had a top-2 margin within the measured noise of the paths
    (`extension_noise`, the prefill widths, the verify)."""
    from repro_torch.models import paging
    from repro_torch.serve import Scheduler, SpecConfig

    prompts = share_prompts(cfg.vocab)
    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    configs = {"off": dict(prefix_share=False), "on": dict(prefix_share=True),
               "chunked": dict(prefix_share=True, prefill_chunk=SHARE_CHUNK),
               "chunked spec": dict(prefix_share=True, prefill_chunk=SHARE_CHUNK,
                                    spec=SpecConfig(k=SPEC_K, fused=False))}
    runs, scheds, twins = {}, {}, {}
    for label, kw in configs.items():
        sched = scheds[label] = Scheduler(cfg, model, **geom, **kw)
        runs[label] = serve_run(f"share {label}", sched, lambda: share_requests(prompts))
        twins[label] = twins_gate(f"share {label}", cfg, model, sched, prompts, runs[label],
                                  bits)
        kv = sched.kv
        freed = sched.clear_prefix_cache()
        pristine = bool((kv.cache["kpos"][:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all())
        print(f"share {label}: clear_prefix_cache() freed {freed} pages; {kv.n_free_pages} of "
              f"{kv.n_alloc_pages} free, every kpos row past the reserved pages the sentinel: "
              f"{pristine}", flush=True)
        if kv.n_free_pages != kv.n_alloc_pages or not pristine:
            raise AssertionError(f"share {label}: the pool is not pristine after "
                                 "clear_prefix_cache()")
        for mode, (_, ln) in runs[label].items():
            if min(ln["hinm_spmm"], ln["paged_decode_attn"]) < 1:
                raise AssertionError(f"share {label} ({mode}): a kernel was not launched")
    g = {label: r["graphed"][1] for label, r in runs.items()}
    off = g["off"]
    for label in ("on", "chunked", "chunked spec"):
        ln = g[label]
        if not (ln["prefix_hit_rate"] > 0 and ln["cow_copies"] > 0):
            raise AssertionError(f"share {label}: no prefix hit or no copy-on-write: {ln}")
        if not ln["prefill_rows"] < off["prefill_rows"]:
            raise AssertionError(f"share {label}: prefill rows {ln['prefill_rows']} not below "
                                 f"sharing off's {off['prefill_rows']}")
    if not g["on"]["held_page_steps"] < off["held_page_steps"]:
        raise AssertionError(f"share on: held page-steps {g['on']['held_page_steps']} not below "
                             f"sharing off's {off['held_page_steps']}")
    most = g["chunked"]["max_prefill_rows_step"]
    if not most <= SHARE_CHUNK * geom["max_slots"] or not most < g["on"]["max_prefill_rows_step"]:
        raise AssertionError(f"chunked prefill computed {most} rows in one step "
                             f"(unchunked {g['on']['max_prefill_rows_step']})")
    if not max(g["on"]["extend_widths"], default=0) > 98:
        raise AssertionError(f"no extension over 98 rows: widths {g['on']['extend_widths']}")
    ext = extension_noise(cfg, model, sched0, prompts)
    delta = max(bits["max_abs_dlogit"], width_noise, ext)
    base = runs["off"]["graphed"][0]
    groups0 = admission_groups(base)
    partings = []
    for label in ("on", "chunked", "chunked spec"):
        reqs = runs[label]["graphed"][0]
        groups = admission_groups(reqs)
        for a, b in zip(base, reqs):
            if a.tokens == b.tokens:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
            margin, drawn, rank = parting_margin(cfg, model, scheds["off"], prompts, a,
                                                 groups0[a.rid], j, other=b.tokens[j])
            other_path = (b.prefix_hit_tokens > 0 or b.prefill_chunks > 0
                          or groups[b.rid] != groups0[a.rid])
            partings.append(dict(run=label, rid=a.rid, index=j, margin=margin,
                                 sampled=a.params.temperature > 0, other_rank=rank,
                                 extension=b.prefill_chunks > 0, replay_matches=drawn == a.tokens[j],
                                 near_tie=other_path and drawn == a.tokens[j] and margin <= delta))
    same = {label: sum(a.tokens == b.tokens for a, b in zip(base, runs[label]["graphed"][0]))
            for label in ("on", "chunked", "chunked spec")}
    print(f"share: graphed streams equal to sharing off's: " + ", ".join(
        f"{k} {v}/{len(base)}" for k, v in same.items()) + f"; near-tie threshold {delta:.3e} "
        f"(extension path {ext:.3e}, prefill width {width_noise:.3e}, verify "
        f"{bits['max_abs_dlogit']:.3e}); {len(partings)} parting point(s)" + "".join(
            f"\n  {p['run']} request {p['rid']} at token {p['index']}: sharing-off margin "
            f"{p['margin']:.3e} (sampled {p['sampled']}; the other token's rank there "
            f"{p['other_rank']}), extension {p['extension']}, replay draws the sharing-off token "
            f"{p['replay_matches']}, near tie {p['near_tie']}" for p in partings), flush=True)
    bad = [p for p in partings if not p["near_tie"]]
    if bad:
        raise AssertionError(f"shared streams part from sharing off's beyond the near-tie rule: "
                             f"{bad}")
    for label, r in runs.items():
        before_after(f"share {label}", r)
    return {"runs": {k: {mode: ln for mode, (_, ln) in v.items()} for k, v in runs.items()},
            "tokens": {k: [r.tokens for r in v["graphed"][0]] for k, v in runs.items()},
            "identical": same, "near_tie_threshold": delta, "extension_noise": ext,
            "partings": partings, "twins": twins}


# --------------------------------------------------------------------------
# phase 6: telemetry and the flight recorder on the served model
# --------------------------------------------------------------------------

OUT = os.path.join(ROOT, "chiprun_out")
PROFILE_STEPS = 3         # scheduler steps (decode chunks) under torch.profiler


def validate_chrome_trace(doc: dict) -> None:
    """The structural checks tests/test_telemetry.py applies to the
    reference's committed trace: monotonic timestamps, every B matched by
    an E on its thread, instants scoped, only B/E/M/i events."""
    evs = doc["traceEvents"]
    if not evs:
        raise AssertionError("empty trace")
    last_ts, stacks = -1.0, {}
    for e in (e for e in evs if e["ph"] in ("B", "E")):
        if not (e["ts"] >= 0 and e["ts"] >= last_ts):
            raise AssertionError(f"timestamps not monotonic at {e}")
        last_ts = e["ts"]
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif not stacks.get(key):
            raise AssertionError(f"E without open B on {key}")
        else:
            stacks[key].pop()
    if any(stacks.values()):
        raise AssertionError("unclosed B events")
    for e in evs:
        if e["ph"] not in ("B", "E", "M", "i"):
            raise AssertionError(f"unexpected phase {e['ph']!r}")
        if e["ph"] == "i" and (e["s"] not in ("t", "p", "g") or e["ts"] < 0):
            raise AssertionError(f"bad instant {e}")
    tracks = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    if "scheduler" not in tracks or not any(t.startswith("req") for t in tracks):
        raise AssertionError(f"trace tracks {sorted(tracks)}")


def launch_counts() -> tuple[int, int]:
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa

    return hs.hinm_spmm.launches, pa.paged_decode_attn.launches


def zero_launches() -> None:
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa

    torch.cuda.synchronize()
    hs.hinm_spmm.launches = 0
    pa.paged_decode_attn.launches = 0


def chunk_launches(cfg, sched) -> dict:
    """K1 and K2 launches per decode step of each captured decode-chunk
    graph (the counts its capture recorded, divided by the chunk)."""
    return {key: tuple(n / sched.decode_chunk for n in deltas[:2])
            for key, (_, deltas) in sched.graphs._graphs.items() if key[0] == "chunk"}


def observed_workload(label, cfg, model, make_requests, want_tokens, want_line, kw):
    """One workload served with telemetry and the flight recorder on, on a
    fresh scheduler: a first run (each program's first use runs eagerly
    and is captured) whose record is dumped, then a graphed run (replays,
    launch counts from 0) whose streams and launches must equal the
    observability-off graphed run of the same workload in the serve
    phase.  The record is replayed on a fresh scheduler built the same
    way (event- and token-identical).  Returns the scheduler and a line."""
    from repro_torch.serve import Scheduler, replay

    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    sched = Scheduler(cfg, model, telemetry=True, flightrec=True, **geom, **kw)
    t0 = time.perf_counter()
    drive(sched, make_requests())
    record = os.path.join(OUT, f"observe_{label.replace(' ', '_')}.jsonl")
    sched.flight.dump(record)
    n_events = len(sched.flight)
    first_s = time.perf_counter() - t0
    sched.reset()
    reqs = make_requests()
    zero_launches()
    t0 = time.perf_counter()
    drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = launch_counts()
    same = sum(r.tokens == t for r, t in zip(reqs, want_tokens))
    per_step = chunk_launches(cfg, sched)
    print(f"observe {label}: telemetry + flight recorder on: first run {first_s:.2f} s "
          f"({n_events} events recorded -> {os.path.relpath(record, ROOT)}), graphed run "
          f"{wall:.2f} s; streams equal to the observability-off graphed run {same}/"
          f"{len(reqs)}; launches hinm_spmm {k1} / paged_decode_attn {k2} (off: "
          f"{want_line['hinm_spmm']} / {want_line['paged_decode_attn']}); per decode step "
          f"of each chunk graph {per_step}", flush=True)
    if same != len(reqs):
        raise AssertionError(f"observe {label}: observability changed the streams")
    if (k1, k2) != (want_line["hinm_spmm"], want_line["paged_decode_attn"]):
        raise AssertionError(f"observe {label}: observability changed the launches")
    if not per_step or any(v != (7 * cfg.n_layers, cfg.n_layers) for v in per_step.values()):
        raise AssertionError(f"observe {label}: launches per decode step {per_step}")
    rep = replay(record, Scheduler(cfg, model, telemetry=True, flightrec=True, **geom, **kw))
    print(f"observe {label}: replay on a fresh scheduler: {rep.render()}", flush=True)
    rep.assert_equal()
    return sched, dict(first_run_s=first_s, graphed_s=wall, events=n_events, record=record,
                       streams_equal=same, requests=len(reqs), hinm_spmm=k1,
                       paged_decode_attn=k2, per_step={str(k): v for k, v in per_step.items()},
                       replay_ok=rep.ok)


def overhead_runs(cfg, served) -> dict:
    """The serve phase's 8 greedy requests, telemetry off (the serve
    phase's scheduler), on, and on with the flight recorder, each warmed
    once, then measured in turns (off, on, on+rec, on+rec, on, off):
    decode tok/s and p50 step from the scheduler's stats."""
    from repro_torch.serve import Scheduler

    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    make = served["greedy_requests"]
    scheds = {"off": served["sched"],
              "telemetry": Scheduler(cfg, served["sched"].params, telemetry=True, **geom),
              "telemetry+recorder": Scheduler(cfg, served["sched"].params, telemetry=True,
                                              flightrec=True, **geom)}
    for sched in scheds.values():
        sched.reset()
        sched.run(make())                       # warm: every program captured
    out = {k: [] for k in scheds}
    for mode in ("off", "telemetry", "telemetry+recorder", "telemetry+recorder",
                 "telemetry", "off"):
        sched = scheds[mode]
        sched.reset()
        torch.cuda.synchronize()
        sched.run(make())
        torch.cuda.synchronize()
        st = sched.stats
        out[mode].append((st.decode_tokens_per_second, st.step_time_percentile(50) * 1e3))
    for mode, vals in out.items():
        print(f"observe overhead, 8 greedy requests, {mode}: decode tok/s "
              + ", ".join(f"{v[0]:.1f}" for v in vals) + "; p50 step ms "
              + ", ".join(f"{v[1]:.3f}" for v in vals), flush=True)
    return {mode: {"decode_tok_s": [v[0] for v in vals], "p50_step_ms": [v[1] for v in vals]}
            for mode, vals in out.items()}


# device ops by class, first match on the kernel's name: the two serving
# kernels, then what the step's "rest" is made of
OP_CLASSES = (("K1 hinm_spmm", ("spmm_rows", "spmm_mma", "transpose_pad", "sum_splits")),
              ("K2 paged_decode_attn", ("split_kernel", "combine_kernel")),
              ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass")),
              ("sort", ("Sort", "sort")), ("scan (cumsum)", ("scan",)),
              ("softmax", ("SoftMax", "softmax")), ("reduce (norm mean, argmax)", ("reduce",)),
              ("index / gather / scatter", ("index", "gather", "scatter")),
              ("copy / cast / cat", ("copy", "CatArray")),
              ("elementwise math", ("elementwise",)),
              ("memcpy / memset", ("Memcpy", "Memset", "memcpy")))


def short_name(name: str) -> str:
    """A kernel's name without namespaces and its parameter list."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at_cuda_detail::",
                 "c10::", "std::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def device_ops(prof) -> list:
    """[(self device ms, launches, name)], descending, of the device-side
    events in a profile (kernels, copies, sets), without the annotation
    ranges the profiler also puts on the device timeline."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")) or e.key.startswith("serve_"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def op_classes(rows, steps: int) -> dict:
    """Device ms and launches per step by `OP_CLASSES`."""
    out = {}
    for ms, n, name in rows:
        cls = next((c for c, keys in OP_CLASSES if any(k in name for k in keys)), "other")
        t, c = out.get(cls, (0.0, 0.0))
        out[cls] = (t + ms / steps, c + n / steps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def profile_steps(cfg, sched, sampled: bool, eager: bool) -> dict:
    """Four slots decoding (prompts PROFILE_LENS, greedy or every lane
    sampled at T 0.8 top-k 16): two steps admit them and capture the
    decode chunk, then PROFILE_STEPS steps under torch.profiler, replayed
    from the graphs or, with `eager`, as the eager twin (`graphs._eager()`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, SamplingParams, graphs

    rng = np.random.default_rng(3)
    sched.reset()
    for i, n in enumerate(PROFILE_LENS):
        sched.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                             params=SamplingParams(max_new_tokens=48,
                                                   temperature=0.8 if sampled else 0.0,
                                                   top_k=16 if sampled else 0, seed=i)))
    for _ in range(2):
        sched.step()
    if len(sched._running) != len(PROFILE_LENS):
        raise AssertionError(f"profile: {len(sched._running)} slots decoding")
    torch.cuda.synchronize()
    steps0 = sched.stats.decode_steps
    with graphs._eager() if eager else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                sched.step()
            torch.cuda.synchronize()
    steps = sched.stats.decode_steps - steps0
    rows = device_ops(prof)
    total = sum(r[0] for r in rows)
    tag = f"{'sampled' if sampled else 'greedy'}_{'eager' if eager else 'graphed'}"
    avg = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    with open(os.path.join(OUT, f"observe_profile_{tag}.txt"), "w") as f:
        f.write(avg.table(sort_by=key, row_limit=60))
    annotated = sorted({e.key for e in prof.key_averages()
                        if e.key.startswith("serve_decode_chunk")})
    return dict(steps=steps, device_ms=total, device_ms_per_step=total / max(steps, 1),
                launches_per_step=sum(r[1] for r in rows) / max(steps, 1), ops=rows,
                classes=op_classes(rows, max(steps, 1)), annotations=annotated)


def profile_phase(cfg, model) -> dict:
    """The device trace: torch.profiler over PROFILE_STEPS decode chunks,
    greedy and sampled, replayed from the captured graphs, on a scheduler
    whose telemetry annotates its phases (`record_function`).  Where the
    profiler shows a replay as one launch rather than its kernels, the
    eager twin of the same steps names them instead.  Prints the device
    time per decode step by op class and the top ops with their
    launches."""
    from repro_torch.serve import Scheduler, Telemetry

    sched = Scheduler(cfg, model, max_slots=4, max_seq=256, page=16, decode_chunk=8,
                      telemetry=Telemetry(enabled=True, annotate=True))
    out = {}
    for sampled in (False, True):
        r = profile_steps(cfg, sched, sampled, eager=False)
        source = "graphed"
        if "K1 hinm_spmm" not in r["classes"]:
            r, source = profile_steps(cfg, sched, sampled, eager=True), "eager twin"
        label = "sampled" if sampled else "greedy"
        out[label] = dict(r, source=source)
        per = max(r["steps"], 1)
        print(f"observe profile, {label} decode ({source}): {r['steps']} decode steps, "
              f"{r['device_ms_per_step']:.3f} device ms and {r['launches_per_step']:.1f} "
              f"launches per step; annotations {r['annotations']}; by class, per step:" + "".join(
                  f"\n  {ms:8.4f} ms {n:8.2f}x  {cls}" for cls, (ms, n) in r["classes"].items())
              + "\n top ops, per step:" + "".join(
                  f"\n  {ms / per:8.4f} ms {n / per:7.2f}x  {short_name(name)[:150]}"
                  for ms, n, name in r["ops"][:25]), flush=True)
    return {k: dict(v, ops=v["ops"][:40]) for k, v in out.items()}


def entry_point_runs() -> list:
    """examples/serve_hinm_torch.py on the card at its defaults, with
    --compare-dense: once recording, once replaying that record with the
    same flags.  Returns each run's (label, want, completed process, wall
    seconds) for `entry_point_check`."""
    rec = os.path.join(OUT, "serve_hinm_torch.jsonl")
    script = os.path.join(ROOT, "examples", "serve_hinm_torch.py")
    out = []
    for mode, extra, want in (("record", ["--record", rec], "identical: True"),
                              ("replay", ["--replay", rec], "replay OK")):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, script, "--compare-dense", *extra], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT, f"serve_hinm_torch_{mode}.txt"), "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
        out.append((f"observe entry point, {mode}", want, p, wall))
        if p.returncode != 0:
            break
    return out


def entry_point_check(runs, lines=8) -> dict:
    """Print each entry-point run's last `lines` lines and fail unless it
    exited 0 with its `want` line (and no `identical: False`)."""
    out = {}
    for label, want, p, wall in runs:
        tail = "\n  ".join(p.stdout.strip().splitlines()[-lines:])
        print(f"{label} (exit {p.returncode}, {wall:.1f} s):\n  {tail}", flush=True)
        if p.returncode != 0 or want not in p.stdout or "identical: False" in p.stdout:
            raise AssertionError(f"{label} failed (exit {p.returncode}): {p.stderr[-2000:]}")
        out[label] = dict(exit=p.returncode, wall_s=wall)
    return out


def entry_points_start():
    """Run the entry points' subprocesses (`entry_point_runs`, then
    `train_entry_point`) on a thread of their own, beside phase 4's
    host-bound search; phases 6 and 10 check what they did
    (`entry_point_check`).  Returns (the future, the training twin's
    checkpoint directory)."""
    import concurrent.futures
    import tempfile

    root = tempfile.mkdtemp(prefix="entry_points_")
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lambda: (entry_point_runs(), train_entry_point(root)))
    ex.shutdown(wait=False)
    print("entry points (examples/serve_hinm_torch.py record + replay, "
          "examples/train_hinm_lm_torch.py) started on a thread (phases 6 and 10 check them)",
          flush=True)
    return fut, root


def observe_phase(cfg, model, served, entry) -> dict:
    """Telemetry and the flight recorder on the served model: streams and
    launches unchanged with both on (the main flow's mix, and the share
    workload with prefill_chunk=SHARE_CHUNK), records replayed event- and
    token-identically, a replay on another decode_chunk named at `config`,
    the metrics snapshot and a valid Chrome trace under chiprun_out/, the
    overhead on the greedy requests, the device trace, and the port's
    entry point run as a subprocess."""
    from repro_torch.serve import Scheduler, replay

    os.makedirs(OUT, exist_ok=True)
    t_phase = time.perf_counter()
    mix = mixed_prompts(cfg.vocab)
    share = share_prompts(cfg.vocab)
    mixed, shared = served["mixed"], served["shared"]
    sched, mix_line = observed_workload(
        "mix", cfg, model, lambda: mixed_requests(mix), mixed["tokens"]["plain"],
        mixed["runs"]["plain"]["graphed"], {})
    _, share_line = observed_workload(
        "share chunked", cfg, model, lambda: share_requests(share),
        shared["tokens"]["chunked"], shared["runs"]["chunked"]["graphed"],
        dict(prefix_share=True, prefill_chunk=SHARE_CHUNK))
    other = Scheduler(cfg, model, max_slots=4, max_seq=256, page=16, decode_chunk=4,
                      telemetry=True, flightrec=True)
    rep = replay(mix_line["record"], other)
    first = rep.diff.first
    print(f"observe replay on decode_chunk 4: events equal {rep.events_equal}, tokens equal "
          f"{rep.tokens_equal}; first divergence: "
          f"{first.describe().splitlines()[0] if first else None} ({first.a.kind if first else None})",
          flush=True)
    if rep.events_equal or first.a.kind != "config" or first.b.kind != "config":
        raise AssertionError("the perturbed replay did not part at the config event")
    metrics = os.path.join(OUT, "observe_metrics.json")
    trace = os.path.join(OUT, "observe_trace.json")
    sched.telemetry.dump_metrics(metrics)
    sched.telemetry.dump_trace(trace)
    with open(trace) as f:
        doc = json.load(f)
    validate_chrome_trace(doc)
    snap = sched.metrics_snapshot()
    reg = sched.telemetry.registry
    counters = {m["name"] + (str(m["labels"]) if m["labels"] else ""): m["value"]
                for m in snap["metrics"] + snap["global"]["metrics"] if m["kind"] == "counter"}
    print(f"observe artifacts: {os.path.relpath(metrics, ROOT)} ({len(snap['metrics'])} "
          f"instruments), {os.path.relpath(trace, ROOT)} ({len(doc['traceEvents'])} events, "
          f"valid); decode step p50 {reg.get('serve_decode_step_seconds').percentile(50) * 1e3:.3f}"
          f" ms, host gap p50 {reg.get('serve_host_gap_seconds').percentile(50) * 1e3:.3f} ms; "
          f"counters {counters}", flush=True)
    if reg.value("serve_inflight_syncs") != 0:
        raise AssertionError("a blocking sync was issued under a chunk in flight")
    parts = {"streams, replays, artifacts": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    overhead = overhead_runs(cfg, served)
    parts["overhead"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_phase(cfg, model)
    parts["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry = entry_point_check(entry.result()[0])
    parts["entry point (waited)"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    print(f"observe phase took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()), flush=True)
    return dict(mix=mix_line, share=share_line, perturbed_first=first.a.kind,
                overhead=overhead, profile=prof, entry_point=entry, wall_s=wall, parts=parts)


@torch.no_grad()
def teacher_forced_logits(cfg, model, prompt, forced, backend):
    """Prefill `prompt`, then paged decode steps fed the `forced` tokens:
    the stacked logits (1 + steps, B, vocab) in f32."""
    from repro_torch.models import zoo
    from repro_torch.serve.kv import SlotKVCache

    b, n_prompt = prompt.shape
    kv = SlotKVCache(cfg, b, 256, page=16, n_pages=None, device="cuda")
    stripe = kv.template(b)
    last = zoo.prefill(model, cfg, prompt, stripe, backend=backend)
    logits = [zoo.logits_fn(model, cfg, last)]
    for row in range(b):
        kv.insert(kv.acquire(), stripe, n_prompt, row=row, reserve=n_prompt + len(forced))
    for tok in forced:
        logits.append(zoo.decode_step(model, cfg, tok, kv.cache, backend=backend))
    return torch.stack(logits)[..., : cfg.vocab].float()


def compare_logits(what, a, r, tol=AGREE_TOL):
    """max |a - r| relative to max |r| within `tol`: (that ratio, the
    greedy-token match, max |a - r|)."""
    rel = float((a - r).abs().max()) / float(r.abs().max())
    match = float((a.argmax(-1) == r.argmax(-1)).float().mean())
    print(f"{what}: max |dlogit| / max|logit| = {rel:.2e} (tol {tol:.0e}); "
          f"greedy-token match {match:.3f} over {a.shape[0] * a.shape[1]} positions")
    if not rel <= tol:
        raise AssertionError(f"{what}: logits disagree: {rel} > {tol}")
    return rel, match, float((a - r).abs().max())


@torch.no_grad()
def agree_phase(cfg, model):
    """The served (gyro-pruned, packed) model held twice: kernels against
    the plain versions, and against its masked-dense twin (every packed
    projection unpacked to a dense weight, plain `torch.matmul`)."""
    from repro_torch.models import zoo

    rng = np.random.default_rng(7)
    b, n_prompt, n_dec = 2, 40, 4
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, b, 1)).astype(np.int32)).cuda()
    a = teacher_forced_logits(cfg, model, prompt, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite logits on the kernel path")
    plain = compare_logits(f"kernels vs plain versions, prefill + {n_dec} paged decode "
                           "steps", a, teacher_forced_logits(cfg, model, prompt, forced,
                                                             "torch"))
    twin = zoo.unpack_params(cfg, copy.deepcopy(model))
    dense = compare_logits("kernels vs the masked-dense twin (torch.matmul)", a,
                           teacher_forced_logits(cfg, twin, prompt, forced, "auto"))
    return plain, dense


# --------------------------------------------------------------------------
# phase 8: the rest of the dense family, and the model drafter
# --------------------------------------------------------------------------

# the served target: qwen2.5-14b at its published widths and depth
BIG = "qwen2_5_14b"
# the 14B's served depth (widths full): its 48 layers are cut to 24 to pay
# for phase 9 (the MoE family), to 12 for phase 11 (the frontend
# families), then to 8 for phase 13 (the hybrid family), within
# chip_smoke's time limit
BIG_LAYERS = 8
# the other dense configs at full width: codeqwen1.5-7b and starcoder2-15b
# cut to 2 layers (depth only: their weights would not fit beside the
# rest), bert-base whole
OTHER_DENSE = (("codeqwen1_5_7b", 2), ("starcoder2_15b", 2), ("bert_base", None))
# the float32 forward of the same masked weights against the kernels: the
# kernel path rounds every projection output to bf16 over every layer, the
# f32 one nothing, so the gap is one side's bf16 rounding compounded over
# depth, relative to max|logit| (a CPU estimate at 48 layers and narrow
# widths: 1.4e-2); the same limit as the kernels against the plain versions
F32_TOL = AGREE_TOL


def gb(nbytes) -> str:
    return f"{nbytes / 1e9:.2f} GB"


def free_card() -> None:
    """Return a dropped model's memory to the card: a scheduler and its
    graph cache reference each other (`on_build`), so only the cyclic
    collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def build_packed(name, n_layers=None, seed=3):
    """`load_arch(name)` (its depth cut to `n_layers` if given), inited
    from a seeded generator on the card, then packed by `zoo.pack_params`:
    the reference's serve-time packing with no permutation (noperm).  The
    peak memory of init and pack, beside the model's packed and dense
    bytes."""
    import dataclasses

    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo
    from repro_torch.serve import param_bytes

    cfg = load_arch(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    init_peak = torch.cuda.max_memory_allocated()
    zoo.pack_params(cfg, model)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    packed, dense = param_bytes(model)
    info = dict(layers=cfg.n_layers, init_s=t1 - t0, pack_s=t2 - t1, held_before=held,
                init_peak=init_peak, peak=torch.cuda.max_memory_allocated(),
                after=torch.cuda.memory_allocated(), packed_bytes=packed, dense_bytes=dense)
    print(f"{name}: {cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} hd {cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab} -> "
          f"{cfg.vocab_padded}, {cfg.norm}/{cfg.act}; init {info['init_s']:.1f} s, pack "
          f"{info['pack_s']:.1f} s; weights {gb(packed)} packed vs {gb(dense)} dense; card "
          f"memory {gb(held)} held before, peak {gb(info['init_peak'])} after init and "
          f"{gb(info['peak'])} through pack, {gb(info['after'])} after", flush=True)
    return cfg, model, info


def layer_projections(cfg, model):
    """Layer 0's packed projections, (path, PackedHiNM) in a layer's order."""
    from repro_torch.models import module as M

    mlp = ("mlp/wg", "mlp/wu", "mlp/wd") if cfg.act == "swiglu" else ("mlp/wu", "mlp/wd")
    return [(path, M.get_path(model.blocks[0], path).w)
            for path in ("attn/wq", "attn/wk", "attn/wv", "attn/wo") + mlp]


def k1_shapes(label, cfg, model, gen, bs):
    """K1 on each distinct projection shape of the model's layer 0 (its own
    packed weights) at each (B, variant) of `bs`, held and timed
    (`k1_case`)."""
    seen, out = set(), []
    for path, p in layer_projections(cfg, model):
        if (p.n_out, p.n_in) in seen:
            continue
        seen.add((p.n_out, p.n_in))
        for b, var in bs:
            out.append(k1_case(f"{label} {path.split('/')[1]}", p, b, gen, variant=var))
    return out


def k2_shapes(label, cfg, ss, seed):
    """K2 at the model's head layout (KV, G, hd), B 4, page 16, n_bt 16,
    bf16: s 1 and 4 in the decode layout, wider s in the extension's."""
    g = cfg.n_heads // cfg.n_kv_heads
    return [k2_case(f"{label} s={s}", 4, s, 0, cfg.dtype, seed + i, hd=cfg.head_dim,
                    kvh=cfg.n_kv_heads, g=g, extend=s > SPEC_K + 1)
            for i, s in enumerate(ss)]


def f32_block(blk):
    """A float32 twin of one block: every projection's masked weights
    unpacked to dense f32 (an MoE block's expert stacks too; its router is
    f32 already), biases and norms in f32."""
    from repro_torch.core import packing
    from repro_torch.core.types import PackedHiNM
    from repro_torch.models import layers as L
    from repro_torch.models import module as M
    from repro_torch.models import moe, transformer

    def lin(m):
        w = packing.unpack_stored(m.w) if isinstance(m.w, PackedHiNM) else m.w
        return M.Linear(w.float().contiguous(), None if m.b is None else m.b.float())

    def norm(n):
        return M.Norm(n.scale.float(), None if n.bias is None else n.bias.float())

    ffn = blk.moe if hasattr(blk, "moe") else blk.mlp
    kids = {n: lin(m) for n, m in ffn.named_children()}
    return transformer.Block(
        norm(blk.ln1), L.Attention(*(lin(getattr(blk.attn, n)) for n in ("wq", "wk", "wv", "wo"))),
        norm(blk.ln2), **(dict(moe=moe.MoE(**kids)) if hasattr(blk, "moe")
                          else dict(mlp=L.MLP(**kids))))


@torch.no_grad()
def f32_logits(cfg, model, prompt, forced):
    """`teacher_forced_logits`' positions from a float32 forward of the same
    masked weights over prompt + forced tokens, one layer at a time (each
    layer's f32 twin built, run and dropped: no dense copy of the whole
    model exists), TF32 off: (1 + steps, B, vocab)."""
    from repro_torch.models import layers as L
    from repro_torch.models import module as M

    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.cat([prompt, forced[:, :, 0].T], dim=1)
    b, s = toks.shape
    x = model.embed.table[toks.long()].float()
    positions = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s)
    for blk in model.blocks:
        x = f32_block(blk)(x, positions, cfg, None, "torch")
    x = L.norm(M.Norm(model.ln_f.scale.float(), None if model.ln_f.bias is None
                      else model.ln_f.bias.float()), x, cfg)
    head = model.lm_head
    rows = x[:, prompt.shape[1] - 1:]
    logits = rows @ head.w.float() + (0 if head.b is None else head.b.float())
    return logits.transpose(0, 1)[..., : cfg.vocab]


@torch.no_grad()
def norm_rows() -> dict:
    """A norm's row bitwise whatever call holds it (what keeps a verify row
    its decode step): RMSNorm and LayerNorm at every ported d_model, bf16,
    over 64 random rows, against the same rows in calls of 1, 4 and 16 rows
    (from row 0 and from row n) and of 16 rows as (4, 4, d)."""
    from repro_torch.configs.base import PORTED_IDS, load_arch
    from repro_torch.models import module as M

    out = {}
    for d in sorted({load_arch(name).d_model for name in PORTED_IDS}):
        gen = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn((64, d), generator=gen, device="cuda").to(torch.bfloat16)
        p = M.Norm((torch.rand(d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16),
                   (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16))
        for fn in (M.rmsnorm, M.layernorm):
            full = fn(p, x)
            ok = torch.equal(fn(p, x[:16].reshape(4, 4, d)).reshape(16, d), full[:16])
            for n in (1, 4, 16):
                for at in (0, n):
                    ok = ok and torch.equal(fn(p, x[at: at + n]), full[at: at + n])
            out[f"{fn.__name__} d={d}"] = ok
    print("norm rows bitwise across calls of 1, 4, 16 and 64 rows: " + ", ".join(
        f"{k} {v}" for k, v in out.items()), flush=True)
    if not all(out.values()):
        raise AssertionError("a norm's row depends on the call that holds it")
    return out


def dense_agree(label, cfg, model, f32=False, n_prompt=40, n_dec=4):
    """Teacher-forced prefill + `n_dec` paged decode steps through the
    kernels against the plain versions (and with `f32`, against the float32
    forward of the same masked weights)."""
    rng = np.random.default_rng(11)
    b = 2
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, b, 1)).astype(np.int32)).cuda()
    a = teacher_forced_logits(cfg, model, prompt, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{label}: non-finite logits on the kernel path")
    out = {"plain": compare_logits(f"{label}: kernels vs plain versions, prefill + {n_dec} "
                                   "paged decode steps", a,
                                   teacher_forced_logits(cfg, model, prompt, forced, "torch"))}
    if f32:
        out["f32"] = compare_logits(f"{label}: kernels vs a float32 forward of the masked "
                                    "weights (layer by layer, TF32 off)", a,
                                    f32_logits(cfg, model, prompt, forced), tol=F32_TOL)
    return out


def drained(label, sched):
    """Both pools hold no slot after a run."""
    kv, d = sched.kv, sched.draft_kv
    ok = (kv.n_free == kv.n_slots and not kv.slot_len.any() and d.n_free == d.n_slots
          and not d.slot_len.any())
    print(f"{label}: pools drained {ok} (draft pool {d.n_free}/{d.n_slots} slots free)")
    if not ok:
        raise AssertionError(f"{label}: a pool did not drain")


def spec_launches(label, cfg, dcfg, line, reqs):
    """The launches of a graphed spec run, counted through replays, against
    what its programs make: per verify cycle k+1 draft steps (the draft's
    projections) and one verify (the target's), per admission group the
    target's and the draft's prefill; K2 only in the verify."""
    per_cycle = (SPEC_K + 1) * 7 * dcfg.n_layers + 7 * cfg.n_layers
    groups = len(set(admission_groups(reqs).values()))
    v = line["verify_steps"]
    want_k1 = v * per_cycle + groups * 7 * (cfg.n_layers + dcfg.n_layers)
    want_k2 = v * cfg.n_layers
    print(f"{label}: launches hinm_spmm {line['hinm_spmm']} (want {v} cycles x {per_cycle} + "
          f"{groups} groups x {7 * (cfg.n_layers + dcfg.n_layers)} = {want_k1}), "
          f"paged_decode_attn {line['paged_decode_attn']} (want {want_k2})")
    if (line["hinm_spmm"], line["paged_decode_attn"]) != (want_k1, want_k2):
        raise AssertionError(f"{label}: launches differ from the programs' count")
    return per_cycle


def big_serve(cfg, model, dcfg, draft, prompts, bits):
    """The 14B served by `Scheduler(max_slots=4, max_seq=256, page=16,
    decode_chunk=8)`: 8 greedy requests plain, then with SpecConfig(k=3)
    and the 0.5B `ModelDrafter`, fused and unfused; each graphed, the
    fused one also as its eager twin."""
    from repro_torch.serve import (ModelDrafter, Request, SamplingParams, Scheduler,
                                   SpecConfig)

    def requests():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=32), arrival=i)
                for i, p in enumerate(prompts)]

    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    plain = Scheduler(cfg, model, **geom)
    print(f"14B scheduler: KV pool {gb(plain.kv.pool_bytes())} ({plain.kv.n_pages} pages)")
    runs = {"plain": serve_run("14B plain", plain, requests, eager=False)}
    line = runs["plain"]["graphed"][1]
    groups = len(set(admission_groups(runs["plain"]["graphed"][0]).values()))
    want = (line["decode_steps"] * 7 * cfg.n_layers + groups * 7 * cfg.n_layers,
            line["decode_steps"] * cfg.n_layers)
    if (line["hinm_spmm"], line["paged_decode_attn"]) != want:
        raise AssertionError(f"14B plain: launches {line['hinm_spmm']}, "
                             f"{line['paged_decode_attn']}, want {want}")
    noise = {}

    def delta():
        if "width" not in noise:
            # the first prompt alone and as row 0 of groups of 2 and 4
            noise["width"] = prefill_width_noise(cfg, model, plain, [prompts[0]] * 4)
        return max(bits["max_abs_dlogit"], noise["width"])

    drafter = ModelDrafter(dcfg, draft)
    out = {"streams": {}}
    for label, fused in (("fused", True), ("unfused", False)):
        sched = Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K, drafter=drafter, fused=fused),
                          **geom)
        runs[label] = r = serve_run(f"14B spec {label}", sched, requests, eager=fused)
        reqs, ln = r["graphed"]
        ln["per_cycle_k1"] = spec_launches(f"14B spec {label}", cfg, dcfg, ln, reqs)
        drained(f"14B spec {label}", sched)
        print(f"14B spec {label}: acceptance {ln['acceptance_rate']:.3f}, "
              f"{ln['tokens_per_verify_step']:.3f} tokens per verify (random weights: the "
              "0.5B draft all but never predicts the 14B's argmax, so acceptance reads "
              "near 0; a trained pair is needed for the real number)")
        out["streams"][label] = spec_vs_plain(f"14B spec {label}", cfg, model, plain, prompts,
                                              runs["plain"]["graphed"][0], reqs, delta)
        if fused:
            out["twins"] = twins_gate("14B spec fused", cfg, model, plain, prompts, r, bits)
            before_after("14B spec fused", r)
        del sched
    out["runs"] = {k: {m: ln for m, (_, ln) in v.items()} for k, v in runs.items()}
    out["prefill_width_noise"] = noise.get("width")
    del plain
    return out


@torch.no_grad()
def draft_target_disagreements(cfg, model, sched, prompts, req, group):
    """Where the model drafter's argmax parts from the target's along a
    request's committed stream, under self-drafting: its admission group
    re-prefilled exactly as `Scheduler` did (the draft's prefill is the
    same computation), the row inserted into a paged 4-slot pool (the
    target's: verify rows are bitwise decode steps) and a stripe one (the
    draft's), then both decoded on the stream's own tokens.  Returns the
    positions where the argmaxes differ with the target's top-2 margin
    there, the max |dlogit| between the two paths and max |logit|."""
    from repro_torch.models import zoo
    from repro_torch.serve.kv import SlotKVCache

    st, _ = regroup(cfg, model, sched, prompts, group)
    kv = SlotKVCache(cfg, 4, sched.max_seq, page=16, n_pages=None, device="cuda")
    dkv = SlotKVCache(cfg, 4, sched.max_seq, device="cuda")
    row, n = group.index(req.rid), len(req.prompt)
    for pool in (kv, dkv):
        pool.insert(pool.acquire(), st, n, row=row, reserve=n + len(req.tokens))
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    diffs, delta, top = [], 0.0, 0.0
    for t in range(len(req.tokens) - 1):
        tok[0, 0] = req.tokens[t]
        lt = zoo.decode_step(model, cfg, tok, kv.cache)[0, : cfg.vocab].float()
        ld = zoo.decode_step(model, cfg, tok, dkv.cache)[0, : cfg.vocab].float()
        delta = max(delta, float((lt - ld).abs().max()))
        top = max(top, float(lt.abs().max()))
        if int(lt.argmax()) != int(ld.argmax()):
            two = torch.topk(lt, 2).values
            diffs.append((t + 1, float(two[0] - two[1])))
    return diffs, delta, top


def note_rejections(sched) -> list:
    """Where each rejection of a spec run falls on its request's stream:
    `sched`'s one host fetch per spec harvest (emits, cnt, judged, active)
    is wrapped, and before the harvest extends the streams, a cycle whose
    judged drafts outnumber its accepted ones (cnt - 1) ended in the
    target's correction, its last emitted token, at index len(tokens) +
    cnt - 1.  Returns a list the runs fill with (request, index)."""
    seen, fetch = [], sched._fetch

    def wrapped(*tensors):
        wait = fetch(*tensors)
        if len(tensors) != 4:
            return wait

        def harvest():
            vals = wait()
            cnt, judged = vals[1], vals[2]
            for slot, req in sched._running.items():
                at = len(req.tokens)
                for c in range(cnt.shape[0]):
                    n = int(cnt[c, slot])
                    if int(judged[c, slot]) > max(n - 1, 0):
                        seen.append((req, at + n - 1))
                    at += n
            return vals
        return harvest

    sched._fetch = wrapped
    return seen


def self_draft(cfg, model, served):
    """The gyro-pruned 0.5B drafting for itself at full width (the
    reference's `run_self_draft` on the card): the served greedy prompts
    with 33 new tokens (32 decode tokens: 8 full rides of k+1), graphed.
    Its streams' first 32 tokens must equal the plain run's or part at a
    near tie; acceptance must be 1.0 with k+1 tokens per verify, or every
    rejection (`note_rejections`) must fall where the draft's stripe path
    (plain attention) and the target's paged one (K2) part on the
    committed stream, at a target top-2 margin within twice their logit
    gap there, and that gap must stay within the kernels' measured gap to
    their plain versions on this model (phase 7); both pools drain."""
    from repro_torch.serve import (ModelDrafter, Request, SamplingParams, Scheduler,
                                   SpecConfig)

    prompts = served["greedy_prompts"]

    def requests():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=33), arrival=i)
                for i, p in enumerate(prompts)]

    sched = Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K, drafter=ModelDrafter(cfg, model)),
                      max_slots=4, max_seq=256, page=16, decode_chunk=8)
    seen = note_rejections(sched)
    r = serve_run("0.5B self-draft", sched, requests, eager=False)
    reqs, line = r["graphed"]
    line["per_cycle_k1"] = spec_launches("0.5B self-draft", cfg, cfg, line, reqs)
    drained("0.5B self-draft", sched)
    plain_sched = served["sched"]
    streams = spec_vs_plain("0.5B self-draft", cfg, model, plain_sched, prompts,
                            served["greedy_reqs"], reqs,
                            lambda: served["mixed"]["prefill_width_noise"], prefix=True)
    st = sched.stats
    # the kernels against their plain versions on this model, teacher-forced
    # (phase 7): the measured gap of the same two routes
    noise = served["agree"][0][2]
    out = dict(line=line, streams=streams, acceptance=st.acceptance_rate,
               tokens_per_verify=st.tokens_per_verify_step, rejections=[], noise=noise)
    if st.acceptance_rate == 1.0:
        ok = st.tokens_per_verify_step == SPEC_K + 1
    else:
        groups = admission_groups(reqs)
        ok = True
        for q in reqs:
            rej = q.spec_proposed - q.spec_accepted
            at = [i for req, i in seen if req is q]
            if not rej and not at:
                continue
            diffs, delta, top = draft_target_disagreements(cfg, model, plain_sched, prompts, q,
                                                           groups[q.rid])
            parted = dict(diffs)
            near = (len(at) == rej and delta <= noise
                    and all(i in parted and parted[i] <= 2 * delta for i in at))
            ok &= near
            out["rejections"].append(dict(rid=q.rid, rejections=rej, at=at, parted_at=diffs,
                                          max_abs_dlogit=delta, max_logit=top, near_tie=near))
    print(f"0.5B self-draft: acceptance {st.acceptance_rate:.4f} ({st.draft_accepted}/"
          f"{st.draft_proposed}), {st.tokens_per_verify_step:.3f} tokens per verify (k+1 = "
          f"{SPEC_K + 1}); the kernels' gap to their plain versions (phase 7) {noise:.3e}"
          + "".join(
              f"\n  request {x['rid']}: {x['rejections']} rejection(s) at tokens {x['at']}; the "
              f"draft's stripe path and the target's paged one part at "
              f"{[i for i, _ in x['parted_at']]} (target top-2 margins "
              f"{', '.join(f'{m:.2e}' for _, m in x['parted_at'])}); max |dlogit| "
              f"{x['max_abs_dlogit']:.3e} of max |logit| {x['max_logit']:.3f}; near tie "
              f"{x['near_tie']}" for x in out["rejections"]), flush=True)
    if not ok:
        raise AssertionError("0.5B self-draft: a rejection is not a near tie, or tokens per "
                             "verify is not k+1 at acceptance 1.0")
    return out


def dense_phase(cfg05, model05, served):
    """Phase 8: the 14B built and packed on the card, K1/K2 at its shapes
    and a verify row bitwise its decode step, its agreement with the plain
    versions and a float32 forward, its serving plain and with the 0.5B
    model drafter; the 0.5B drafting for itself; then codeqwen1.5-7b,
    starcoder2-15b (2 layers each) and bert-base."""
    from repro_torch.core import packing
    from repro_torch.serve.kv import SlotKVCache

    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    rows = norm_rows()
    cfg, model, info = build_packed(BIG, BIG_LAYERS)
    parts = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    out = {"big": {"build": info, "name": BIG}, "norm_rows": rows}
    big = out["big"]
    big["k1"] = k1_shapes("14B", cfg, model, gen, ((4, None), (16, "rows"), (512, None)))
    ps = [p for _, p in layer_projections(cfg, model)]
    dense = [packing.unpack(p) for p in ps]
    big["k1_layer"] = {"B4": k1_layer_at("14B decode", gen, ps, dense, 4),
                       "B16": k1_verify_layer(gen, ps, dense, label="14B verify"),
                       "B512": k1_layer_at("14B prefill", gen, ps, dense, 512)}
    del dense
    big["k2"] = k2_shapes("14B", cfg, (1, SPEC_K + 1, 64, 256), 200)
    kv = SlotKVCache(cfg, len(PROFILE_LENS), 256, page=16, n_pages=None, device="cuda")
    slots, tok = live_pool(cfg, model, kv, SPEC_K + 2)
    bits = big["spec_bits"] = spec_bits(cfg, model, kv.cache, tok)
    if not bits["bit_equal"]:
        raise AssertionError("14B: the verify's rows are not bitwise its decode steps")
    for slot in slots:
        kv.release(slot)
    del kv
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    big["agree"] = dense_agree("14B", cfg, model, f32=True)
    parts["agree"] = time.perf_counter() - t
    t = time.perf_counter()
    prompts = [np.random.default_rng(20 + i).integers(0, cfg.vocab, n).astype(np.int32)
               for i, n in enumerate([16, 24, 40, 64, 96, 128, 33, 80])]
    big["serve"] = big_serve(cfg, model, cfg05, model05, prompts, bits)
    parts["serve"] = time.perf_counter() - t
    del model
    free_card()
    big["freed_to"] = torch.cuda.memory_allocated()
    print(f"14B freed: card memory {gb(big['freed_to'])} allocated", flush=True)
    t = time.perf_counter()
    out["self_draft"] = self_draft(cfg05, model05, served)
    parts["self-draft"] = time.perf_counter() - t
    out["others"] = {}
    for i, (name, layers) in enumerate(OTHER_DENSE):
        t = time.perf_counter()
        ocfg, omodel, oinfo = build_packed(name, layers, seed=5 + i)
        label = name.split("_")[0]
        o = out["others"][name] = {"build": oinfo}
        o["k1"] = k1_shapes(label, ocfg, omodel, gen, ((4, None), (16, "rows"), (512, None)))
        o["k2"] = k2_shapes(label, ocfg, (1, SPEC_K + 1, 64, 256), 300 + 10 * i)
        o["agree"] = dense_agree(label, ocfg, omodel)
        del omodel
        free_card()
        parts[name] = time.perf_counter() - t
    out["parts_s"] = parts
    print("dense phase parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()),
          flush=True)
    return out


# --------------------------------------------------------------------------
# phase 9: the MoE family (granite-3.0 MoE at full width)
# --------------------------------------------------------------------------

MOE = "granite_moe_3b_a800m"
# the layer-0 gyro's iterations: at PRUNE_ITERS (4/4) it took 51.8 s (its
# 120 expert searches on the critical path of one item chain), past this
# phase's share of the time limit
MOE_PRUNE_ITERS = (2, 2)
# the served depth: 16 of its 32 layers, to pay for phase 10's training
# of the other families (the whole script read 1,195.7 s at 32 on a slow
# H100 host)
MOE_LAYERS = 16
# row counts the routing's sums are held bitwise across
ROUTE_ROWS = (1, 4, 16, 64)


class DropCounter:
    """Counts the (token, slot)s that MoE routing drops for capacity, on
    the device with no sync, so also inside captured graphs (each replay
    adds its drops): `moe.route` is wrapped while the block is open.
    Counts by the call's shape: decode (the served 4 slots x 1 row), verify
    (4 x (k+1)) and the rest (prefills, extensions).  Idle lanes' rows
    are routed too and counted with the rest of their call."""

    KINDS = {(len(PROFILE_LENS), 1): "decode", (len(PROFILE_LENS), SPEC_K + 1): "verify"}

    def __init__(self):
        self.drops = torch.zeros(3, dtype=torch.int64, device="cuda")
        self.calls = torch.zeros(3, dtype=torch.int64, device="cuda")

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = route = moe.route
        names = list(self.KINDS.values()) + ["other"]

        def counted(p, x, cfg, capacity_factor=moe.CAPACITY_FACTOR):
            out = route(p, x, cfg, capacity_factor)
            i = names.index(self.KINDS.get(tuple(x.shape[:2]), "other"))
            self.drops[i] += (~out[3]).sum()
            self.calls[i] += 1
            return out

        moe.route = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._orig

    def reset(self):
        self.drops.zero_()
        self.calls.zero_()

    def read(self) -> dict:
        names = list(self.KINDS.values()) + ["other"]
        return {n: (int(d), int(c)) for n, d, c in zip(names, self.drops.tolist(),
                                                       self.calls.tolist())}


def moe_build(gen):
    """granite at full width and MOE_LAYERS of its layers, inited on the
    card (seed 6); layer 0 (its attention and all 40 experts of each
    stack) gyro-pruned at MOE_PRUNE_ITERS by `prune_model`, then noperm;
    the served model takes layer 0's gyro weights and `zoo.pack_params`
    packs the others (noperm)."""
    import dataclasses

    from repro_torch.configs.base import load_arch
    from repro_torch.models import transformer, zoo
    from repro_torch.serve import param_bytes
    from repro_torch.train import pruning

    cfg = dataclasses.replace(load_arch(MOE), n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(6), "cuda")
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t0, held_before=held,
                init_peak=torch.cuda.max_memory_allocated())
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    one = transformer.Transformer(model.embed, [model.blocks[0]], model.ln_f, model.lm_head)
    out = {}
    for method in ("gyro", "noperm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, masks, packed, rep = pruning.prune_model(
            one, cfg1, method=method, rng=np.random.default_rng(0),
            ocp_iters=MOE_PRUNE_ITERS[0], icp_iters=MOE_PRUNE_ITERS[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        kinds = "  ".join(f"{path} {sec:.1f} s" for path, sec in rep.item_seconds.items())
        print(f"granite layer 0 prune_model(method={method!r}, ocp_iters={MOE_PRUNE_ITERS[0]}, "
              f"icp_iters={MOE_PRUNE_ITERS[1]}): {wall:.1f} s (search "
              f"{rep.phase_seconds['search']:.1f} s, realize "
              f"{rep.phase_seconds['realize']:.1f} s); {rep.searches_run} searches; mean "
              f"retained {rep.mean_retained:.6f}; host seconds per item: {kinds}", flush=True)
        out[method] = dict(packed=packed, report=rep, wall_s=wall)
    gyro, noperm = out["gyro"]["report"], out["noperm"]["report"]
    n = check_perms(cfg1, gyro)
    print(f"granite layer 0: gyro {gyro.mean_retained:.6f} vs noperm {noperm.mean_retained:.6f} "
          f"mean retained (gain {gyro.mean_retained - noperm.mean_retained:+.6f}); {n} searched "
          f"perms ({cfg.n_experts} per expert stack) pass their constraint checks", flush=True)
    if not gyro.mean_retained >= noperm.mean_retained - GYRO_MARGIN:
        raise AssertionError(f"granite gyro retained {gyro.mean_retained} < noperm "
                             f"{noperm.mean_retained} - {GYRO_MARGIN}")
    model.blocks[0] = out["gyro"]["packed"].blocks[0]
    del one, out["gyro"]["packed"], out["noperm"]["packed"]
    free_card()
    t = time.perf_counter()
    zoo.pack_params(cfg, model)
    torch.cuda.synchronize()
    packed_b, dense_b = param_bytes(model)
    info.update(pack_s=time.perf_counter() - t, peak=torch.cuda.max_memory_allocated(),
                after=torch.cuda.memory_allocated(), packed_bytes=packed_b, dense_bytes=dense_b,
                prune={m: dict(wall_s=v["wall_s"], mean_retained=v["report"].mean_retained,
                               item_seconds=v["report"].item_seconds)
                       for m, v in out.items()})
    print(f"{MOE}: {cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} hd {cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} -> {cfg.vocab_padded}, eos_id {cfg.eos_id}; init "
          f"{info['init_s']:.1f} s, pack of layers 1-{cfg.n_layers - 1} "
          f"({3 * cfg.n_experts * (cfg.n_layers - 1)} expert matrices and "
          f"{4 * (cfg.n_layers - 1)} attention ones) {info['pack_s']:.1f} s; weights "
          f"{gb(packed_b)} packed vs {gb(dense_b)} dense; card memory {gb(held)} held before, "
          f"peak {gb(info['init_peak'])} after init and {gb(info['peak'])} through prune and "
          f"pack, {gb(info['after'])} after", flush=True)
    return cfg, model, info


def k1_stack_case(label, p, c, gen, dtype):
    """K1 over an expert stack `p` (fields (E, ...)) at C rows an expert:
    one launch held against its plain version (expert by expert), each
    expert's slice bitwise a launch of that expert alone, and kernel, plain
    version and `torch.bmm` over the masked-dense stack timed beside the
    bound."""
    from repro_torch.core import packing
    from repro_torch.core.types import PackedHiNM
    from repro_torch.kernels import hinm_spmm as hs

    if p.vals.dtype != dtype:
        p = PackedHiNM(p.vals.to(dtype), p.vec_idx, p.nm_idx, p.n_out, p.n_in, p.config)
    e, n_out, n_in = p.vals.shape[0], p.n_out, p.n_in
    x = torch.randn((e, c, n_in), generator=gen, device="cuda").to(dtype)
    n0 = hs.hinm_spmm.launches
    y = hs.hinm_spmm(x, p)
    if hs.hinm_spmm.launches - n0 != 1:
        raise AssertionError(f"K1 {label}: the stack took {hs.hinm_spmm.launches - n0} launches")
    y_ref = hs.hinm_spmm_ref(x, p)
    torch.cuda.synchronize()
    rel = float((y.float() - y_ref.float()).abs().max()) / max(
        float(y_ref.float().abs().max()), 1e-30)
    alone = all(torch.equal(hs.hinm_spmm(x[i], p.expert(i)), y[i]) for i in range(e))
    w = packing.unpack_stored(p)                            # (E, n_in, n_out) masked-dense
    ms = time_ms(lambda: hs.hinm_spmm(x, p))
    plain_ms = time_ms(lambda: hs.hinm_spmm_ref(x, p), iters=3)
    lib_ms = time_ms(lambda: torch.bmm(x, w))
    isz = x.element_size()
    b_ms, b_by = bound(x.numel() * isz + p.packed_bytes() + e * c * n_out * isz,
                       2.0 * p.vals.numel() * c, dtype)
    tol = K1_TOL[dtype]
    variant = hs.variant(c, p, dtype)
    line = dict(case=label, E=e, shape=[n_out, n_in], C=c, dtype=str(dtype).split(".")[-1],
                variant=variant, max_abs_err=float((y.float() - y_ref.float()).abs().max()),
                max_rel_err=rel, tol=tol, experts_bitwise_alone=alone, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K1 experts {label:6s} E={e} {n_out}x{n_in} C={c:<4d} {line['dtype']:8s} "
          f"{variant:4s} rel_err={rel:.2e} (tol {tol:.0e}) each expert bitwise alone {alone}; "
          f"kernel {ms*1e3:8.1f} us  plain {plain_ms*1e3:9.1f} us  bmm {lib_ms*1e3:8.1f} us  "
          f"bound {b_ms*1e3:7.1f} us ({b_by})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"K1 experts {label} C={c}: relative error {rel} > {tol}")
    if not alone:
        raise AssertionError(f"K1 experts {label} C={c}: an expert's rows differ from a launch "
                             "of that expert alone")
    return line


def k1_experts(cfg, model, gen):
    """K1 over layer 0's gyro-pruned expert stacks (permuted vec_idx) at the
    served capacities: C 8 (decode and the verify, "rows") and 128 (a
    prefill at 512 rows, "mma" in bf16), bf16 and f32; then the layer's
    three stacks (wg, wu, wd) summed."""
    from repro_torch.models import moe

    blk = model.blocks[0].moe
    for name in ("wg", "wd"):
        vi = getattr(blk, name).w.vec_idx
        if bool((vi[..., 1:] > vi[..., :-1]).all()):
            raise AssertionError(f"granite {name}: vec_idx is ascending, ICP permuted nothing")
    caps = (moe.capacity(len(PROFILE_LENS), cfg), moe.capacity(512, cfg))
    cases = [k1_stack_case(name, getattr(blk, name).w, c, gen, dtype)
             for dtype in (torch.bfloat16, torch.float32) for c in caps
             for name in ("wg", "wd")]
    layer = {}
    for c in caps:
        by = {cs["case"]: cs for cs in cases if cs["C"] == c and cs["dtype"] == "bfloat16"}
        layer[f"C{c}"] = {k: 2 * by["wg"][k] + by["wd"][k]
                          for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"K1 experts, one layer's 3 stacks (wg, wu, wd) at C {c}, bf16: kernel "
              f"{layer[f'C{c}']['ms']*1e3:.1f} us, plain {layer[f'C{c}']['plain_ms']*1e3:.1f} "
              f"us, bmm {layer[f'C{c}']['library_ms']*1e3:.1f} us, bound "
              f"{layer[f'C{c}']['bound_ms']*1e3:.1f} us", flush=True)
    return cases, layer


@torch.no_grad()
def route_rows(cfg, model) -> dict:
    """A row's routing bitwise whatever call holds it: layer 0's router
    probabilities, the top-k weights and the k-sum (`moe._fixed_sum` over
    the k gathered rows) over 64 random rows against the same rows in
    calls of 1, 4 and 16 (from row 0 and from row n), and the whole MoE
    block's rows at 1 and 4 against 16 (capacity 8 at all three: "rows").
    PyTorch's own forms (an f32 matmul router, softmax, sum) printed beside
    them."""
    from repro_torch.models import moe

    p = model.blocks[0].moe
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((64, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    g = torch.randn((64, cfg.top_k, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    w = p.router.w.float()

    def torch_forms(rows):
        lg = rows[:, 0].float() @ w
        return lg, torch.softmax(lg, -1)

    fns = {"router probs": lambda r: moe.router_probs(p, r[:, 0]),
           "top-k weights": lambda r: moe.route(p, r, cfg)[0],
           "k-sum": None}
    full = {k: f(x) for k, f in fns.items() if f}
    full["k-sum"] = moe._fixed_sum(g.float(), dim=1)
    tfull = torch_forms(x)
    out, plain = {k: True for k in fns}, {"matmul router": True, "softmax": True,
                                          "sum over k": True}
    tsum = g.float().sum(1)
    for n in ROUTE_ROWS[:-1]:
        for at in (0, n):
            sl = slice(at, at + n)
            for k, f in fns.items():
                got = moe._fixed_sum(g[sl].float(), dim=1) if f is None else f(x[sl])
                out[k] = out[k] and torch.equal(got, full[k][sl])
            lg, sm = torch_forms(x[sl])
            plain["matmul router"] &= torch.equal(lg, tfull[0][sl])
            plain["softmax"] &= torch.equal(sm, tfull[1][sl])
            plain["sum over k"] &= torch.equal(g[sl].float().sum(1), tsum[sl])
    y16 = moe.moe_apply(p, x[:16], cfg)
    keep16 = moe.route(p, x[:16], cfg)[3]
    drops16 = int((~keep16).sum())
    out["MoE block rows"] = all(torch.equal(moe.moe_apply(p, x[at: at + n], cfg), y16[at: at + n])
                                for n in (1, 4) for at in (0, n))
    print(f"routing rows bitwise across calls of {', '.join(map(str, ROUTE_ROWS))} rows: "
          + ", ".join(f"{k} {v}" for k, v in out.items())
          + f" (the 16-row call dropped {drops16}); PyTorch's own forms: "
          + ", ".join(f"{k} {v}" for k, v in plain.items()), flush=True)
    if not all(v for k, v in out.items() if k != "MoE block rows") or (
            not out["MoE block rows"] and drops16 == 0):
        raise AssertionError("an MoE row depends on the call that holds it")
    return dict(fixed_order=out, torch_forms=plain, drops_16=drops16)


class RouteTape:
    """Records every `moe.route` decision (experts, queue positions, keeps,
    capacity) of a run, and replays them into another run of the same call
    structure: the replayed run takes the recorded decisions and weights
    the recorded experts by its own router probabilities (renormalised).
    A float32 forward routed anew parts from the bf16 one wherever a top-k
    choice or a capacity cut sits within bf16 noise, a discrete change no
    tolerance on logits describes; pinned, the comparison measures the
    arithmetic."""

    def __init__(self):
        self.tape, self.mode = [], None

    @contextlib.contextmanager
    def run(self, mode):
        from repro_torch.models import moe

        route = moe.route
        i = iter(list(self.tape))

        def taped(p, x, cfg, capacity_factor=moe.CAPACITY_FACTOR):
            if mode == "record":
                out = route(p, x, cfg, capacity_factor)
                self.tape.append(out[1:])
                return out
            topi, pos, keep, cap = next(i)
            probs = moe.router_probs(p, x.reshape(-1, x.shape[-1]))
            topv = probs.gather(1, topi)
            return (topv / torch.clamp(moe._fixed_sum(topv), min=1e-9)[:, None], topi, pos,
                    keep, cap)

        moe.route = taped
        try:
            yield
        finally:
            moe.route = route
        if mode == "replay" and next(i, None) is not None:
            raise AssertionError("the replayed run routed fewer times than the recorded one")


@torch.no_grad()
def moe_agree(cfg, model, n_prompt=40, n_dec=4):
    """`dense_agree`'s inputs, teacher-forced prefill + `n_dec` paged decode
    steps through the kernels, against the plain versions, and against a
    float32 twin of the same masked weights (the whole model in f32, TF32
    off: 13.5 GB) run through the same calls, its routing pinned to the
    kernel run's (`RouteTape`); the f32 twin routed anew is printed
    beside it."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import module as M
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    b = 2
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, b, 1)).astype(np.int32)).cuda()
    tape = RouteTape()
    with tape.run("record"):
        a = teacher_forced_logits(cfg, model, prompt, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("granite: non-finite logits on the kernel path")
    out = {"plain": compare_logits(f"granite: kernels vs plain versions, prefill + {n_dec} "
                                   "paged decode steps", a,
                                   teacher_forced_logits(cfg, model, prompt, forced, "torch"))}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    f32 = transformer.Transformer(
        M.Embed(model.embed.table.float()), [f32_block(blk) for blk in model.blocks],
        M.Norm(model.ln_f.scale.float()), M.Linear(model.lm_head.w.float()))
    with tape.run("replay"):
        out["f32"] = compare_logits(
            "granite: kernels vs a float32 twin of the masked weights (TF32 off), routing "
            "pinned to the kernel run's", a,
            teacher_forced_logits(cfg32, f32, prompt, forced, "torch"), tol=F32_TOL)
    free32 = teacher_forced_logits(cfg32, f32, prompt, forced, "torch")
    out["f32_routed_anew"] = float((a - free32).abs().max()) / float(free32.abs().max())
    print(f"granite: the float32 twin routed anew (not gated): max |dlogit| / max|logit| = "
          f"{out['f32_routed_anew']:.2e}; greedy-token match "
          f"{float((a.argmax(-1) == free32.argmax(-1)).float().mean()):.3f}", flush=True)
    del f32
    free_card()
    return out


def moe_serve(cfg, model, prompts, bits, drops):
    """granite served by `Scheduler(max_slots=4, max_seq=256, page=16,
    decode_chunk=8)` from graphs: 8 greedy requests (graphed and the eager
    twin; 7L K1 and L K2 launches a decode step asserted), then
    SpecConfig(k=3) fused with the n-gram drafter, graphed (launches per
    cycle asserted).  Spec streams against plain: equal, or parted where the
    plain run's draw replays within a top-2 margin of the verify's gap from
    decode (`spec_bits`), when that run's verify forwards dropped (token,
    slot)s for capacity (the reference's semantics: a verify row then
    parts from its decode step) or its admission group differed."""
    from repro_torch.models import moe
    from repro_torch.serve import Request, SamplingParams, Scheduler, SpecConfig

    def requests():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=32), arrival=i)
                for i, p in enumerate(prompts)]

    geom = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
    plain = Scheduler(cfg, model, **geom)
    print(f"granite scheduler: KV pool {gb(plain.kv.pool_bytes())} ({plain.kv.n_pages} pages)")
    out, runs = {}, {}
    for label, sched in (("plain", plain),
                         ("spec fused", Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K), **geom))):
        drops.reset()
        runs[label] = r = serve_run(f"granite {label}", sched, requests,
                                    eager=sched is plain)
        torch.cuda.synchronize()
        d = drops.read()
        reqs, ln = r["graphed"]
        groups = len(set(admission_groups(reqs).values()))
        # a spec run's forwards are its verifies (the n-gram drafter runs none)
        fwd = ln["verify_steps"] or ln["decode_steps"]
        want = ((fwd + groups) * 7 * cfg.n_layers, fwd * cfg.n_layers)
        ln["eos_stops"] = sum(x.finish_reason == "eos" for x in reqs)
        ln["drops"] = d
        print(f"granite {label}: launches hinm_spmm {ln['hinm_spmm']}, paged_decode_attn "
              f"{ln['paged_decode_attn']} (want {want[0]}, {want[1]}: {7 * cfg.n_layers} and "
              f"{cfg.n_layers} a decode step or verify, {7 * cfg.n_layers} an admission group "
              f"x {groups}); {ln['eos_stops']} request(s) stopped on eos_id {cfg.eos_id} "
              f"(random weights: token {cfg.eos_id} is as likely as any); capacity drops over "
              f"the warm-up, graphed (and eager) runs by call kind, (drops, calls): {d}",
              flush=True)
        if (ln["hinm_spmm"], ln["paged_decode_attn"]) != want:
            raise AssertionError(f"granite {label}: launches differ from the programs' count")
        if sched is plain:
            out[label] = twins_gate(f"granite {label}", cfg, model, plain, prompts, r, bits)
            before_after(f"granite {label}", r)
        else:
            del sched
    d = runs["spec fused"]["graphed"][1]["drops"]["verify"]
    verify_drops = d[0] / max(d[1], 1) * cfg.n_layers
    out["drops_per_verify"] = verify_drops
    print(f"granite spec fused: {verify_drops:.2f} (token, slot)s dropped per verify forward, "
          f"{d[0] / max(d[1], 1):.2f} a layer ({cfg.n_experts} experts, capacity "
          f"{moe.capacity(len(PROFILE_LENS) * (SPEC_K + 1), cfg)} at {len(PROFILE_LENS) * (SPEC_K + 1)} rows)", flush=True)
    # a verify with drops parts from its decode steps by up to spec_bits'
    # max |dlogit|: a parting within it, where the plain run's draw replays,
    # is a drop's (or a near tie's), not a fault
    out["streams"] = spec_vs_plain("granite spec fused", cfg, model, plain, prompts,
                                   runs["plain"]["graphed"][0], runs["spec fused"]["graphed"][0],
                                   lambda: bits["max_abs_dlogit"], verify_parts=d[0] > 0)
    out["runs"] = {k: {m: ln for m, (_, ln) in v.items()} for k, v in runs.items()}
    del plain
    return out


def moe_phase():
    """Phase 9: granite-3.0 MoE at full width on the card (`moe_build`),
    K1 over its expert stacks, routing rows, a verify against decode, its
    agreement with the plain versions and a float32 forward, and its
    serving (`moe_serve`)."""
    from repro_torch.serve.kv import SlotKVCache

    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    cfg, model, info = moe_build(gen)
    parts = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    out = {"build": info, "name": MOE}
    out["k1"], out["k1_layer"] = k1_experts(cfg, model, gen)
    out["route_rows"] = route_rows(cfg, model)
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    with DropCounter() as drops:
        kv = SlotKVCache(cfg, len(PROFILE_LENS), 256, page=16, n_pages=None, device="cuda")
        slots, tok = live_pool(cfg, model, kv, SPEC_K + 2)
        drops.reset()
        bits = out["spec_bits"] = spec_bits(cfg, model, kv.cache, tok, drops=drops)
        for slot in slots:
            kv.release(slot)
        del kv
        out["agree"] = moe_agree(cfg, model)
        parts["agree"] = time.perf_counter() - t
        t = time.perf_counter()
        prompts = [np.random.default_rng(40 + i).integers(1, cfg.vocab, n).astype(np.int32)
                   for i, n in enumerate([16, 24, 40, 64, 96, 128, 33, 80])]
        out["serve"] = moe_serve(cfg, model, prompts, bits, drops)
    parts["serve"] = time.perf_counter() - t
    del model
    free_card()
    out["parts_s"] = parts
    print("moe phase parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()),
          flush=True)
    return out


# --------------------------------------------------------------------------
# phase 10: training (masked-dense train step, loop, gradual pruning)
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 30
# the parity tests' reduced qwen2-0.5b (tests/test_train.py), f32
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
             head_dim=16)
# the card against the CPU and the resumed loop against an uninterrupted
# one: relative to each leaf's max|x|, f32 (TF32 off); gradients, params
# (relative L2 per leaf outside the gradients' noise floor)
GRAD_TOL = 1e-5
TRAIN_TOL = 1e-4
# the card against the CPU, set between an f32 run's readings and a TF32
# control's on an H100 (PERF.md, Findings): params elementwise outside the
# noise floor (f32 1.0e-4, TF32 8.1e-2) and the losses (8.4e-8, 1.3e-5;
# TRAIN_TOL would pass TF32's)
ELEM_TOL = 1e-3
LOSS_TOL = 1e-6
# the microbatched step's grads against one batch's (bf16 params: each
# microbatch's grads are rounded to bf16 before the f32 sum): the relative
# L2 norm of the difference, per leaf
MICRO_TOL = 2e-2


def _mlp_params(cfg, d_ff) -> int:
    return (3 if cfg.act == "swiglu" else 2) * cfg.d_model * d_ff


def _attn_params(cfg) -> int:
    return cfg.d_model * (2 * cfg.attn_out_dim + 2 * cfg.kv_out_dim)


def model_flops_per_step(cfg, b, s, frames=0) -> float:
    """Model FLOPs of one train step over b rows (PaLM's count, PERF.md §5):
    6 x the matmul multiply-adds per token (every projection and the
    lm_head; the embedding lookup is none), plus 12 x H x hd x the keys a
    query sees (the full S, as PaLM counts, or the window) per attention
    layer and token.  `s` is a row's decoder rows (a vlm's patch rows
    included), `frames` an encdec's encoder rows.  Each family counts its
    own matmuls:
      - MoE: attention, the router and the top-k experts a token runs;
      - encdec: the frame projection and the encoder (bidirectional, over
        `frames`), then the decoder with its cross-attention (k/v
        projected from the encoder's rows, every query over `frames`);
      - ssm: the projections, and the recurrences' per-token state
        products (mLSTM's C update and readout, sLSTM's recurrent r);
      - hybrid: the RG-LRU projections and its 4-tap conv, the attention
        layers' projections over their window; the RG-LRU scan is
        elementwise and left out.
    remat's recomputed forward is not counted."""
    d, head = cfg.d_model, cfg.d_model * cfg.vocab_padded
    attn = 12.0 * cfg.n_heads * cfg.head_dim
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        n_enc = encdec.n_enc_layers(cfg)
        enc = frames * (6.0 * (d * d + n_enc * (_attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)))
                        + n_enc * attn * frames)
        dec_tok = (cfg.n_layers * (_attn_params(cfg) + 2 * d * cfg.attn_out_dim
                                   + _mlp_params(cfg, cfg.d_ff)) + head)
        xkv = frames * cfg.n_layers * 2 * d * cfg.kv_out_dim
        dec = s * (6.0 * dec_tok + cfg.n_layers * attn * (s + frames)) + 6.0 * xkv
        return float(b) * (enc + dec)
    if cfg.family == "ssm":
        from repro_torch.models import xlstm, xlstm_model

        h, dk = cfg.n_heads, xlstm.head_dim(cfg)
        per = {"mlstm": 5 * d * d + 2 * d * h + 2 * h * dk * dk,
               "slstm": 5 * d * d + 4 * h * dk * dk}
        n = xlstm_model.n_periods(cfg) * sum(per[k] for k in xlstm_model.pattern(cfg)) + head
        return float(b * s) * 6.0 * n
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid, rglru

        r = rglru.width(cfg)
        rec = 2 * d * r + 2 * r * r + r * d + rglru.CONV_K * r
        n_kind = dict(zip(hybrid.pattern(cfg), [0] * 3))
        for kind, c in zip(hybrid.pattern(cfg), hybrid.counts(cfg)):
            n_kind[kind] += c
        n = (n_kind.get("rec", 0) * rec + n_kind.get("attn", 0) * _attn_params(cfg)
             + cfg.n_layers * _mlp_params(cfg, cfg.d_ff) + head)
        keys = min(s, cfg.window) if cfg.window else s
        return float(b * s) * (6.0 * n + n_kind.get("attn", 0) * attn * keys)
    ffn = _mlp_params(cfg, cfg.d_ff)
    if cfg.family == "moe":
        ffn = d * cfg.n_experts + cfg.top_k * _mlp_params(cfg, cfg.d_ff)
    n = cfg.n_layers * (_attn_params(cfg) + ffn) + head
    return float(b * s) * (6.0 * n + cfg.n_layers * attn * s)


def noise_floor(grads, floor=1e-3) -> dict:
    """Per leaf, the elements whose gradient is nonzero but under `floor` x
    the leaf's max|g|: sums that cancel to near zero (a k-bias coordinate whose RoPE
    frequency barely turns over the sequence, an embedding row's rare
    hits), whose few-percent change under another summation order (cuBLAS
    vs the CPU, atomics in the embedding backward) AdamW turns into a
    different step, since it divides by the gradient's own scale."""
    from repro_torch import tree as T

    return {name: ((g != 0) & (g.abs() < floor * g.abs().max())).cpu()
            for name, g in T.leaves_with_names(grads)}


def tree_rel_err(got, want, free=None, norm="max") -> float:
    """Over leaves, the worst relative difference: max|got - want| /
    max|want| (`norm="max"`) or ||got - want|| / ||want|| (`"l2"`);
    `free` maps a leaf name to elements not compared."""
    from repro_torch import tree as T

    worst = 0.0
    for (name, a), b in zip(T.leaves_with_names(got), T.leaves(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        if free is not None and name in free:
            a, b = a[~free[name]], b[~free[name]]
        if norm == "l2":
            err = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        else:
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, err)
    return worst


def timed_steps(cfg, step_fn, p, st, batches):
    """`step_fn` from (p, st) over `batches`, each step timed on the host
    clock to its loss's read (a sync); then, at the last params, one
    forward + backward against clip + AdamW, and one more step under
    torch.profiler (device activity): device ms and launches by op class.
    Returns the last (p, st) and the readings."""
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    from repro_torch.train import steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        p, st, met, _ = step_fn(p, st, None, b, i)
        losses.append(float(met["loss"]))          # a sync: the step's work is done
        norms.append(float(met["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(losses=losses, grad_norms=norms, step_ms=ms,
               peak_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = steps.value_and_grad(p, cfg, None, batches[0])[1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g, _ = clip_by_global_norm(g, 1.0)
    upd = make_optimizer("adamw").update(g, st, p, 1e-3)
    torch.cuda.synchronize()
    out.update(fwd_bwd_ms=(t1 - t0) * 1e3, clip_adamw_ms=(time.perf_counter() - t1) * 1e3)
    del g, upd
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every host op too made xlstm's
    # profile (58.7k launches a step) take ~55 s to aggregate on an H100 host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q = step_fn(p, st, None, batches[0], len(batches))
        float(q[2]["loss"])
        out["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
    del q
    rows = device_ops(prof)
    out.update(device_ms=sum(r[0] for r in rows), launches=sum(r[1] for r in rows),
               classes=op_classes(rows, 1))
    return p, st, out


def full_train_step(dev="cuda"):
    """The dense train step at qwen2-0.5b's full width (24 layers, bf16,
    AdamW, cosine_schedule(3e-3, 10, 30), remat) on SyntheticLMData(seed
    0), batch 8 x 512, for TRAIN_STEPS steps: the loss must fall by 0.1
    (tests/test_train.py's rule).  Then one step with microbatches=2 held
    against one batch: loss and grads."""
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import steps

    cfg = load_arch("qwen2_0_5b")
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(p.numel() for p in T.leaves(params))
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    step_fn, _ = steps.make_train_step(cfg, lr_fn=cosine_schedule(3e-3, 10, TRAIN_STEPS))
    opt_state = make_optimizer("adamw").init(params)
    p, opt_state, split = timed_steps(cfg, step_fn, params, opt_state, batches)
    losses, ms, peak = split.pop("losses"), split.pop("step_ms"), split.pop("peak_bytes")
    p50 = float(np.median(ms[5:]))
    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    share = flops / (p50 * 1e-3) / PEAK_OPS[torch.bfloat16]
    out = dict(params=n_params, losses=losses, p50_step_ms=p50,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (p50 * 1e-3), peak_bytes=peak,
               model_flops=flops, mfu=share, first_step_ms=ms[0], **split)
    print(f"train step, qwen2_0_5b full width ({n_params / 1e6:.1f}M params, bf16, AdamW, "
          f"remat), batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {TRAIN_STEPS} steps; p50 step {p50:.1f} ms (steps 5-"
          f"{TRAIN_STEPS - 1}; first {ms[0]:.0f} ms), {out['tokens_per_s']:.0f} tokens/s, "
          f"peak memory {peak / 2**30:.2f} GiB, model FLOPs {flops / 1e12:.2f} T/step = "
          f"{share:.1%} of the dense bf16 peak; one forward + backward (remat) "
          f"{split['fwd_bwd_ms']:.1f} ms, clip + AdamW {split['clip_adamw_ms']:.1f} ms",
          flush=True)
    print(f"  one step under torch.profiler: wall {split['profiled_wall_ms']:.1f} ms, device "
          f"{split['device_ms']:.1f} ms in {split['launches']} launches; by class (ms / "
          "launches): " + "; ".join(f"{c} {t:.1f} / {n:.0f}"
                                    for c, (t, n) in split["classes"].items()), flush=True)
    if not losses[-1] <= losses[0] - 0.1:
        raise AssertionError(f"full-width loss did not fall by 0.1: {losses}")
    del opt_state, p

    # microbatches=2 against one batch, the same weights, f32 accumulation
    b = batches[0]
    l1, g1 = steps.accumulate_grads(params, cfg, None, b, 1)
    l2, g2 = steps.accumulate_grads(params, cfg, None, b, 2, torch.float32)
    rel = max(float((a.float() - c.float()).norm() / c.float().norm())
              for a, c in zip(T.leaves(g2), T.leaves(g1)))
    dl = abs(float(l2) - float(l1)) / abs(float(l1))
    print(f"microbatches=2 vs 1 at full width: loss rel diff {dl:.2e}, grads max per-leaf "
          f"||g2 - g1|| / ||g1|| {rel:.2e} (tol {MICRO_TOL:.0e})", flush=True)
    if not (rel <= MICRO_TOL and dl <= 1e-3):
        raise AssertionError(f"microbatched grads disagree: {rel}, loss {dl}")
    out.update(micro_grad_rel=rel, micro_loss_rel=dl)
    return out


def small_setup(dev):
    """The reduced config, its params (torch's generator on the CPU, seed 0,
    then moved to `dev`) and SyntheticLMData(seed 1) at 4 x 32 on `dev`."""
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import zoo

    cfg = load_arch("qwen2_0_5b").reduced(**SMALL)
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    data = SyntheticLMData(cfg.vocab, 32, 4, seed=1, device=dev)
    return cfg, T.map(lambda t: t.to(dev), params), data


def reduced_run(dev, tf32=False):
    """The reduced config on `dev` (f32; TF32 for matmuls when `tf32`):
    the first batch's gradients, then three AdamW steps.  Returns (params,
    losses, step-0 grads)."""
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import steps

    cfg, p, data = small_setup(dev)
    # after small_setup: its init pins TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    g0 = steps.value_and_grad(p, cfg, None, data.batch(0))[1]
    step_fn, _ = steps.make_train_step(cfg, lr_fn=cosine_schedule(1e-2, 5, 100))
    st, losses = make_optimizer("adamw").init(p), []
    for i in range(3):
        p, st, met, _ = step_fn(p, st, None, data.batch(i), i)
        losses.append(float(met["loss"]))
    if torch.backends.cuda.matmul.allow_tf32 != tf32:
        raise AssertionError("the TF32 setting changed during the run")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return p, losses, g0


def card_vs_cpu():
    """The reduced config, f32, the same weights and batches on the card and
    on the CPU: the first batch's gradients within GRAD_TOL of each leaf's
    max, then three AdamW steps: losses within LOSS_TOL, and outside the
    gradients' noise floor each leaf's params within TRAIN_TOL in relative
    L2 and within ELEM_TOL of the leaf's max elementwise.  A control run
    on the card with TF32 matmuls must fail each of these gates: they tell
    a lower-precision step from an f32 one."""
    cpu = reduced_run("cpu")
    free = noise_floor(cpu[2])
    n_free = sum(int(m.sum()) for m in free.values())
    read = {}
    for name, tf32 in (("f32", False), ("tf32", True)):
        p, losses, g0 = reduced_run("cuda", tf32)
        read[name] = dict(
            grad_rel=tree_rel_err(g0, cpu[2]),
            param_rel=tree_rel_err(p, cpu[0], free, "l2"),
            param_rel_max=tree_rel_err(p, cpu[0], free),
            param_rel_all=tree_rel_err(p, cpu[0]),
            loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, cpu[1])))
        r = read[name]
        print(f"card ({name}) vs CPU, reduced qwen2 f32: step-0 grads max rel diff "
              f"{r['grad_rel']:.3e} (tol {GRAD_TOL:.0e}); 3 AdamW steps: losses "
              f"{r['loss_rel']:.3e} (tol {LOSS_TOL:.0e}); params outside the {n_free} noise-floor elements: L2 "
              f"{r['param_rel']:.3e} (tol {TRAIN_TOL:.0e}), elementwise {r['param_rel_max']:.3e} "
              f"(tol {ELEM_TOL:.0e}); with them {r['param_rel_all']:.3e}", flush=True)
    f, c = read["f32"], read["tf32"]
    if not (f["grad_rel"] <= GRAD_TOL and f["param_rel"] <= TRAIN_TOL
            and f["param_rel_max"] <= ELEM_TOL and f["loss_rel"] <= LOSS_TOL):
        raise AssertionError(f"card and CPU disagree: {f}")
    if not (c["grad_rel"] > GRAD_TOL and c["param_rel"] > TRAIN_TOL
            and c["param_rel_max"] > ELEM_TOL and c["loss_rel"] > LOSS_TOL):
        raise AssertionError(f"a gate passes the TF32 control: {c}")
    return dict(**f, noise_floor_elems=n_free, tf32_control=c)


def loop_faults(root, dev="cuda"):
    """The loop on the card (reduced config, f32): a failure at step 3 is
    retried; a run to step 8 then resumed to 12 on the same directory ends
    where an uninterrupted 12-step run does; two failures at step 6 restore
    the step-4 checkpoint and skip the batch."""
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import loop, steps

    cfg, params, data = small_setup(dev)
    step_fn, _ = steps.make_train_step(cfg, lr_fn=cosine_schedule(1e-2, 5, 100))
    opt = make_optimizer("adamw")

    def run(name, total, fails=None, seen=None):
        fails = dict(fails or {})

        def injector(step):
            if fails.get(step, 0):
                fails[step] -= 1
                raise RuntimeError("injected failure")

        state = loop.LoopState(params=params, opt_state=opt.init(params), masks=None)
        lcfg = loop.LoopConfig(total_steps=total, checkpoint_every=4, log_every=100,
                               checkpoint_dir=os.path.join(root, name))
        return loop.run(state, step_fn, data.iterator(), lcfg, fail_injector=injector,
                        on_step=None if seen is None else (lambda s, m: seen.update({s: m})))

    whole = run("whole", 12)
    first, resumed, skipped = {}, {}, {}
    run("resumed", 8, {3: 1}, first)
    state = run("resumed", 12, None, resumed)
    run("skipped", 8, {6: 2}, skipped)
    free = noise_floor(steps.value_and_grad(params, cfg, None, data.batch(0))[1])
    rel = tree_rel_err(state.params, whole.params, free, "l2")
    print(f"loop on the card: step 3 failed once, retried (loss {first[3]['loss']:.4f}); "
          f"resumed at step {min(resumed)} (saved step 7), params vs the uninterrupted run "
          f"L2 rel diff {rel:.2e} (tol {TRAIN_TOL:.0e}); two failures at step 6 -> "
          f"skipped {bool(skipped[6].get('skipped'))}, loop ran to step {max(skipped)}",
          flush=True)
    if sorted(first) != list(range(8)) or first[3].get("skipped"):
        raise AssertionError(f"retry failed: {sorted(first)}")
    if sorted(resumed) != [8, 9, 10, 11] or not rel <= TRAIN_TOL:
        raise AssertionError(f"resume: steps {sorted(resumed)}, rel {rel}")
    if not skipped[6].get("skipped") or sorted(skipped) != list(range(8)):
        raise AssertionError(f"restore-and-skip: {skipped.get(6)}")
    return dict(resume_rel=rel, resumed_at=min(resumed))


# cut from 24, widths full: the 8/8 virtual gyro refresh is host-bound and
# runs each projection kind's layers in turn; at 2 layers the script came
# within 30 s of its 1,200 s limit on a slow H100 host
GRADUAL_LAYERS = 1
GRADUAL_STEPS = 40


def hinm_structure_ok(mask, perm, hcfg) -> bool:
    """A mask in the original layout, under its searched row permutation:
    per V-row tile at most K columns survive, every row keeps K * N / M."""
    m = mask.T[torch.as_tensor(perm, device=mask.device)]
    k = hcfg.kept_columns(m.shape[1])
    tiles = m.reshape(-1, hcfg.v, m.shape[1])
    return (int(tiles.any(dim=1).sum(dim=1).max()) <= k
            and bool((m.sum(dim=1) == k * hcfg.n // hcfg.m).all()))


def gradual_run(method, dev="cuda", layers=GRADUAL_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Gradual HiNM pruning at full width, depth cut to `layers`: vector
    ramp to step 12, N:M (and, for gyro, the virtual refresh at
    make_mask_schedule's 8/8 iterations) at 20, masks every 5, 40 steps.
    Returns the densities at each event, the refresh, the recovery gap."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import gradual, loop, pruning, steps

    cfg = dataclasses.replace(load_arch("qwen2_0_5b"), n_layers=layers)
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    sched = gradual.GradualSchedule(target=cfg.hinm, vector_end_step=12, nm_step=20,
                                    update_every=5)
    cb = gradual.make_mask_schedule(cfg, sched, method=method)
    step_fn, opt = steps.make_train_step(cfg, lr_fn=cosine_schedule(3e-3, 10, GRADUAL_STEPS))
    data = SyntheticLMData(cfg.vocab, seq, batch, seed=0, device=dev)
    state = loop.LoopState(params=params, opt_state=opt.init(params), masks=None)
    events, losses = [], []
    for step in range(GRADUAL_STEPS):
        t0 = time.perf_counter()
        masks = cb(step, state)
        if masks is not None:
            state.masks = masks
            leaves = T.leaves(masks)
            dens = float(np.mean([float(m.float().mean()) for m in leaves]))
            # the schedule's density as the masks realize it: K kept columns
            # of each projection's n_in (a multiple of M), N of M of them
            hcfg, nm = sched.config_at(step), sched.nm_active(step)
            want = float(np.mean([hcfg.kept_columns(m.shape[-2]) / m.shape[-2]
                                  * (hcfg.n / hcfg.m if nm else 1.0) for m in leaves]))
            events.append(dict(step=step, density=dens, schedule=want,
                               nominal=(1 - hcfg.vector_sparsity) * (
                                   hcfg.n / hcfg.m if nm else 1.0),
                               wall_s=time.perf_counter() - t0))
        state.params, state.opt_state, met, _ = step_fn(state.params, state.opt_state,
                                                        state.masks, data.batch(step), step)
        losses.append(float(met["loss"]))
    dense_best = min(losses[: GRADUAL_STEPS // 3])
    final = float(np.mean(losses[-5:]))
    out = dict(events=events, losses=losses, gap=final - dense_best, dense_best=dense_best,
               final=final, hits=cb.perm_cache.hits, misses=cb.perm_cache.misses,
               refreshes=[dict(step=e["step"], wall_s=e["wall_s"],
                               searches=e["report"].searches_run,
                               mean_retained=e["report"].mean_retained)
                          for e in cb.refreshes])
    if cb.refreshes:
        # the masks stay the refresh's after the switch (the layout freezes)
        rep = cb.refreshes[0]["report"]
        blocks = pruning.per_block(state.masks, [n.path for _, n in zoo.perm_graph(cfg).instances()])
        ok = [hinm_structure_ok(blocks[int(tag[7:tag.index("]")])][tag.split("/", 1)[1]],
                                perm, cfg.hinm) for tag, perm in rep.out_perms.items()]
        out.update(structure_ok=sum(ok), structure_n=len(ok))
    return out


def gradual_phase(dev="cuda", **kw):
    runs = {m: gradual_run(m, dev, **kw) for m in ("gyro", "noperm")}
    for method, r in runs.items():
        ev = "; ".join(f"step {e['step']}: {e['density']:.4f} (schedule {e['schedule']:.4f}, "
                       f"nominal {e['nominal']:.4f})" for e in r["events"])
        print(f"gradual {method}, qwen2_0_5b full width cut to {GRADUAL_LAYERS} layers, "
              f"{GRADUAL_STEPS} steps: mask density at each event {ev}", flush=True)
        for e in r["events"]:
            if abs(e["density"] - e["schedule"]) > 1e-3:
                raise AssertionError(f"{method}: density off schedule at {e}")
        if r["refreshes"]:
            f = r["refreshes"][0]
            print(f"  virtual gyro refresh at step {f['step']} (8/8 iterations): "
                  f"{f['wall_s']:.1f} s, {f['searches']} searches, mean retained "
                  f"{f['mean_retained']:.6f}; PermCache hits {r['hits']} misses "
                  f"{r['misses']}; masks with the HiNM structure under their searched "
                  f"permutations {r['structure_ok']}/{r['structure_n']}")
            if r["structure_ok"] != r["structure_n"]:
                raise AssertionError("a virtual mask lacks the HiNM structure")
        print(f"  best dense-phase loss {r['dense_best']:.4f}, final {r['final']:.4f}, "
              f"recovery gap {r['gap']:+.4f}")
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"{method}: non-finite loss")
    final = runs["noperm"]["events"][-1]
    if abs(final["density"] - 0.25) > 1e-3:
        raise AssertionError(f"density after the N:M switch {final['density']} != 0.25")
    return runs


# the other families' training: each at full width, its depth cut, for
# FAMILY_STEPS steps (bf16, AdamW, remat, cosine_schedule(lr, 3, 10)):
# layers, batch rows and a row's tokens (a vlm's rows also hold its 576
# patch rows, an encdec's encoder its frames), and the peak lr
FAMILY_TRAIN = {
    "granite_moe_3b_a800m": dict(n_layers=4, batch=4, seq=256),
    "phi_3_vision_4_2b": dict(n_layers=2, batch=4, seq=64),
    "seamless_m4t_medium": dict(n_layers=2, n_enc_layers=2, batch=4, seq=64, frames=256),
    "xlstm_125m": dict(n_layers=4, batch=4, seq=128),
    # peak lr 1e-3: at 3e-3 its loss climbed from 12.48 to 15.31 over the
    # 10 steps (18.31 at step 6), the same losses in two calls on an H100;
    # AdamW's first steps move every weight by ~lr, a third of wd's init
    # scale (1/sqrt(12,288)) a step (PERF.md, Findings)
    "recurrentgemma_9b": dict(n_layers=3, batch=4, seq=256, lr=1e-3),
}
FAMILY_STEPS = 10
# the schedule's peak lr where FAMILY_TRAIN gives none
FAMILY_LR = 3e-3
# the card against the CPU at reduced() (tests/test_torch_train_families.py's
# configs: phi-3's patch rows cut to 8, recurrentgemma's window to 16),
# 4 rows of 32 tokens (an encdec: 32 frames, 8 tokens)
FAMILY_REDUCED = {"granite_moe_3b_a800m": {}, "phi_3_vision_4_2b": dict(frontend_tokens=8),
                  "seamless_m4t_medium": {}, "xlstm_125m": {},
                  "recurrentgemma_9b": dict(window=16)}
# a gradient leaf under this share of the tree's largest is zero in exact
# arithmetic (xlstm's mLSTM input-gate bias: the normaliser divides out a
# shift common to every token's gate); its values are rounding noise, so
# it is held to be under it on both devices, not to its own max
ZERO_GRAD = 1e-6
# causal block skipping: the 0.5B at full width, 2 rows of 2,048 tokens
# (4 query chunks of 512 over 2 KV blocks of 1,024)
SKIP_BATCH, SKIP_SEQ = 2, 2048


def family_batch(cfg, data, step, frames=0, seed=0, dev="cuda"):
    """`data`'s batch `step` (SyntheticLMData on the CPU) on `dev` in the
    reference's shapes (`data.pipeline.make_batch_specs`), with a seeded
    normal draw for the frontend stub: a vlm's tokens after its
    frontend_tokens patch rows, labels over both; an encdec's `frames`
    frame rows."""
    b = data.batch(step)
    rows = b["tokens"].shape[0]
    gen = torch.Generator().manual_seed(seed * 1000 + step)
    if cfg.frontend == "patch":
        p = cfg.frontend_tokens
        b = dict(tokens=b["tokens"][:, p:], labels=b["labels"],
                 embeds=torch.randn((rows, p, cfg.d_model), generator=gen))
    elif cfg.frontend == "frames":
        b = dict(b, embeds=torch.randn((rows, frames, cfg.d_model), generator=gen))
    return {k: (v.to(cfg.dtype) if k == "embeds" else v).to(dev) for k, v in b.items()}


def family_data(cfg, rows, seq, seed):
    from repro_torch.data.pipeline import SyntheticLMData

    extra = cfg.frontend_tokens if cfg.frontend == "patch" else 0
    return SyntheticLMData(cfg.vocab, seq + extra, rows, seed=seed, device="cpu")


def zero_leaves(grads) -> set:
    """Names of the gradient leaves whose max is under ZERO_GRAD of the
    tree's largest."""
    from repro_torch import tree as T

    leaves = [(n, float(g.abs().max())) for n, g in T.leaves_with_names(grads)]
    top = max(m for _, m in leaves)
    return {n for n, m in leaves if m < ZERO_GRAD * top}


def family_reduced_run(name, dev):
    """`name` at FAMILY_REDUCED's reduced config on `dev`, f32 (TF32 off),
    weights from the CPU's generator (seed 0): the first batch's
    gradients, then three AdamW steps' losses."""
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import steps

    cfg = load_arch(name).reduced(**FAMILY_REDUCED[name])
    p = T.map(lambda t: t.to(dev), zoo.params_of(cfg, zoo.init(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    data = family_data(cfg, 4, 8 if cfg.frontend == "frames" else 32, 1)
    batches = [family_batch(cfg, data, i, frames=32, seed=1, dev=dev) for i in range(3)]
    g0 = steps.value_and_grad(p, cfg, None, batches[0])[1]
    step_fn, _ = steps.make_train_step(cfg, lr_fn=cosine_schedule(1e-2, 5, 100))
    st, losses = make_optimizer("adamw").init(p), []
    for i, b in enumerate(batches):
        p, st, met, _ = step_fn(p, st, None, b, i)
        losses.append(float(met["loss"]))
    return losses, g0


def family_card_vs_cpu(name) -> dict:
    """`family_reduced_run` on the card and on the CPU: the first batch's
    gradients within GRAD_TOL of each leaf's max (a zero leaf under
    ZERO_GRAD of the tree's largest on both), three AdamW steps' losses
    within LOSS_TOL."""
    cpu_losses, cpu_g = family_reduced_run(name, "cpu")
    losses, g = family_reduced_run(name, "cuda")
    from repro_torch import tree as T

    zero = zero_leaves(cpu_g)
    top = max(float(x.abs().max()) for x in T.leaves(cpu_g))
    named = list(zip(T.leaves_with_names(g), T.leaves(cpu_g)))
    zero_max = max([float(a.abs().max()) / top for (n, a), _ in named if n in zero] + [0.0])
    rel = max(float((a.double().cpu() - c.double()).abs().max()) / float(c.abs().max())
              for (n, a), c in named if n not in zero)
    out = dict(grad_rel=rel, zero_leaves=sorted(zero), zero_leaf_max=zero_max,
               loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)))
    print(f"  card vs CPU, {name} reduced f32: step-0 grads max rel diff {out['grad_rel']:.3e} "
          f"(tol {GRAD_TOL:.0e}; zero leaves {out['zero_leaves']} under {zero_max:.1e} of the "
          f"largest gradient, limit {ZERO_GRAD:.0e}); 3 AdamW steps' losses {out['loss_rel']:.3e}"
          f" (tol {LOSS_TOL:.0e})", flush=True)
    if not (out["grad_rel"] <= GRAD_TOL and zero_max < ZERO_GRAD and out["loss_rel"] <= LOSS_TOL):
        raise AssertionError(f"{name}: card and CPU disagree: {out}")
    return out


def family_full_train(name, dev="cuda") -> dict:
    """`name` at full width, depth cut as FAMILY_TRAIN says, bf16: FAMILY_STEPS
    AdamW steps (remat, cosine_schedule(lr, 3, FAMILY_STEPS)) on
    SyntheticLMData(seed 0), `timed_steps`' readings; every loss and
    gradient norm finite, the loss down by 0.1 from step 0 to the last
    (tests/test_train.py's rule)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import steps

    spec = FAMILY_TRAIN[name]
    cfg = dataclasses.replace(load_arch(name), **{k: spec[k] for k in ("n_layers", "n_enc_layers")
                                                  if k in spec})
    rows, seq, frames = spec["batch"], spec["seq"], spec.get("frames", 0)
    torch.cuda.reset_peak_memory_stats()
    p = zoo.params_of(cfg, zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in T.leaves(p))
    data = family_data(cfg, rows, seq, 0)
    batches = [family_batch(cfg, data, i, frames, dev=dev) for i in range(FAMILY_STEPS)]
    step_fn, opt = steps.make_train_step(cfg, lr_fn=cosine_schedule(spec.get("lr", FAMILY_LR), 3,
                                                                     FAMILY_STEPS))
    p, st, split = timed_steps(cfg, step_fn, p, opt.init(p), batches)
    del p, st
    losses, norms, ms = split.pop("losses"), split.pop("grad_norms"), split.pop("step_ms")
    peak = split.pop("peak_bytes")
    p50 = float(np.median(ms[2:]))
    # a row's tokens: a vlm's patch rows and an encdec's frames included
    tok = seq + (cfg.frontend_tokens if cfg.frontend == "patch" else 0) + frames
    dec_rows = seq + (cfg.frontend_tokens if cfg.frontend == "patch" else 0)
    flops = model_flops_per_step(cfg, rows, dec_rows, frames)
    share = flops / (p50 * 1e-3) / PEAK_OPS[torch.bfloat16]
    out = dict(layers=cfg.n_layers, params=n_params, losses=losses, grad_norms=norms,
               step_ms=ms, p50_step_ms=p50, tokens_per_row=tok,
               tokens_per_s=rows * tok / (p50 * 1e-3), init_peak_bytes=init_peak,
               peak_bytes=peak, model_flops=flops, mfu=share, **split)
    depth = (f"{cfg.n_layers} decoder + {spec['n_enc_layers']} encoder layers"
             if "n_enc_layers" in spec else f"{cfg.n_layers} layers")
    shape = (f"{rows} x ({cfg.frontend_tokens} patch rows + {seq} tokens)"
             if cfg.frontend == "patch" else f"{rows} x ({frames} frames, {seq} tokens)"
             if frames else f"{rows} x {seq}")
    print(f"train step, {name} full width at {depth} ({n_params / 1e6:.1f}M params, bf16, "
          f"AdamW, remat), batch {shape}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{FAMILY_STEPS} steps; p50 step {p50:.1f} ms (steps 2-{FAMILY_STEPS - 1}; first "
          f"{ms[0]:.0f} ms), {out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB (init {init_peak / 2**30:.2f} GiB), model FLOPs "
          f"{flops / 1e12:.3f} T/step = {share:.1%} of the dense bf16 peak; one forward + "
          f"backward (remat) {split['fwd_bwd_ms']:.1f} ms, clip + AdamW "
          f"{split['clip_adamw_ms']:.1f} ms", flush=True)
    print(f"  one step under torch.profiler: wall {split['profiled_wall_ms']:.1f} ms, device "
          f"{split['device_ms']:.1f} ms in {split['launches']} launches; by class (ms / "
          "launches): " + "; ".join(f"{c} {t:.1f} / {n:.0f}"
                                    for c, (t, n) in split["classes"].items()), flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{name}: a non-finite loss or gradient norm: {losses} {norms}")
    if not losses[-1] <= losses[0] - 0.1:
        raise AssertionError(f"{name}: full-width loss did not fall by 0.1: {losses}")
    return out


def granite_gradual_masks(dev="cuda") -> dict:
    """Gradual pruning's mask recompute over granite's expert stacks at full
    width, one layer: at a ramp step, its end and the N:M switch (no gyro
    search: the refresh is held to the reference on the CPU),
    `recompute_masks` gives every expert of each (L, E, n_in, n_out) stack
    the single-matrix mask of its own weight, bit for bit, at the
    schedule's density."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo
    from repro_torch.train import gradual

    cfg = dataclasses.replace(load_arch("granite_moe_3b_a800m"), n_layers=1)
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    sched = gradual.GradualSchedule(target=cfg.hinm, vector_end_step=12, nm_step=20,
                                    update_every=5)
    events = []
    for step in (5, 12, 20):
        hcfg, nm = sched.config_at(step), sched.nm_active(step)
        t0 = time.perf_counter()
        masks = gradual.recompute_masks(params, cfg, hcfg, nm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        equal = 0
        for proj in ("wg", "wu", "wd"):
            w, m = params["blocks"]["moe"][proj]["w"], masks["blocks"]["moe"][proj]["w"]
            if m.shape != w.shape:
                raise AssertionError(f"{proj} mask {tuple(m.shape)} != {tuple(w.shape)}")
            equal += sum(bool(torch.equal(m[0, e], gradual._mask_for_weight(w[0, e], hcfg, nm)))
                         for e in range(cfg.n_experts))
        leaves = T.leaves(masks)
        dens = float(np.mean([float(m.float().mean()) for m in leaves]))
        want = float(np.mean([hcfg.kept_columns(m.shape[-2]) / m.shape[-2]
                              * (hcfg.n / hcfg.m if nm else 1.0) for m in leaves]))
        events.append(dict(step=step, nm=nm, density=dens, schedule=want, wall_s=wall,
                           experts_equal=equal, experts=3 * cfg.n_experts))
    print(f"gradual masks, granite full width, 1 layer (3 stacks of {cfg.n_experts} experts): "
          + "; ".join(
        f"step {e['step']}{' (N:M)' if e['nm'] else ''}: {e['experts_equal']}/{e['experts']} "
        f"expert masks equal the per-expert function, density {e['density']:.4f} (schedule "
        f"{e['schedule']:.4f}), {e['wall_s'] * 1e3:.0f} ms" for e in events), flush=True)
    for e in events:
        if e["experts_equal"] != e["experts"] or abs(e["density"] - e["schedule"]) > 1e-3:
            raise AssertionError(f"granite gradual masks: {e}")
    return dict(events=events)


def block_skip_check(dev="cuda") -> dict:
    """Causal block skipping on the 0.5B at full width, SKIP_BATCH x
    SKIP_SEQ: with the knob off and on, the loss and gradients (within
    MICRO_TOL relative L2 per leaf), a train step's mean over 2 steps and
    its peak memory."""
    from repro_torch import perf_knobs
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import steps

    cfg = load_arch("qwen2_0_5b")
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    batch = SyntheticLMData(cfg.vocab, SKIP_SEQ, SKIP_BATCH, seed=0, device=dev).batch(0)
    step_fn, opt = steps.make_train_step(cfg, lr_fn=cosine_schedule(3e-3, 10, 30))
    st = opt.init(params)
    runs = {}
    for on in (False, True):
        with perf_knobs.knobs(causal_block_skip=on):
            loss, g = steps.value_and_grad(params, cfg, None, batch)     # and a warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for i in range(2):
                t0 = time.perf_counter()
                float(step_fn(params, st, None, batch, 5)[2]["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[on] = dict(loss=float(loss), grads=g, step_ms=float(np.mean(ms)),
                            peak_bytes=torch.cuda.max_memory_allocated())
    off, on = runs[False], runs[True]
    rel = max(float((a.float() - c.float()).norm() / max(float(c.float().norm()), 1e-30))
              for a, c in zip(T.leaves(on["grads"]), T.leaves(off["grads"])))
    dl = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    out = dict(loss_rel=dl, grad_rel=rel, **{f"{k}_{m}": v for k, r in (("off", off), ("on", on))
                                             for m, v in r.items() if m != "grads"})
    print(f"causal block skip, qwen2_0_5b full width, batch {SKIP_BATCH} x {SKIP_SEQ} (4 query "
          f"chunks): loss {off['loss']:.5f} off, {on['loss']:.5f} on (rel diff {dl:.2e}); grads "
          f"max per-leaf ||on - off|| / ||off|| {rel:.2e} (tol {MICRO_TOL:.0e}); train step "
          f"{off['step_ms']:.1f} ms off, {on['step_ms']:.1f} ms on (mean of 2); peak memory "
          f"{off['peak_bytes'] / 2**30:.2f} GiB off, {on['peak_bytes'] / 2**30:.2f} GiB on",
          flush=True)
    if not (rel <= MICRO_TOL and dl <= MICRO_TOL):
        raise AssertionError(f"causal block skip changed the step: {out}")
    return out


def family_train_phase() -> dict:
    """The five other families' training on the card, one after another:
    card against CPU at reduced(), then full width at cut depth; granite's
    gradual masks; causal block skipping on the 0.5B."""
    t0 = time.perf_counter()
    out, secs = {"card_vs_cpu": {}, "full": {}}, {}

    def part(label, fn, *args):
        free_card()
        t = time.perf_counter()
        r = fn(*args)
        secs[label] = time.perf_counter() - t
        return r

    for name in FAMILY_TRAIN:
        out["card_vs_cpu"][name] = part(f"card vs CPU {name}", family_card_vs_cpu, name)
    for name in FAMILY_TRAIN:
        out["full"][name] = part(f"full {name}", family_full_train, name)
    out["gradual"] = part("granite masks", granite_gradual_masks)
    out["block_skip"] = part("block skip", block_skip_check)
    free_card()
    out["wall_s"], out["seconds"] = time.perf_counter() - t0, secs
    print(f"family training {out['wall_s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return out


def train_entry_point(root) -> list:
    """examples/train_hinm_lm_torch.py --scale tiny --steps 40 on the card;
    `entry_point_check` wants exit 0 and its report lines."""
    script = os.path.join(ROOT, "examples", "train_hinm_lm_torch.py")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, script, "--scale", "tiny", "--steps", "40",
                        "--ckpt", os.path.join(root, "entry")], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT, "train_hinm_lm_torch.txt"), "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    return [("train entry point", "recovery gap", p, wall)]


def train_phase(entry) -> dict:
    """Training on the card, no fallback: the full-width step, microbatches,
    the card against the CPU, the loop's faults and resume, gradual
    pruning, the entry point (`entry_points_start`'s)."""
    import shutil
    import tempfile

    if not torch.cuda.is_available():
        raise RuntimeError("train_phase needs a CUDA device")
    t0 = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    out = dict(step=full_train_step())
    out["card_vs_cpu"] = card_vs_cpu()
    with tempfile.TemporaryDirectory() as root:
        out["loop"] = loop_faults(root)
        out["gradual"] = gradual_phase()
    free_card()
    out["families"] = family_train_phase()
    fut, entry_root = entry
    out["entry_point"] = entry_point_check(fut.result()[1], lines=3)["train entry point"]
    shutil.rmtree(entry_root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"train phase {out['wall_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 11: the frontend-stub families (phi-3-vision, seamless-m4t-medium)
# --------------------------------------------------------------------------

VLM = "phi_3_vision_4_2b"
ENCDEC = "seamless_m4t_medium"
# the served geometry: phi-3's 576 patch rows, a prompt of up to 128 tokens
# and FRONT_NEW new ones fit a 1,024-row slot
FRONT_GEOM = dict(max_slots=4, max_seq=1024, page=16, decode_chunk=8)
FRONT_NEW = 32
# the encoder-output width each seamless slot keeps (its requests' most
# frames)
T_ENC = 256
# seamless' frames (64-256) and decoder prompts (8-64 tokens) a request
SEAMLESS_FRAMES = (64, 256, 128, 256, 64, 128, 256, 64)
SEAMLESS_LENS = (8, 16, 24, 40, 64, 12, 33, 48)
# phi-3's prompts; every other request carries 576 patch rows
VLM_LENS = (16, 24, 40, 64, 96, 128, 33, 80)


def front_one_layer(cfg, model):
    """A model of the same config over layer 0 of each stack (views of
    `model`'s modules), and its config."""
    import dataclasses

    from repro_torch.models import encdec, transformer

    if cfg.family == "encdec":
        return (dataclasses.replace(cfg, n_layers=1, n_enc_layers=1),
                encdec.EncDec(model.frontend_proj, model.embed, [model.enc[0]], [model.dec[0]],
                              model.ln_enc, model.ln_f, model.lm_head))
    return (dataclasses.replace(cfg, n_layers=1),
            transformer.Transformer(model.embed, [model.blocks[0]], model.ln_f, model.lm_head))


FRONT_SEEDS = {VLM: 12, ENCDEC: 14}


def front_init(name):
    """`name` at full width, inited on the card from its FRONT_SEEDS
    generator."""
    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo

    cfg = load_arch(name)
    gen = torch.Generator(device="cuda").manual_seed(FRONT_SEEDS[name])
    return cfg, zoo.init(cfg, gen, "cuda")


def front_layer0(cfg, model):
    """Layer 0 of each stack, (key, layer) in plan order."""
    return [(key, getattr(model, key)[0])
            for key in (("enc", "dec") if cfg.family == "encdec" else ("blocks",))]


def front_digest(cfg, model) -> list:
    """The planned weights of layer 0 of each stack, summed and maxed in
    float64: what ties a layer pruned in another process to this one."""
    from repro_torch.models import module as M
    from repro_torch.models import zoo

    layers = dict(front_layer0(cfg, model))
    return [(key, node.path, float(w.sum()), float(w.abs().max()))
            for key, node in zoo.perm_graph(cfg).instances()
            for w in [M.get_path(layers[key], node.path).w.double()]]


def front_prune_child(out_dir):
    """The frontend families' layer-0 gyro, in a process of its own: each
    family inited as `front_init` does (the same weights as phase 11's),
    layer 0 of each stack gyro-pruned by `prune_model` at MOE_PRUNE_ITERS,
    then noperm (retained gyro >= noperm - GYRO_MARGIN, every permutation
    checked); the gyro layer(s), the reports and `front_digest` saved
    under `out_dir`.  The search is host-bound, so phase 4 starts this
    beside its own search (`front_prune_start`) and phase 11 waits for
    it (`front_prune_wait`)."""
    from repro_torch.train import pruning

    torch.backends.cuda.matmul.allow_tf32 = False
    for name in FRONT_SEEDS:
        cfg, model = front_init(name)
        cfg1, one = front_one_layer(cfg, model)
        out = {}
        for method in ("gyro", "noperm"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, packed, rep = pruning.prune_model(
                one, cfg1, method=method, rng=np.random.default_rng(0),
                ocp_iters=MOE_PRUNE_ITERS[0], icp_iters=MOE_PRUNE_ITERS[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            kinds = "  ".join(f"{path} {sec:.1f} s" for path, sec in rep.item_seconds.items())
            print(f"{name} layer 0 prune_model(method={method!r}, {MOE_PRUNE_ITERS[0]}/"
                  f"{MOE_PRUNE_ITERS[1]}): {wall:.1f} s (search "
                  f"{rep.phase_seconds['search']:.1f} s); {rep.searches_run} searches; mean "
                  f"retained {rep.mean_retained:.6f}; host seconds per item: {kinds}",
                  flush=True)
            out[method] = dict(packed=packed, wall_s=wall, mean_retained=rep.mean_retained,
                               item_seconds=rep.item_seconds, report=rep)
        gyro, noperm = out["gyro"]["report"], out["noperm"]["report"]
        n = check_perms(cfg1, gyro)
        print(f"{name} layer 0: gyro {gyro.mean_retained:.6f} vs noperm "
              f"{noperm.mean_retained:.6f} mean retained (gain "
              f"{gyro.mean_retained - noperm.mean_retained:+.6f}); {n} searched perms pass "
              "their constraint checks", flush=True)
        if not gyro.mean_retained >= noperm.mean_retained - GYRO_MARGIN:
            raise AssertionError(f"{name} gyro retained {gyro.mean_retained} < noperm "
                                 f"{noperm.mean_retained} - {GYRO_MARGIN}")
        torch.save(dict(layers=dict(front_layer0(cfg, out["gyro"]["packed"])),
                        digest=front_digest(cfg, model), perms_checked=n,
                        prune={m: {k: v[k] for k in ("wall_s", "mean_retained", "item_seconds")}
                               for m, v in out.items()}),
                   os.path.join(out_dir, f"{name}.pt"))
        del model, one, out
        free_card()


def front_prune_start(child="front_prune_child", what="frontend layer-0 gyro",
                      phase_no=11):
    """Start `child` (`front_prune_child`) in a process of its own; its
    output goes to `OUT`/<child>.txt.  Returns (process, directory, child,
    what)."""
    import tempfile

    os.makedirs(OUT, exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"{child}_")
    log = open(os.path.join(OUT, f"{child}.txt"), "w")
    proc = subprocess.Popen([sys.executable, "-c", "import chip_smoke as c; "
                             f"c.{child}({d!r})"], cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    print(f"{what} started in process {proc.pid} (phase {phase_no} waits for it)", flush=True)
    return proc, d, child, what


def front_prune_wait(child, names=tuple(FRONT_SEEDS)) -> dict:
    """Wait for `front_prune_start`'s process (up to 15 minutes more),
    print its output and load what it saved: {name: its record}, for each
    of `names`."""
    import shutil

    proc, d, name, what = child
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    with open(os.path.join(OUT, f"{name}.txt")) as f:
        text = f.read()
    print(f"{what} process: exit {rc}, waited {time.perf_counter() - t0:.1f} "
          "s; its output:\n  " + "\n  ".join(text.strip().splitlines()[-12:]), flush=True)
    if rc != 0:
        raise AssertionError(f"the {what} process failed (exit {rc})")
    out = {name: torch.load(os.path.join(d, f"{name}.pt"), weights_only=False)
           for name in names}
    shutil.rmtree(d, ignore_errors=True)
    return out


def front_build(name, pruned):
    """`name` at full width, inited on the card (`front_init`); layer 0 of
    each stack from `pruned[name]` (the gyro layers `front_prune_child`
    searched on the same weights, tied to them by `front_digest`); the
    rest packed by `zoo.pack_params` with no permutation."""
    from repro_torch.models import zoo
    from repro_torch.serve import param_bytes

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = front_init(name)
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t0, held_before=held,
                init_peak=torch.cuda.max_memory_allocated())
    rec = pruned[name]
    if front_digest(cfg, model) != rec["digest"]:
        raise AssertionError(f"{name}: the pruned process's layer 0 is not this model's")
    for key, layer in rec["layers"].items():
        getattr(model, key)[0] = layer
    t = time.perf_counter()
    zoo.pack_params(cfg, model)
    torch.cuda.synchronize()
    packed_b, dense_b = param_bytes(model)
    info.update(pack_s=time.perf_counter() - t, peak=torch.cuda.max_memory_allocated(),
                after=torch.cuda.memory_allocated(), packed_bytes=packed_b, dense_bytes=dense_b,
                prune=rec["prune"], perms_checked=rec["perms_checked"])
    print(f"{name}: {cfg.n_layers} layers{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
          f" d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.head_dim} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab} -> {cfg.vocab_padded}, {cfg.norm}/{cfg.act}; layer 0 "
          f"gyro {rec['prune']['gyro']['mean_retained']:.6f} (noperm "
          f"{rec['prune']['noperm']['mean_retained']:.6f}, {rec['prune']['gyro']['wall_s']:.1f} s "
          f"in its own process); init {info['init_s']:.1f} s, pack {info['pack_s']:.1f} s; "
          f"weights {gb(packed_b)} packed vs {gb(dense_b)} dense; card memory {gb(held)} held "
          f"before, peak {gb(info['init_peak'])} after init and {gb(info['peak'])} through "
          f"pack, {gb(info['after'])} after", flush=True)
    return cfg, model, info


def front_k1(label, cfg, model, gen):
    """K1 on each distinct projection shape of layer 0 (decoder layer 0 of
    an encoder-decoder, gyro-pruned: permuted vec_idx) at B 4 (decode), 16
    ("rows", the verify's) and a prefill's width (one request's rows: 576
    patch rows + 64 tokens for phi-3, 64 tokens for seamless); and
    seamless' cross-attention k/v at B = 4 slots x T_ENC (every decode
    step's)."""
    from repro_torch.models import module as M

    layer = model.dec[0] if cfg.family == "encdec" else model.blocks[0]
    mlp = ("mlp/wg", "mlp/wu", "mlp/wd") if cfg.act == "swiglu" else ("mlp/wu", "mlp/wd")
    attn = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
    paths = attn + (("xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo")
                    if cfg.family == "encdec" else ()) + mlp
    prefill_b = 576 + 64 if cfg.family == "vlm" else 64
    seen, out, per = set(), [], {}
    for path in paths:
        p = M.get_path(layer, path).w
        per[path] = (p.n_out, p.n_in)
        if (p.n_out, p.n_in) in seen:
            continue
        seen.add((p.n_out, p.n_in))
        for b, var in ((4, None), (16, "rows"), (prefill_b, None)):
            out.append(k1_case(f"{label} {path}", p, b, gen, variant=var))
    if cfg.family == "encdec":
        for path in ("xattn/wk", "xattn/wv"):
            out.append(k1_case(f"{label} {path} enc", M.get_path(layer, path).w,
                               FRONT_GEOM["max_slots"] * T_ENC, gen))
    # a decoder layer's projections per call kind, summed from the cases
    layer_ms = {}
    for b in (4, 16, prefill_b):
        cases = {tuple(c["shape"]): c for c in out if c["B"] == b}
        layer_ms[f"B{b}"] = {k: sum(cases[per[p]][k] for p in paths)
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    if cfg.family == "encdec":
        enc = [c for c in out if c["case"].endswith(" enc")]
        layer_ms[f"xattn kv B{FRONT_GEOM['max_slots'] * T_ENC}"] = {
            k: sum(c[k] for c in enc) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for k, v in layer_ms.items():
        print(f"K1 {label}, one decoder layer's {len(paths)} projections at {k}: kernel "
              f"{v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us, matmul "
              f"{v['library_ms'] * 1e3:.1f} us, bound {v['bound_ms'] * 1e3:.1f} us"
              if not k.startswith("xattn") else
              f"K1 {label}, the cross-attention's k and v over {k}: kernel "
              f"{v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us, matmul "
              f"{v['library_ms'] * 1e3:.1f} us, bound {v['bound_ms'] * 1e3:.1f} us",
              flush=True)
    return out, layer_ms


def front_embeds(n, d, seed):
    """`n` rows of seeded N(0, 1) frontend-stub embeddings, float32."""
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def front_requests(cfg):
    """The phase's 8 greedy requests, FRONT_NEW new tokens each, one
    arriving a step: phi-3's prompts, every other one after 576 patch
    rows; seamless' prompts of 8-64 tokens, each with 64-256 frames."""
    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(31)
    if cfg.family == "vlm":
        spec = [(n, cfg.frontend_tokens if i % 2 == 0 else 0) for i, n in enumerate(VLM_LENS)]
    else:
        spec = list(zip(SEAMLESS_LENS, SEAMLESS_FRAMES))
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n, _ in spec]
    embeds = [front_embeds(p, cfg.d_model, 60 + i) if p else None
              for i, (_, p) in enumerate(spec)]

    def make():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=FRONT_NEW),
                        embeds=e, arrival=i) for i, (p, e) in enumerate(zip(prompts, embeds))]
    return make


def front_cache_kw(cfg) -> dict:
    return {"t_enc": T_ENC} if cfg.family == "encdec" else {}


@torch.no_grad()
def front_live_pool(cfg, model, kv, reserve):
    """PROFILE_LENS prompts, each with its frontend rows (576 patch rows, or
    T_ENC frames), prefilled in one group into the served `SlotKVCache`;
    returns the slots and each one's greedy first token (B, 1)."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler

    b = len(PROFILE_LENS)
    p = cfg.frontend_tokens if cfg.family == "vlm" else T_ENC
    rng = np.random.default_rng(3)
    tokens = np.zeros((b, max(PROFILE_LENS)), np.int32)
    for i, n in enumerate(PROFILE_LENS):
        tokens[i, :n] = rng.integers(0, cfg.vocab, n)
    extra = p if cfg.family == "vlm" else 0
    embeds = torch.from_numpy(np.stack([front_embeds(p, cfg.d_model, 70 + i)
                                        for i in range(b)])).cuda()
    n_rows = torch.tensor([n + extra for n in PROFILE_LENS], dtype=torch.int32, device="cuda")
    stripe = kv.template(b)
    last = zoo.prefill(model, cfg, torch.from_numpy(tokens).cuda(), stripe, embeds=embeds,
                       n_rows=n_rows)
    tok = sampler.greedy(zoo.logits_fn(model, cfg, last)[:, : cfg.vocab].float())[:, None]
    slots = [kv.acquire() for _ in range(b)]
    for row, (slot, n) in enumerate(zip(slots, PROFILE_LENS)):
        kv.insert(slot, stripe, n + extra, row=row, reserve=n + extra + reserve)
    return slots, tok


def f32_twin(cfg, model):
    """A float32 copy of the whole model over the same masked weights:
    every packed projection unpacked to dense f32, every other tensor cast
    (TF32 stays off)."""
    import dataclasses

    from repro_torch.core import packing
    from repro_torch.core.types import PackedHiNM
    from repro_torch.models import module as M

    twin = copy.deepcopy(model)
    for mod in twin.modules():
        if isinstance(mod, M.Linear):
            w = packing.unpack_stored(mod.w) if isinstance(mod.w, PackedHiNM) else mod.w
            mod.set_weight(w.float().contiguous())
        for name, t in list(mod._buffers.items()):
            if t is not None and t.is_floating_point():
                mod._buffers[name] = t.float()
    return dataclasses.replace(cfg, dtype=torch.float32), twin


@torch.no_grad()
def front_forced(cfg, model, prompt, embeds, forced, backend):
    """Prefill `prompt` after its frontend rows (`embeds`), then paged
    decode steps fed the `forced` tokens: the stacked logits (1 + steps,
    B, vocab) in f32."""
    from repro_torch.models import zoo
    from repro_torch.serve.kv import SlotKVCache

    b, n = prompt.shape
    rows = n + (embeds.shape[1] if cfg.family == "vlm" else 0)
    kv = SlotKVCache(cfg, b, FRONT_GEOM["max_seq"], page=16, n_pages=None, device="cuda",
                     **front_cache_kw(cfg))
    stripe = kv.template(b)
    last = zoo.prefill(model, cfg, prompt, stripe, embeds=embeds, backend=backend)
    logits = [zoo.logits_fn(model, cfg, last)]
    for row in range(b):
        kv.insert(kv.acquire(), stripe, rows, row=row, reserve=rows + len(forced))
    for tok in forced:
        logits.append(zoo.decode_step(model, cfg, tok, kv.cache, backend=backend))
    return torch.stack(logits)[..., : cfg.vocab].float()


def front_agree(label, cfg, model, n_prompt=40, n_dec=4):
    """Frontend rows (576 patch rows, or T_ENC frames through the encoder)
    + a teacher-forced prompt + `n_dec` paged decode steps through the
    kernels, against the plain versions and against a float32 twin of the
    same masked weights (`f32_twin`)."""
    rng = np.random.default_rng(11)
    b = 2
    p = cfg.frontend_tokens if cfg.family == "vlm" else T_ENC
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, b, 1)).astype(np.int32)).cuda()
    embeds = torch.from_numpy(np.stack([front_embeds(p, cfg.d_model, 80 + i)
                                        for i in range(b)])).cuda()
    a = front_forced(cfg, model, prompt, embeds, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{label}: non-finite logits on the kernel path")
    what = (f"{p} patch rows + " if cfg.family == "vlm" else f"encode {T_ENC} frames + ")
    out = {"plain": compare_logits(f"{label}: kernels vs plain versions, {what}prefill + "
                                   f"{n_dec} paged decode steps", a,
                                   front_forced(cfg, model, prompt, embeds, forced, "torch"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32, twin = f32_twin(cfg, model)
    out["f32"] = compare_logits(f"{label}: kernels vs a float32 twin of the masked weights "
                                "(TF32 off)", a,
                                front_forced(cfg32, twin, prompt, embeds, forced, "torch"),
                                tol=F32_TOL)
    del twin
    free_card()
    return out


@torch.no_grad()
def front_replay(cfg, model, sched, by_rid, group, rid, j):
    """The logits (vocab,) f32 of request `rid`'s token j: its admission
    group (`group`, rids) re-prefilled exactly as `Scheduler._admit_group`
    does (bucket, padded width, frontend rows, row counts), its row
    inserted into a pool of the scheduler's geometry, then decode steps
    fed its own tokens up to j."""
    from repro_torch.models import zoo
    from repro_torch.serve.kv import SlotKVCache

    rows = [by_rid[r] for r in group]
    k = len(rows)
    k_b = 1
    while k_b < k:
        k_b *= 2
    padded = [rows[min(i, k - 1)] for i in range(k_b)]
    n0 = len(rows[0].prompt)
    s_b = sched._bucket_len(n0, sched._cache_rows(rows[0]) - n0)
    toks = np.zeros((k_b, s_b), np.int32)
    for i, r in enumerate(padded):
        toks[i, : len(r.prompt)] = r.prompt
    n_rows = torch.tensor([sched._cache_rows(r) for r in padded], dtype=torch.int32,
                          device="cuda")
    embeds = (None if rows[0].embeds is None
              else torch.from_numpy(np.stack([r.embeds for r in padded])).cuda())
    kv = SlotKVCache(cfg, sched.max_slots, sched.max_seq, page=16, n_pages=None,
                     device="cuda", **front_cache_kw(cfg))
    st = kv.template(k_b)
    last = zoo.prefill(model, cfg, torch.from_numpy(toks).cuda(), st, embeds=embeds,
                       n_rows=n_rows)
    row = group.index(rid)
    req = by_rid[rid]
    logits = zoo.logits_fn(model, cfg, last)[row, : cfg.vocab].float()
    n = sched._cache_rows(req)
    kv.insert(kv.acquire(), st, n, row=row, reserve=n + j + 1)
    tok = torch.zeros((sched.max_slots, 1), dtype=torch.int32, device="cuda")
    for t in range(j):
        tok[0, 0] = req.tokens[t]
        logits = zoo.decode_step(model, cfg, tok, kv.cache)[0, : cfg.vocab].float()
    return logits


def front_streams(label, cfg, model, sched, ref, got, noise):
    """`got`'s streams against `ref`'s, request by request: equal, or parted
    only at a near tie — the reference run's token at the parting point,
    replayed in its admission group (`front_replay`), must be what that run
    drew, with a top-2 margin within `noise` plus how far the request's
    logits there move between its two runs' admission groups (a fault
    where the margin is larger, or the noise 0)."""
    by_rid = {r.rid: r for r in ref}
    g_ref, g_got = admission_groups(ref), admission_groups(got)
    partings = []
    for a, b in zip(ref, got):
        if a.tokens == b.tokens:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), None)
        if j is None:
            raise AssertionError(f"{label}: request {a.rid} emitted {len(b.tokens)} tokens "
                                 f"against {len(a.tokens)}, equal as far as the shorter goes")
        lg = front_replay(cfg, model, sched, by_rid, g_ref[a.rid], a.rid, j)
        width = 0.0
        if g_got[a.rid] != g_ref[a.rid]:
            other = dict(by_rid, **{r.rid: r for r in got if r.rid in g_got[a.rid]})
            width = float((front_replay(cfg, model, sched, other, g_got[a.rid], a.rid, j)
                           - lg).abs().max())
        top2 = torch.topk(lg, 2).values
        margin, drawn = float(top2[0] - top2[1]), int(lg.argmax())
        limit = noise + width
        partings.append(dict(rid=a.rid, index=j, margin=margin, threshold=limit,
                             replay_matches=drawn == a.tokens[j],
                             near_tie=drawn == a.tokens[j] and margin <= limit and limit > 0))
    same = sum(a.tokens == b.tokens for a, b in zip(ref, got))
    print(f"{label}: streams equal {same}/{len(ref)}; {len(partings)} parting(s)" + "".join(
        f"\n  request {p['rid']} at token {p['index']}: top-2 margin {p['margin']:.3e} "
        f"(threshold {p['threshold']:.3e}), replay draws the token {p['replay_matches']}, "
        f"near tie {p['near_tie']}" for p in partings), flush=True)
    if any(not p["near_tie"] for p in partings):
        raise AssertionError(f"{label}: streams part beyond the near-tie rule")
    return dict(identical=same, requests=len(ref), partings=partings)


def front_launches(label, cfg, line, reqs, verify=False):
    """The graphed run's launches, counted through replays, against what its
    programs make: per decode step (or verify forward) every decoder
    layer's projections on K1 (7 a phi-3 layer; 10 a seamless decoder
    layer: self and cross q/k/v/o, up and down) and its self-attention on
    K2; per admission group the prefill's (the decoder's, and the
    encoder's 6 a layer)."""
    per_layer = 7 if cfg.act == "swiglu" else 6
    if cfg.family == "encdec":
        step = (per_layer + 4) * cfg.n_layers
        group = step + per_layer * cfg.n_enc_layers
    else:
        step = group = per_layer * cfg.n_layers
    fwd = line["verify_steps"] if verify else line["decode_steps"]
    groups = len(set(admission_groups(reqs).values()))
    want = (fwd * step + groups * group, fwd * cfg.n_layers)
    print(f"{label}: launches hinm_spmm {line['hinm_spmm']}, paged_decode_attn "
          f"{line['paged_decode_attn']} (want {want[0]}, {want[1]}: {step} and {cfg.n_layers} a "
          f"{'verify' if verify else 'decode step'} x {fwd}, {group} K1 an admission group x "
          f"{groups})", flush=True)
    if (line["hinm_spmm"], line["paged_decode_attn"]) != want:
        raise AssertionError(f"{label}: launches differ from the programs' count")
    return dict(per_step_k1=step, per_step_k2=cfg.n_layers, per_group_k1=group, groups=groups)


def front_serve(label, cfg, model, bits):
    """8 greedy requests (`front_requests`) on `Scheduler(**FRONT_GEOM)`:
    graphed and as the eager twin, launches per decode step asserted; then
    SpecConfig(k=3) fused (n-gram), graphed.  Graphed streams against the
    eager twin's and spec against plain: equal, or parted at a near tie
    (`front_streams`: the captured-vs-eager gap, or the verify's gap from
    decode, plus the admission group's)."""
    from repro_torch.serve import Scheduler, SpecConfig

    make = front_requests(cfg)
    kw = dict(FRONT_GEOM, cache_kw=front_cache_kw(cfg) or None)
    plain = Scheduler(cfg, model, **kw)
    print(f"{label} scheduler: KV pool {gb(plain.kv.pool_bytes())} ({plain.kv.n_pages} "
          f"pages{f', enc_out {T_ENC} rows a slot' if cfg.family == 'encdec' else ''})",
          flush=True)
    runs = {"plain": serve_run(f"{label} plain", plain, make)}
    reqs, line = runs["plain"]["graphed"]
    line["launch_plan"] = front_launches(f"{label} plain", cfg, line, reqs)
    out = {"twins": front_streams(f"{label} graphed vs eager", cfg, model, plain,
                                  runs["plain"]["eager"][0], reqs,
                                  bits["graph_vs_eager_max_abs_dlogit"])}
    before_after(f"{label} plain", runs["plain"])
    spec = Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K), **kw)
    runs["spec fused"] = serve_run(f"{label} spec fused", spec, make, eager=False)
    sreqs, sline = runs["spec fused"]["graphed"]
    sline["launch_plan"] = front_launches(f"{label} spec fused", cfg, sline, sreqs, verify=True)
    out["spec"] = front_streams(f"{label} spec fused vs plain", cfg, model, plain, reqs, sreqs,
                                bits["max_abs_dlogit"])
    out["runs"] = {k: {m: ln for m, (_, ln) in v.items()} for k, v in runs.items()}
    del plain, spec
    free_card()
    return out


def front_model_phase(label, name, pruned):
    """One family's path: build, kernels at its shapes, a verify against
    decode on a live pool, agreement, serving."""
    from repro_torch.serve.kv import SlotKVCache

    seed = FRONT_SEEDS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    t0 = time.perf_counter()
    cfg, model, info = front_build(name, pruned)
    parts = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    out = {"build": info, "name": name}
    out["k1"], out["k1_layer"] = front_k1(label, cfg, model, gen)
    out["k2"] = k2_shapes(label, cfg, (1, SPEC_K + 1, 64, 256), seed + 40)
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    kv = SlotKVCache(cfg, len(PROFILE_LENS), FRONT_GEOM["max_seq"], page=16, n_pages=None,
                     device="cuda", **front_cache_kw(cfg))
    slots, tok = front_live_pool(cfg, model, kv, SPEC_K + 2)
    bits = out["spec_bits"] = spec_bits(cfg, model, kv.cache, tok)
    if not bits["bit_equal"]:
        raise AssertionError(f"{label}: a verify row is not bitwise its decode step")
    for slot in slots:
        kv.release(slot)
    del kv
    out["agree"] = front_agree(label, cfg, model)
    parts["agree"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve"] = front_serve(label, cfg, model, bits)
    parts["serve"] = time.perf_counter() - t
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model
    free_card()
    out["parts_s"] = parts
    print(f"{label} parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()),
          flush=True)
    return out


def frontend_phase(child):
    """Phase 11: phi-3-vision-4.2b and seamless-m4t-medium at full width
    on the card (`front_model_phase` each), their layer-0 gyro from
    `child` (`front_prune_start`)."""
    pruned = front_prune_wait(child)
    return {"phi-3": front_model_phase("phi-3", VLM, pruned),
            "seamless": front_model_phase("seamless", ENCDEC, pruned)}


# --------------------------------------------------------------------------
# phase 12: the recurrent ssm family (xlstm-125m)
# --------------------------------------------------------------------------

SSM = "xlstm_125m"
SSM_SEED = 16
# the served geometry: a page is asked for and falls back to stripes (the
# family has no pages)
SSM_GEOM = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
SSM_NEW = 32
# the 8 greedy requests' prompt lengths, two arriving a step: 4 distinct
# lengths from 16 to 128, paired so that exact-length groups of two form;
# then 2 sampled requests
SSM_LENS = (37, 37, 16, 16, 80, 80, 128, 37)
SSM_SAMPLED_LENS = (37, 64)
# K1 at one exact prefill width: a group of 2 prompts of 37 tokens
SSM_PREFILL_B = 2 * 37
# the planned projections of a block, per kind
SSM_PATHS = {"stack0": ("wq", "wk", "wv", "wo_gate", "wout"),
             "stack1": ("wz", "wi", "wf", "wo", "wout")}


def ssm_build():
    """xlstm-125m at full width, inited on the card (seed SSM_SEED); the
    first period (layer 0 of each pattern-position stack) gyro-pruned by
    `prune_model` at MOE_PRUNE_ITERS, then noperm; the served model takes
    the gyro blocks and `zoo.pack_params` packs the rest (noperm)."""
    import dataclasses

    from repro_torch.configs.base import load_arch
    from repro_torch.models import xlstm_model, zoo
    from repro_torch.serve import param_bytes
    from repro_torch.train import pruning

    cfg = load_arch(SSM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = zoo.init(cfg, torch.Generator(device="cuda").manual_seed(SSM_SEED), "cuda")
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t0)
    cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))
    one = xlstm_model.XLSTM(model.embed, [[s[0]] for s in model.stacks], model.ln_f,
                            model.lm_head)
    out = {}
    for method in ("gyro", "noperm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, packed, rep = pruning.prune_model(
            one, cfg1, method=method, rng=np.random.default_rng(0),
            ocp_iters=MOE_PRUNE_ITERS[0], icp_iters=MOE_PRUNE_ITERS[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        print(f"xlstm period 0 prune_model(method={method!r}, {MOE_PRUNE_ITERS[0]}/"
              f"{MOE_PRUNE_ITERS[1]}): {wall:.1f} s (search {rep.phase_seconds['search']:.1f} "
              f"s); {rep.searches_run} searches; mean retained {rep.mean_retained:.6f}",
              flush=True)
        out[method] = dict(packed=packed, report=rep, wall_s=wall)
    gyro, noperm = out["gyro"]["report"], out["noperm"]["report"]
    n = check_perms(cfg1, gyro)
    print(f"xlstm period 0: gyro {gyro.mean_retained:.6f} vs noperm {noperm.mean_retained:.6f} "
          f"mean retained (gain {gyro.mean_retained - noperm.mean_retained:+.6f}); {n} searched "
          "perms pass their constraint checks", flush=True)
    if not gyro.mean_retained >= noperm.mean_retained - GYRO_MARGIN:
        raise AssertionError(f"xlstm gyro retained {gyro.mean_retained} < noperm "
                             f"{noperm.mean_retained} - {GYRO_MARGIN}")
    for j, stack in enumerate(out["gyro"]["packed"].stacks):
        model.stacks[j][0] = stack[0]
    del one, out["gyro"]["packed"], out["noperm"]["packed"]
    t = time.perf_counter()
    zoo.pack_params(cfg, model)
    torch.cuda.synchronize()
    packed_b, dense_b = param_bytes(model)
    info.update(pack_s=time.perf_counter() - t, packed_bytes=packed_b, dense_bytes=dense_b,
                perms_checked=n,
                prune={m: dict(wall_s=v["wall_s"], mean_retained=v["report"].mean_retained)
                       for m, v in out.items()})
    print(f"{SSM}: {cfg.n_layers} layers ({'/'.join(cfg.block_pattern)}) d_model {cfg.d_model} "
          f"heads {cfg.n_heads} (state width {cfg.d_model // cfg.n_heads}), vocab {cfg.vocab} "
          f"-> {cfg.vocab_padded}, {cfg.norm}; init {info['init_s']:.1f} s, pack "
          f"{info['pack_s']:.1f} s; weights {gb(packed_b)} packed vs {gb(dense_b)} dense",
          flush=True)
    return cfg, model, info


def ssm_k1(model, gen):
    """K1 on the 5 planned projections of each block kind of period 0
    (gyro-pruned: permuted vec_idx), at B 4 (a decode step's slots) and
    at SSM_PREFILL_B (one exact prefill group's rows), held against the
    plain version and timed beside `torch.matmul` and the bound; summed
    per block."""
    from repro_torch.models import module as M

    out, blocks = [], {}
    for key, paths in SSM_PATHS.items():
        blk = getattr(model, key)[0]
        for b in (4, SSM_PREFILL_B):
            cases = [k1_case(f"xlstm {key} {path}", M.get_path(blk, path).w, b, gen)
                     for path in paths]
            out += cases
            blocks[f"{key} B{b}"] = {k: sum(c[k] for c in cases)
                                     for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for k, v in blocks.items():
        print(f"K1 xlstm, the 5 projections of the {k.split()[0]} block at {k.split()[1]}: kernel "
              f"{v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us, matmul "
              f"{v['library_ms'] * 1e3:.1f} us, bound {v['bound_ms'] * 1e3:.1f} us", flush=True)
    return out, blocks


@torch.no_grad()
def ssm_forced(cfg, model, prompt, forced, backend):
    """Prefill `prompt` into a stripe template of a pool asked for pages
    (it falls back to stripes), insert its rows, then decode steps fed the
    `forced` tokens: the stacked logits (1 + steps, B, vocab) in f32."""
    from repro_torch.models import zoo
    from repro_torch.serve.kv import SlotKVCache

    b, n = prompt.shape
    kv = SlotKVCache(cfg, b, SSM_GEOM["max_seq"], page=16, device="cuda")
    if kv.paged:
        raise AssertionError("xlstm: a pool asked for pages is paged")
    stripe = kv.template(b)
    logits = [zoo.logits_fn(model, cfg, zoo.prefill(model, cfg, prompt, stripe,
                                                    backend=backend))]
    for row in range(b):
        kv.insert(kv.acquire(), stripe, n, row=row, reserve=n + len(forced))
    for tok in forced:
        logits.append(zoo.decode_step(model, cfg, tok, kv.cache, backend=backend))
    return torch.stack(logits)[..., : cfg.vocab].float()


def ssm_agree(cfg, model, n_prompt=40, n_dec=4):
    """A teacher-forced prefill + `n_dec` decode steps through the kernels,
    against the plain versions and a float32 twin of the same masked
    weights (`f32_twin`)."""
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, 2, 1)).astype(np.int32)).cuda()
    a = ssm_forced(cfg, model, prompt, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("xlstm: non-finite logits on the kernel path")
    out = {"plain": compare_logits(f"xlstm: kernels vs plain versions, prefill + {n_dec} "
                                   "decode steps", a,
                                   ssm_forced(cfg, model, prompt, forced, "torch"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32, twin = f32_twin(cfg, model)
    out["f32"] = compare_logits("xlstm: kernels vs a float32 twin of the masked weights "
                                "(TF32 off)", a, ssm_forced(cfg32, twin, prompt, forced, "torch"),
                                tol=F32_TOL)
    del twin
    free_card()
    return out


def ssm_requests(vocab):
    """The 8 greedy requests (SSM_LENS) and 2 sampled ones (T 0.8, top-k 16,
    seed = rid), SSM_NEW new tokens each, two arriving a step."""
    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(17)
    lens = SSM_LENS + SSM_SAMPLED_LENS
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in lens]

    def make():
        reqs = []
        for i, p in enumerate(prompts):
            sp = SamplingParams(max_new_tokens=SSM_NEW)
            if i >= len(SSM_LENS):
                sp.temperature, sp.top_k, sp.seed = 0.8, 16, i
            reqs.append(Request(rid=i, prompt=p, params=sp, arrival=i // 2))
        return reqs
    return make


def ssm_prefill_costs(sched, lens=(16, 37, 80, 128)):
    """What a prefill program of each exact length costs, width 1, greedy:
    its eager run (host wall, synchronized), the capture of its graph
    (host seconds, `GraphCache.capture_seconds`) and a replay (wall,
    synchronized), on the scheduler's own prefill body and buffers, in a
    graph cache of its own."""
    from repro_torch.serve.graphs import GraphCache

    cache = GraphCache(sched.device)
    rng = np.random.default_rng(19)
    out = {}
    for n in lens:
        io = sched._prefill_buffers(n, 1)
        io["tokens"].copy_(torch.from_numpy(rng.integers(1, sched.cfg.vocab, (1, n))
                                            .astype(np.int32)))
        body = sched._prefill_body(io, False)
        key = ("prefill cost", n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        eager = time.perf_counter() - t0
        cache.run(key, body)                # eager again, then the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache.run(key, body)                # a replay
        torch.cuda.synchronize()
        replay = time.perf_counter() - t0
        out[n] = dict(eager_ms=eager * 1e3, capture_ms=cache.capture_seconds[key] * 1e3,
                      replay_ms=replay * 1e3)
        print(f"xlstm prefill of {n} tokens (width 1): eager {eager * 1e3:.1f} ms, capture "
              f"{out[n]['capture_ms']:.1f} ms, replay {replay * 1e3:.2f} ms (break-even after "
              f"{1 + out[n]['capture_ms'] / max(out[n]['eager_ms'] - out[n]['replay_ms'], 1e-9):.2f}"
              " uses)", flush=True)
    del cache
    free_card()
    return out


def ssm_serve(cfg, model):
    """SSM_GEOM's Scheduler (a page asked for; the pool must be stripes):
    the 8 greedy + 2 sampled requests graphed and as the eager twin,
    streams equal; launches a decode step (60 K1, 0 K2) and an admission
    group (60 K1) asserted; the prefill graphs captured by exact length;
    SpecConfig(k=3) and bucket=True refused."""
    from repro_torch.serve import Scheduler, SpecConfig

    per_step = 5 * cfg.n_layers
    sched = Scheduler(cfg, model, **SSM_GEOM)
    if sched.kv.paged or sched.bucket:
        raise AssertionError("xlstm: the pool is paged or the prefill bucketed")
    print(f"xlstm scheduler: stripe pool {gb(sched.kv.pool_bytes())} for "
          f"{SSM_GEOM['max_slots']} slots (page {SSM_GEOM['page']} asked for, kv.paged "
          f"{sched.kv.paged}), prefill exact-length", flush=True)
    runs = serve_run("xlstm plain", sched, ssm_requests(cfg.vocab))
    (got, line), (ref, eline) = runs["graphed"], runs["eager"]
    same = sum(a.tokens == b.tokens for a, b in zip(ref, got))
    print(f"xlstm graphed vs eager: streams equal {same}/{len(ref)}", flush=True)
    if same != len(ref):
        raise AssertionError("xlstm: graphed streams differ from the eager twin's")
    groups = len(set(admission_groups(got).values()))
    for mode, (_, ln) in runs.items():
        want = ((ln["decode_steps"] + groups) * per_step, 0)
        print(f"xlstm {mode}: launches hinm_spmm {ln['hinm_spmm']}, paged_decode_attn "
              f"{ln['paged_decode_attn']} (want {want[0]}, 0: {per_step} a decode step x "
              f"{ln['decode_steps']} and {per_step} an admission group x {groups})", flush=True)
        if (ln["hinm_spmm"], ln["paged_decode_attn"]) != want:
            raise AssertionError(f"xlstm {mode}: launches differ from the programs' count")
    captures = sorted((k[1], k[2], k[3], round(v * 1e3, 1))
                      for k, v in sched.graphs.capture_seconds.items() if k[0] == "prefill")
    lengths = sorted({k[0] for k in captures})
    print(f"xlstm prefill graphs captured: {len(captures)} (length, width, stochastic, capture "
          f"ms): {captures}; distinct lengths {lengths}", flush=True)
    if lengths != sorted(set(SSM_LENS + SSM_SAMPLED_LENS)):
        raise AssertionError("xlstm: the prefill graphs are not keyed by exact length")
    before_after("xlstm plain", runs)
    refused = {}
    for name, kw in (("spec", dict(spec=SpecConfig(k=3))), ("bucket", dict(bucket=True))):
        try:
            Scheduler(cfg, model, **SSM_GEOM, **kw)
        except ValueError as e:
            refused[name] = str(e)
            print(f"xlstm {name} refused: {e}", flush=True)
            continue
        raise AssertionError(f"xlstm: {kw} was not refused")
    out = dict(runs={"plain": {m: ln for m, (_, ln) in runs.items()}}, streams_equal=same,
               requests=len(ref), groups=groups, per_step_k1=per_step,
               prefill_captures=captures, refused=refused)
    out["prefill_costs"] = ssm_prefill_costs(sched)
    del sched
    free_card()
    return out


def ssm_phase():
    """Phase 12: xlstm-125m at full width on the card: build, prune and
    pack; K1 at its shapes; agreement; serving."""
    t0 = time.perf_counter()
    cfg, model, info = ssm_build()
    parts = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SSM_SEED + 1)
    out = {"build": info}
    out["k1"], out["k1_blocks"] = ssm_k1(model, gen)
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["agree"] = ssm_agree(cfg, model)
    parts["agree"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve"] = ssm_serve(cfg, model)
    parts["serve"] = time.perf_counter() - t
    del model
    free_card()
    out["parts_s"] = parts
    print("xlstm parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()), flush=True)
    return out


# --------------------------------------------------------------------------
# phase 13: the hybrid family (recurrentgemma-9b)
# --------------------------------------------------------------------------

HYB = "recurrentgemma_9b"
HYB_SEED = 18
# 8 of the 38 layers: two full (rec, rec, attn) periods and the partial
# (rec, rec) one, so the card runs the leftover-layer path as 38 layers
# do; the depth is cut to keep the phase within the script's time limit
HYB_LAYERS = 8
# the layers the gyro search prunes (in a child process, started in phase
# 4): layer 0 (RG-LRU) and layer 2 (local attention); layer 1 repeats
# layer 0's shapes, and its ICP at K 12,288 would add a third of the
# search's time
HYB_GYRO = (0, 2)
# the child's search threads (the engine's default is 8): 13 searches, two
# of them (wd) ~55% of its host seconds, so 4 threads lose little
HYB_WORKERS = 4
# the served geometry: the 2,100-token prompt and HYB_NEW new tokens fit a
# slot; pages cover the 2,048-row ring
HYB_GEOM = dict(max_slots=4, max_seq=2304, page=16, decode_chunk=8)
HYB_NEW = 64
# the 8 greedy requests' prompt lengths, one arriving a step, all distinct
# (each admission group is one request, whatever the run's timing): a
# 2,000-token prompt whose decode crosses position 2,048 (the ring wraps
# at the config's window) and a 2,100-token one, longer than the window
# (rolled into the ring at prefill)
HYB_LENS = (16, 2100, 24, 40, 2000, 64, 33, 80)
# K1 at one prefill width: the 2,100-token prompt's (a group of one)
HYB_PREFILL_B = 2100
# the live pool of the verify check: two slots whose 4 verify steps cross
# position 2,048, one past the wrap and one short
HYB_LIVE = (2046, 2047, 40, 2100)
# the planned projections of a layer, per mixer kind
HYB_PATHS = {"rec": ("kind_rec/win", "kind_rec/wgate", "kind_rec/wa", "kind_rec/wx",
                     "kind_rec/wout", "mlp/wu", "mlp/wd"),
             "attn": ("kind_attn/attn/wq", "kind_attn/attn/wk", "kind_attn/attn/wv",
                      "kind_attn/attn/wo", "mlp/wu", "mlp/wd")}


def hybrid_init(n_layers):
    """recurrentgemma-9b at full width and `n_layers` layers, inited on the
    card from its HYB_SEED generator: the same embedding and layers 0 to
    n - 1 at any depth (drawn in model order)."""
    import dataclasses

    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo

    cfg = dataclasses.replace(load_arch(HYB), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(HYB_SEED)
    return cfg, zoo.init(cfg, gen, "cuda")


def hybrid_layer(model, i):
    """Layer i: position i % 3's stack, entry i // 3."""
    return model.stacks[i % len(model.stacks)][i // len(model.stacks)]


def hybrid_digest(model) -> list:
    """The planned weights of the HYB_GYRO layers, summed and maxed in
    float64: what ties the layers pruned in the child process to this
    model."""
    from repro_torch.models import module as M

    return [(i, path, float(w.sum()), float(w.abs().max()))
            for i in HYB_GYRO for layer in [hybrid_layer(model, i)]
            for path in HYB_PATHS[layer.kind]
            for w in [M.get_path(layer, path).w.double()]]


def hybrid_prune_child(out_dir):
    """The HYB_GYRO layers' search, in a process of its own: the model
    inited as `hybrid_init` does (its first layers are phase 13's), those
    layers gyro-pruned by `prune_model` at MOE_PRUNE_ITERS as a model of
    their own (pattern (rec, attn)), then noperm (retained gyro >= noperm
    - GYRO_MARGIN, every permutation checked); the gyro layers, the
    reports and `hybrid_digest` saved under `out_dir`.  It runs beside
    phases 5-12, so it yields the host to them: a lower priority and
    HYB_WORKERS search threads."""
    import dataclasses

    from repro_torch.models import hybrid
    from repro_torch.models import module as M
    from repro_torch.train import pruning

    os.nice(10)
    cfg, model = hybrid_init(max(HYB_GYRO) + 1)
    layers = [hybrid_layer(model, i) for i in HYB_GYRO]
    cfg2 = dataclasses.replace(cfg, n_layers=len(layers),
                               block_pattern=tuple(layer.kind for layer in layers))
    # the search never reads the embedding or the head: one row of each
    # keeps `prune_model`'s copies of the model small
    sub = hybrid.Hybrid(M.Embed(model.embed.table[:1].clone()), [[layer] for layer in layers],
                        model.ln_f, M.Linear(model.lm_head.w[:, :1].clone()))
    digest = hybrid_digest(model)
    del model
    free_card()
    out = {}
    for method in ("gyro", "noperm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, packed, rep = pruning.prune_model(
            sub, cfg2, method=method, rng=np.random.default_rng(0),
            ocp_iters=MOE_PRUNE_ITERS[0], icp_iters=MOE_PRUNE_ITERS[1], workers=HYB_WORKERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        kinds = "  ".join(f"{path} {sec:.1f} s" for path, sec in rep.item_seconds.items())
        print(f"{HYB} layers {HYB_GYRO} prune_model(method={method!r}, {MOE_PRUNE_ITERS[0]}/"
              f"{MOE_PRUNE_ITERS[1]}): {wall:.1f} s (search {rep.phase_seconds['search']:.1f} "
              f"s); {rep.searches_run} searches; mean retained {rep.mean_retained:.6f}; host "
              f"seconds per item: {kinds}", flush=True)
        out[method] = dict(packed=packed, wall_s=wall, mean_retained=rep.mean_retained,
                           item_seconds=rep.item_seconds, report=rep)
    gyro, noperm = out["gyro"]["report"], out["noperm"]["report"]
    n = check_perms(cfg2, gyro)
    print(f"{HYB} layers {HYB_GYRO}: gyro {gyro.mean_retained:.6f} vs noperm "
          f"{noperm.mean_retained:.6f} mean retained (gain "
          f"{gyro.mean_retained - noperm.mean_retained:+.6f}); {n} searched perms pass their "
          "constraint checks", flush=True)
    if not gyro.mean_retained >= noperm.mean_retained - GYRO_MARGIN:
        raise AssertionError(f"{HYB} gyro retained {gyro.mean_retained} < noperm "
                             f"{noperm.mean_retained} - {GYRO_MARGIN}")
    torch.save(dict(layers=list(zip(HYB_GYRO, (s[0] for s in out["gyro"]["packed"].stacks))),
                    digest=digest, perms_checked=n,
                    prune={m: {k: v[k] for k in ("wall_s", "mean_retained", "item_seconds")}
                           for m, v in out.items()}),
               os.path.join(out_dir, f"{HYB}.pt"))


def hybrid_build(pruned):
    """recurrentgemma-9b at HYB_LAYERS layers on the card (`hybrid_init`);
    the HYB_GYRO layers from `pruned` (searched in the child process on
    the same weights, tied to them by `hybrid_digest`); the rest packed
    by `zoo.pack_params` with no permutation."""
    from repro_torch.models import zoo
    from repro_torch.serve import param_bytes

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = hybrid_init(HYB_LAYERS)
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t0, held_before=held,
                init_peak=torch.cuda.max_memory_allocated(), layers=HYB_LAYERS)
    if hybrid_digest(model) != pruned["digest"]:
        raise AssertionError(f"{HYB}: the pruned process's layers are not this model's")
    for i, layer in pruned["layers"]:
        model.stacks[i % 3][i // 3] = layer
    t = time.perf_counter()
    zoo.pack_params(cfg, model)
    torch.cuda.synchronize()
    packed_b, dense_b = param_bytes(model)
    info.update(pack_s=time.perf_counter() - t, peak=torch.cuda.max_memory_allocated(),
                after=torch.cuda.memory_allocated(), packed_bytes=packed_b, dense_bytes=dense_b,
                prune=pruned["prune"], perms_checked=pruned["perms_checked"])
    kinds = [layer.kind for s in range(cfg.n_layers) for layer in [hybrid_layer(model, s)]]
    print(f"{HYB}: {cfg.n_layers} of 38 layers ({', '.join(kinds)}) d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.head_dim} rglru {cfg.rglru_dim} d_ff "
          f"{cfg.d_ff} window {cfg.window} vocab {cfg.vocab} -> {cfg.vocab_padded}, "
          f"{cfg.norm}/{cfg.act}; layers {HYB_GYRO} gyro "
          f"{pruned['prune']['gyro']['mean_retained']:.6f} (noperm "
          f"{pruned['prune']['noperm']['mean_retained']:.6f}, "
          f"{pruned['prune']['gyro']['wall_s']:.1f} s in its own process); init "
          f"{info['init_s']:.1f} s, pack {info['pack_s']:.1f} s; weights {gb(packed_b)} packed vs "
          f"{gb(dense_b)} dense; card memory {gb(held)} held before, peak "
          f"{gb(info['init_peak'])} after init and {gb(info['peak'])} through pack, "
          f"{gb(info['after'])} after", flush=True)
    return cfg, model, info


def hybrid_k1(model, gen):
    """K1 on each distinct projection shape of layer 0 (RG-LRU) and layer 2
    (attention), both gyro-pruned, at B 4 (decode, and each step of the
    sequential verify: "rows") and HYB_PREFILL_B (the 2,100-token
    prefill: "mma"), held against the plain version and timed beside
    `torch.matmul` and the bound; summed per layer."""
    from repro_torch.models import module as M

    out, layers = [], {}
    cases = {}
    for i in HYB_GYRO:
        layer = hybrid_layer(model, i)
        for path in HYB_PATHS[layer.kind]:
            p = M.get_path(layer, path).w
            for b in (4, HYB_PREFILL_B):
                key = (p.n_out, p.n_in, b)
                if key not in cases:
                    cases[key] = k1_case(f"hybrid {layer.kind} {path.split('/')[-1]}", p, b, gen)
                    out.append(cases[key])
        for b in (4, HYB_PREFILL_B):
            ws = [M.get_path(layer, path).w for path in HYB_PATHS[layer.kind]]
            layers[f"{layer.kind} B{b}"] = {k: sum(cases[(w.n_out, w.n_in, b)][k] for w in ws)
                                            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for k, v in layers.items():
        kind, b = k.split()
        print(f"K1 hybrid, the {len(HYB_PATHS[kind])} projections of a {kind} layer at {b}: "
              f"kernel {v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us, matmul "
              f"{v['library_ms'] * 1e3:.1f} us, bound {v['bound_ms'] * 1e3:.1f} us", flush=True)
    return out, layers


def ring_case(b, s, kvh, g, hd, page, view, dtype, seed):
    """K2's inputs on rings that have wrapped: every slot's whole table
    (view / page pages) allocated, its s queries ending at a position
    between view + 52 and view + 1,000, each ring row holding the latest
    position at or before the last query that maps onto it."""
    from repro_torch.models import paging

    rng = np.random.default_rng(seed)
    n_bt = view // page
    n_pages = b * n_bt + paging.N_RESERVED
    kp, vp = (rng.normal(size=(n_pages, page, kvh, hd)).astype(np.float32) for _ in range(2))
    kpos = np.full((n_pages, page), paging.KPOS_SENTINEL, np.int32)
    bt = (rng.permutation(np.arange(paging.N_RESERVED, n_pages)).reshape(b, n_bt)
          .astype(np.int32))
    positions = []
    for bi in range(b):
        last = int(rng.integers(view + 52, view + 1001))
        for r in range(view):
            kpos[bt[bi, r // page], r % page] = last - (last - r) % view
        positions.append(list(range(last - s + 1, last + 1)))
    q = rng.normal(size=(b, s, kvh * g, hd)).astype(np.float32)

    def dev(a, dt=None):
        t = torch.from_numpy(a).cuda()
        return t.to(dt) if dt is not None else t

    return (dev(q, dtype), dev(kp, dtype), dev(vp, dtype), dev(kpos), dev(bt),
            dev(np.asarray(positions, np.int32)))


def hybrid_k2(cfg):
    """K2 at recurrentgemma's head layout (KV 1, G 16, hd 256) with its
    window (2,048) over wrapped rings of the served page (16: 128 table
    entries), B 4, bf16: s 1 (decode, and each step of the sequential
    verify) and s 4 (a kernel-only case)."""
    page, view = HYB_GEOM["page"], cfg.window
    g = cfg.n_heads // cfg.n_kv_heads
    return [k2_case(f"hybrid ring s={s}", 4, s, cfg.window, cfg.dtype, None, n_bt=view // page,
                    hd=cfg.head_dim, kvh=cfg.n_kv_heads, g=g,
                    case=ring_case(4, s, cfg.n_kv_heads, g, cfg.head_dim, page, view, cfg.dtype,
                                   50 + s))
            for s in (1, SPEC_K + 1)]


def hybrid_agree(cfg, model, n_prompt=40, n_dec=4):
    """A teacher-forced prefill + `n_dec` paged decode steps through the
    kernels, against the plain versions and a float32 twin of the same
    masked weights (`f32_twin`)."""
    rng = np.random.default_rng(23)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_prompt)).astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (n_dec, 2, 1)).astype(np.int32)).cuda()
    a = teacher_forced_logits(cfg, model, prompt, forced, "auto")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("hybrid: non-finite logits on the kernel path")
    out = {"plain": compare_logits(f"hybrid: kernels vs plain versions, prefill + {n_dec} "
                                   "paged decode steps", a,
                                   teacher_forced_logits(cfg, model, prompt, forced, "torch"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32, twin = f32_twin(cfg, model)
    out["f32"] = compare_logits("hybrid: kernels vs a float32 twin of the masked weights "
                                "(TF32 off)", a,
                                teacher_forced_logits(cfg32, twin, prompt, forced, "torch"),
                                tol=F32_TOL)
    del twin
    free_card()
    return out


@torch.no_grad()
def hybrid_spec_bits(cfg, model):
    """`spec_bits` on a live pool of the served geometry: the HYB_LIVE
    prompts prefilled one by one (exact length) and inserted; the verify's
    four decode steps cross position 2,048 in two slots.  The pool is put
    back from a copy of every leaf between runs (a sequential verify
    restores from its own snapshots, which `spec_bits` does not keep)."""
    from repro_torch import tree as T
    from repro_torch.models import zoo
    from repro_torch.serve import sampler
    from repro_torch.serve.kv import SlotKVCache

    kv = SlotKVCache(cfg, len(HYB_LIVE), HYB_GEOM["max_seq"], page=HYB_GEOM["page"],
                     n_pages=None, device="cuda")
    rng = np.random.default_rng(29)
    toks = []
    for n in HYB_LIVE:
        st = kv.template(1)
        prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (1, n)).astype(np.int32)).cuda()
        last = zoo.prefill(model, cfg, prompt, st)
        toks.append(sampler.greedy(zoo.logits_fn(model, cfg, last)[:, : cfg.vocab].float()))
        kv.insert(kv.acquire(), st, n, reserve=n + SPEC_K + 2)
    saved = [t.clone() for t in T.leaves(kv.cache)]

    def restore():
        for t, s in zip(T.leaves(kv.cache), saved):
            t.copy_(s)

    bits = spec_bits(cfg, model, kv.cache, torch.cat(toks)[:, None], restore=restore)
    if not (bits["bit_equal"] and bits["graph_bit_equal"]):
        raise AssertionError("hybrid: a sequential verify row is not bitwise its decode step")
    del kv, saved
    free_card()
    return bits


def hybrid_requests(vocab):
    """The 8 greedy requests (HYB_LENS), HYB_NEW new tokens each, one
    arriving a step."""
    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(37)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in HYB_LENS]

    def make():
        return [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=HYB_NEW),
                        arrival=i) for i, p in enumerate(prompts)]
    return make


@torch.no_grad()
def hybrid_isolated(cfg, model, sched, reqs):
    """Each request alone: its prompt prefilled at width 1 (as the
    scheduler's groups of one are) and inserted into a pool of the served
    geometry, then a captured greedy decode step over the pool's 4 lanes
    (the other three idle), fed its own tokens until its budget or EOS."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler
    from repro_torch.serve.kv import SlotKVCache

    kv = SlotKVCache(cfg, HYB_GEOM["max_slots"], HYB_GEOM["max_seq"], page=HYB_GEOM["page"],
                     n_pages=None, device="cuda")
    tok = torch.zeros((HYB_GEOM["max_slots"], 1), dtype=torch.int32, device="cuda")
    nxt = torch.zeros((HYB_GEOM["max_slots"],), dtype=torch.int32, device="cuda")

    def body():
        nxt.copy_(sampler.greedy(zoo.decode_step(model, cfg, tok, kv.cache)[:, : cfg.vocab]
                                 .float()))

    step = graphed(body)
    streams = []
    for r in reqs:
        st = kv.template(1)
        last = zoo.prefill(model, cfg, torch.from_numpy(r.prompt[None]).cuda(), st)
        out = [int(sampler.greedy(zoo.logits_fn(model, cfg, last)[:, : cfg.vocab].float())[0])]
        slot = kv.acquire()
        kv.insert(slot, st, len(r.prompt), reserve=len(r.prompt) + HYB_NEW)
        while len(out) < r.params.max_new_tokens and out[-1] != sched.default_eos:
            tok[slot, 0] = out[-1]
            step()
            out.append(int(nxt[slot]))
        kv.release(slot)
        streams.append(out)
    del kv
    free_card()
    return streams


def hybrid_launches(label, cfg, line, reqs, verify=False):
    """The run's launches, counted through replays, against what its
    programs make: per decode step every layer's planned projections on K1
    (7 an RG-LRU layer, 6 an attention layer) and each attention layer's
    K2; a sequential verify is SPEC_K + 1 decode steps; per admission
    group the prefill's K1 (its attention is the stripe's, no K2)."""
    from repro_torch.models import hybrid, zoo

    step_k1 = sum(len(c.graph.nodes) * n for c, n in zip(zoo.perm_graph(cfg).containers,
                                                          hybrid.counts(cfg)))
    step_k2 = hybrid.counts(cfg)[hybrid.pattern(cfg).index("attn")]
    fwd = line["verify_steps"] * (SPEC_K + 1) if verify else line["decode_steps"]
    groups = len(set(admission_groups(reqs).values()))
    want = (fwd * step_k1 + groups * step_k1, fwd * step_k2)
    print(f"{label}: launches hinm_spmm {line['hinm_spmm']}, paged_decode_attn "
          f"{line['paged_decode_attn']} (want {want[0]}, {want[1]}: {step_k1} and {step_k2} a "
          f"decode step x {fwd}{' (verify forwards x 4 steps)' if verify else ''}, {step_k1} K1 "
          f"an admission group x {groups})", flush=True)
    if (line["hinm_spmm"], line["paged_decode_attn"]) != want:
        raise AssertionError(f"{label}: launches differ from the programs' count")
    return dict(per_step_k1=step_k1, per_step_k2=step_k2, groups=groups)


def hybrid_serve(cfg, model):
    """The 8 greedy requests on `Scheduler(**HYB_GEOM)` (paged, exact-length
    admission): graphed and as the eager twin, then SpecConfig(k=3) fused
    and unfused (the sequential verify), graphed.  Streams: graphed =
    eager = the isolated path, and every spec run = plain, exactly;
    launches asserted."""
    from repro_torch.serve import Scheduler, SpecConfig

    make = hybrid_requests(cfg.vocab)
    plain = Scheduler(cfg, model, **HYB_GEOM)
    kv = plain.kv
    if not (kv.paged and kv.view_len == cfg.window and plain.bucket is False):
        raise AssertionError("hybrid: the pool is not a paged ring or the prefill is bucketed")
    if not (max(HYB_LENS) > cfg.window and any(n < cfg.window < n + HYB_NEW for n in HYB_LENS)):
        raise AssertionError("hybrid: no prompt is rolled into the ring or none decodes across it")
    print(f"hybrid scheduler: KV pool {gb(kv.pool_bytes())} ({kv.n_pages} pages of {kv.page} "
          f"rows; a slot's ring {kv.view_len} rows, {kv.pages_needed(10**6)} pages)", flush=True)
    runs = {"plain": serve_run("hybrid plain", plain, make)}
    reqs, line = runs["plain"]["graphed"]
    line["launch_plan"] = hybrid_launches("hybrid plain", cfg, line, reqs)
    eager = runs["plain"]["eager"][0]
    iso = hybrid_isolated(cfg, model, plain, reqs)
    same = {"eager": sum(a.tokens == b.tokens for a, b in zip(eager, reqs)),
            "isolated": sum(a == b.tokens for a, b in zip(iso, reqs))}
    print(f"hybrid graphed streams equal to the eager twin's {same['eager']}/{len(reqs)}, to the "
          f"isolated path's {same['isolated']}/{len(reqs)}", flush=True)
    if min(same.values()) != len(reqs):
        raise AssertionError(f"hybrid: graphed, eager and isolated streams differ: {same}")
    before_after("hybrid plain", runs["plain"])
    out = {"streams_equal": same, "requests": len(reqs), "spec": {}}
    for fused in (True, False):
        name = f"spec {'fused' if fused else 'unfused'}"
        spec = Scheduler(cfg, model, spec=SpecConfig(k=SPEC_K, fused=fused), **HYB_GEOM)
        runs[name] = serve_run(f"hybrid {name}", spec, make, eager=False)
        sreqs, sline = runs[name]["graphed"]
        sline["launch_plan"] = hybrid_launches(f"hybrid {name}", cfg, sline, sreqs, verify=True)
        n = sum(a.tokens == b.tokens for a, b in zip(sreqs, reqs))
        out["spec"][name] = n
        print(f"hybrid {name}: streams equal to plain {n}/{len(reqs)}; acceptance "
              f"{sline['acceptance_rate']:.3f}", flush=True)
        if n != len(reqs):
            raise AssertionError(f"hybrid {name}: streams differ from plain greedy")
        del spec
        free_card()
    out["runs"] = {k: {m: ln for m, (_, ln) in v.items()} for k, v in runs.items()}
    del plain
    free_card()
    return out


def hybrid_phase(child):
    """Phase 13: recurrentgemma-9b at full width (HYB_LAYERS layers) on the
    card: build with the child's gyro layers, kernels at its shapes, a
    sequential verify against decode across the ring's wrap, agreement,
    serving."""
    t0 = time.perf_counter()
    pruned = front_prune_wait(child, (HYB,))[HYB]
    parts = {"wait for the gyro process": time.perf_counter() - t0}
    t = time.perf_counter()
    cfg, model, info = hybrid_build(pruned)
    parts["build"] = time.perf_counter() - t
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(HYB_SEED + 1)
    out = {"build": info}
    out["k1"], out["k1_layers"] = hybrid_k1(model, gen)
    out["k2"] = hybrid_k2(cfg)
    parts["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["spec_bits"] = hybrid_spec_bits(cfg, model)
    out["agree"] = hybrid_agree(cfg, model)
    parts["agree"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve"] = hybrid_serve(cfg, model)
    parts["serve"] = time.perf_counter() - t
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model
    free_card()
    out["parts_s"] = parts
    print("hybrid parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()), flush=True)
    return out


T_START = time.perf_counter()


def main() -> int:
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")
    smi = smi_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    phase("2. build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {', '.join(logs)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    phase("3. kernels")
    k1, layer, crossover, k2, k2_sweep, k3 = kernels_phase()
    from repro_torch.configs.base import load_arch

    prng_check = sampler_check(load_arch("qwen2_0_5b").vocab)

    phase("4. prune")
    cfg, model = full_model()
    k3_launches, k3_path = nm_apply_path(model)
    # phase 11's layer-0 gyro searches, beside this phase's own
    child = front_prune_start()
    atexit.register(lambda: child[0].poll() is None and child[0].kill())
    # the entry points' subprocesses, beside this phase's host-bound search
    entry = entry_points_start()
    gen = torch.Generator(device="cuda").manual_seed(2)
    model, pruned, k1_gyro = prune_phase(cfg, model, gen)
    k3.append(k3_path)
    k1 += k1_gyro
    # phase 13's gyro search, in a child process from here on: beside
    # phase 4's own search it slowed that from 226 to 395 s
    hchild = front_prune_start("hybrid_prune_child", f"{HYB} layers {HYB_GYRO} gyro", 13)
    atexit.register(lambda: hchild[0].poll() is None and hchild[0].kill())

    phase("5. serve")
    served = serve_phase(cfg, model)

    phase("6. observe")
    observed = observe_phase(cfg, model, served, entry[0])

    phase("7. agree")
    served["agree"] = agree_phase(cfg, model)

    phase("8. dense family")
    dense = dense_phase(cfg, model, served)
    big = dense["big"]
    k1 += big["k1"] + [c for o in dense["others"].values() for c in o["k1"]]
    k2 += big["k2"] + [c for o in dense["others"].values() for c in o["k2"]]

    phase("9. moe")
    moe = moe_phase()

    phase("10. train")
    trained = train_phase(entry)

    phase("11. frontend")
    front = frontend_phase(child)

    phase("12. ssm")
    ssm = ssm_phase()

    phase("13. hybrid")
    hyb = hybrid_phase(hchild)
    phase()

    front_k1s = [c for f in front.values() for c in f["k1"]] + hyb["k1"]
    front_k2s = [c for f in front.values() for c in f["k2"]] + hyb["k2"]
    k2_rep = next(c for c in k2 if c["case"] == "s=1 window=0" and c["dtype"] == "bfloat16")
    k2_verify = next(c for c in k2 if c["case"] == "verify s=4" and c["dtype"] == "bfloat16")
    k2_ext = {f"s={c['s']} {c['dtype']}": {k: c[k] for k in (
        "s", "dtype", "n_splits", "n_tiles", "ms", "plain_ms", "library_ms", "sdpa_only_ms",
        "bound_ms", "bound_by", "max_abs_err", "rows_bit_equal_s1")}
        for c in k2 if c["case"].startswith("extension")}
    mixed = served["mixed"]["runs"]
    shared = served["shared"]["runs"]
    paths = ({"greedy": served} | {f"mixed {k}": v["graphed"] for k, v in mixed.items()}
             | {f"share {k}": v["graphed"] for k, v in shared.items()}
             | {f"14B {k}": v["graphed"] for k, v in big["serve"]["runs"].items()}
             | {"0.5B self-draft": dense["self_draft"]["line"]}
             | {f"granite {k}": v["graphed"] for k, v in moe["serve"]["runs"].items()}
             | {f"{m} {k}": v["graphed"] for m, f in front.items()
                for k, v in f["serve"]["runs"].items()}
             | {f"hybrid {k}": v["graphed"] for k, v in hyb["serve"]["runs"].items()})
    by_path = {name: {p: paths[p][name] for p in paths}
               for name in ("hinm_spmm", "paged_decode_attn")}
    # xlstm has no attention: K1 alone runs on its path (K2's 0 asserted)
    by_path["hinm_spmm"] |= {f"xlstm {k}": v["graphed"]["hinm_spmm"]
                             for k, v in ssm["serve"]["runs"].items()}
    for name, counts in by_path.items():
        if min(counts.values()) < 1:
            raise AssertionError(f"{name} was not launched on every path: {counts}")
    kernels = [
        dict(name="hinm_spmm", route="cuda", source="src/repro_torch/csrc/hinm_spmm.cu",
             replaces="src/repro/kernels/hinm_spmm.py:99", launches=served["hinm_spmm"],
             timed="one call of one decode layer's 7 projections (q,k,v,o,gate,up,"
                   "down), B=4, bf16, V=32 (variant rows)",
             crossover={"rows_max_b": K1_CROSSOVER, "layer_ms_by_B": crossover},
             launches_by_path=by_path["hinm_spmm"],
             launches_per_14b_cycle=big["serve"]["runs"]["fused"]["graphed"]["per_cycle_k1"],
             experts={MOE: dict(layer=moe["k1_layer"], cases=moe["k1"],
                                timed="one launch over a stack of 40 experts: wg/wu 512x1536, "
                                      "wd 1536x512, C rows an expert; layer = wg + wu + wd")},
             dense_family={BIG: big["k1_layer"]} | {
                 name: {"layers": o["build"]["layers"]} for name, o in dense["others"].items()},
             frontend={f["name"]: dict(layer=f["k1_layer"], launch_plan=f["serve"]["runs"][
                 "plain"]["graphed"]["launch_plan"]) for f in front.values()},
             ssm={SSM: dict(blocks=ssm["k1_blocks"], per_decode_step=ssm["serve"]["per_step_k1"],
                            per_admission_group=ssm["serve"]["per_step_k1"],
                            timed="the 5 planned projections of a block (768x768 each), bf16, "
                                  f"at B 4 and B {SSM_PREFILL_B}")},
             hybrid={HYB: dict(layers=hyb["k1_layers"], launch_plan=hyb["serve"]["runs"][
                 "plain"]["graphed"]["launch_plan"],
                 timed="a layer's planned projections (RG-LRU: 5 of 4096x4096, wu 12288x4096, "
                       "wd 4096x12288; attention: q/o 4096x4096, k/v 256x4096, wu, wd; layers 0 "
                       f"and 2 gyro-pruned), bf16, at B 4 (rows) and B {HYB_PREFILL_B} (mma)")},
             prefill=k1_prefill_layer(k1, served["prefill_k1_per_admission"]),
             extension=layer.pop("extension"),
             **{**layer,
                "max_abs_err": max([layer["max_abs_err"]] + [
                    c["max_abs_err"] for c in k1 + moe["k1"] + front_k1s + ssm["k1"]]),
                "max_rel_err": max([layer["max_rel_err"]] + [
                    c["max_rel_err"] for c in k1 + moe["k1"] + front_k1s + ssm["k1"]])},
             cases=k1 + front_k1s + ssm["k1"]),
        dict(name="paged_decode_attn", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn.py:116",
             launches=served["paged_decode_attn"],
             launches_by_path=by_path["paged_decode_attn"],
             dense_family={BIG: {f"s={c['s']}": {k: c[k] for k in (
                 "KV", "G", "hd", "n_splits", "n_tiles", "ms", "plain_ms", "library_ms",
                 "sdpa_only_ms", "bound_ms", "bound_by", "max_abs_err")} for c in big["k2"]}},
             frontend={f["name"]: {f"s={c['s']}": {k: c[k] for k in (
                 "KV", "G", "hd", "n_splits", "n_tiles", "ms", "plain_ms", "library_ms",
                 "sdpa_only_ms", "bound_ms", "bound_by", "max_abs_err")} for c in f["k2"]}
                 for f in front.values()},
             hybrid={HYB: {f"s={c['s']}": {k: c[k] for k in (
                 "window", "KV", "G", "hd", "n_bt", "n_splits", "n_tiles", "ms", "plain_ms",
                 "library_ms", "sdpa_only_ms", "bound_ms", "bound_by", "max_abs_err",
                 "rows_bit_equal_s1") if k in c} for c in hyb["k2"]}},
             verify={k: k2_verify[k] for k in ("s", "n_splits", "ms", "plain_ms", "library_ms",
                                               "sdpa_only_ms", "bound_ms", "bound_by",
                                               "max_abs_err", "rows_bit_equal_s1")},
             extension=k2_ext,
             max_abs_err=max(c["max_abs_err"] for c in k2 + front_k2s),
             timed="one decode step of one layer: B=4, s=1, KV=2, G=7, hd=64, page "
                   "16, n_bt 16 with 1-16 pages allocated per slot at random, bf16",
             **{k: k2_rep[k] for k in ("n_splits", "ms", "plain_ms", "library_ms",
                                       "sdpa_only_ms", "bound_ms", "bound_by")},
             **k2_sweep, cases=k2 + front_k2s),
        dict(name="nm_select", route="cuda", source="src/repro_torch/csrc/nm_select.cu",
             replaces="src/repro/kernels/nm_select.py:38", launches=k3_launches,
             timed="ops.nm_apply over the model's 24 down projections, (24, 896, 4864) "
                   "bf16, 2:4",
             max_abs_err=max(c["max_abs_err"] for c in k3),
             **{k: k3_path[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")}, cases=k3),
    ]
    print()
    prof = served["profile"]
    g, n = pruned["gyro"], pruned["noperm"]
    print(f"prune: gyro {g['wall_s']:.1f} s (search {g['report'].phase_seconds['search']:.1f}"
          f" s), mean retained {g['report'].mean_retained:.6f} vs noperm "
          f"{n['report'].mean_retained:.6f}")
    for label, r in [("greedy (8 requests)", served["runs"])] + [
            (f"main flow's mix, {k}", v) for k, v in mixed.items()]:
        print(f"serve {label}: " + "; ".join(
            f"{mode} {r[mode]['decode_tok_s']:.1f} decode tok/s, p50 step "
            f"{r[mode]['p50_step_ms']:.2f} ms, p50 TTFT {r[mode]['p50_ttft_ms']:.1f} ms, idle "
            f"{r[mode]['idle_share']:.1%}" for mode in ("eager", "graphed")) + (
                f"; acceptance {r['graphed']['acceptance_rate']:.3f}, "
                f"{r['graphed']['tokens_per_verify_step']:.3f} tokens per verify"
                if r["graphed"]["verify_steps"] else ""))
    print(f"live-pool step (eager): wall {prof['wall_ms']:.2f} ms, host enqueue "
          f"{prof['host_ms']:.2f} ms, device {prof['device_ms']:.3f} ms")
    for label, r in shared.items():
        gr = r["graphed"]
        print(f"serve share workload, {label}: " + "; ".join(
            f"{mode} {r[mode]['decode_tok_s']:.1f} decode tok/s, p50 step "
            f"{r[mode]['p50_step_ms']:.2f} ms, p50 TTFT {r[mode]['p50_ttft_ms']:.1f} ms, idle "
            f"{r[mode]['idle_share']:.1%}" for mode in ("eager", "graphed"))
            + f"; prefill rows {gr['prefill_rows']}, hit rate {gr['prefix_hit_rate']:.3f}, "
            f"extension replays {gr['extend_replays']} ({gr['extend_device_ms']:.3f} device ms), "
            f"page-steps live {gr['live_page_steps']} held {gr['held_page_steps']}, most prefill "
            f"rows in a step {gr['max_prefill_rows_step']}, extension widths "
            f"{gr['extend_widths']}")
    twins = ([served["twins"]] + list(served["mixed"]["twins"].values())
             + list(served["shared"]["twins"].values()))
    print(f"graphs: graphed streams equal to eager {sum(t['identical'] for t in twins)}/"
          f"{sum(t['requests'] for t in twins)} requests, "
          f"{sum(len(t['partings']) for t in twins)} near-tie parting(s); captured verify "
          f"bitwise the captured decode steps {prof['spec_bits']['graph_bit_equal']}")
    print(f"spec: verify vs decode bit-equal {prof['spec_bits']['bit_equal']}; streams equal "
          f"to plain {served['mixed']['identical']}; {len(served['mixed']['partings'])} "
          f"near-tie parting(s); sampler on CUDA equal to CPU {prng_check['draws_equal']}")
    print(f"share: streams equal to sharing off {served['shared']['identical']}; "
          f"{len(served['shared']['partings'])} near-tie parting(s) (threshold "
          f"{served['shared']['near_tie_threshold']:.3e})")
    ov = observed["overhead"]
    print("observe: streams and launches unchanged with telemetry and the recorder on "
          f"(mix {observed['mix']['streams_equal']}/{observed['mix']['requests']}, share "
          f"{observed['share']['streams_equal']}/{observed['share']['requests']}); records "
          f"replayed; perturbed replay parts at {observed['perturbed_first']}; greedy decode "
          "tok/s " + ", ".join(f"{k} {np.mean(v['decode_tok_s']):.1f}" for k, v in ov.items())
          + f"; entry point exits {[v['exit'] for v in observed['entry_point'].values()]}; "
          f"phase {observed['wall_s']:.1f} s")
    st, gr, cvc = trained["step"], trained["gradual"], trained["card_vs_cpu"]
    print(f"train: full-width step p50 {st['p50_step_ms']:.1f} ms, {st['tokens_per_s']:.0f} "
          f"tokens/s, peak {st['peak_bytes'] / 2**30:.2f} GiB, {st['mfu']:.1%} of the bf16 "
          f"peak in model FLOPs; loss {st['losses'][0]:.4f} -> {st['losses'][-1]:.4f}; "
          f"microbatch grads {st['micro_grad_rel']:.1e}; card vs CPU grads "
          f"{cvc['grad_rel']:.1e}, params {cvc['param_rel']:.1e} L2, "
          f"{cvc['param_rel_max']:.1e} elementwise (TF32 control "
          f"{cvc['tf32_control']['param_rel']:.1e}, {cvc['tf32_control']['param_rel_max']:.1e})"
          f"; resume {trained['loop']['resume_rel']:.1e}"
          f"; gradual recovery gap gyro {gr['gyro']['gap']:+.4f} noperm "
          f"{gr['noperm']['gap']:+.4f} (refresh {gr['gyro']['refreshes'][0]['wall_s']:.1f} s); "
          f"entry point exit {trained['entry_point']['exit']}; phase {trained['wall_s']:.1f} s")
    fam = trained["families"]
    print("train families (full width, cut depth, bf16): " + "; ".join(
        f"{n} p50 {r['p50_step_ms']:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB, {r['mfu']:.2%} of the bf16 peak, loss "
        f"{r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}" for n, r in fam["full"].items())
        + "; card vs CPU grads max " + f"{max(r['grad_rel'] for r in fam['card_vs_cpu'].values()):.1e}"
        + f"; block skip step {fam['block_skip']['off_step_ms']:.1f} -> "
        f"{fam['block_skip']['on_step_ms']:.1f} ms; phase part {fam['wall_s']:.1f} s")
    b, sd = big["build"], dense["self_draft"]
    print(f"dense family: 14B {gb(b['packed_bytes'])} packed vs {gb(b['dense_bytes'])} dense, "
          f"peak {gb(b['peak'])}; agree plain {big['agree']['plain'][0]:.2e}, f32 "
          f"{big['agree']['f32'][0]:.2e}; verify bitwise decode {big['spec_bits']['bit_equal']}; "
          + "; ".join(f"{k} {v['graphed']['decode_tok_s']:.1f} decode tok/s, p50 step "
                      f"{v['graphed']['p50_step_ms']:.2f} ms, p50 TTFT "
                      f"{v['graphed']['p50_ttft_ms']:.1f} ms, idle "
                      f"{v['graphed']['idle_share']:.1%}, acceptance "
                      f"{v['graphed']['acceptance_rate']:.3f}"
                      for k, v in big["serve"]["runs"].items())
          + f"; self-draft acceptance {sd['acceptance']:.4f}, {sd['tokens_per_verify']:.3f} "
          f"tokens per verify; others agree " + ", ".join(
              f"{n} {o['agree']['plain'][0]:.2e}" for n, o in dense["others"].items()))
    mb, ms_ = moe["build"], moe["serve"]
    print(f"moe: granite {gb(mb['packed_bytes'])} packed vs {gb(mb['dense_bytes'])} dense, peak "
          f"{gb(mb['peak'])}; layer-0 gyro {mb['prune']['gyro']['wall_s']:.1f} s, retained "
          f"{mb['prune']['gyro']['mean_retained']:.6f} vs noperm "
          f"{mb['prune']['noperm']['mean_retained']:.6f}; K1 over experts, a layer's 3 stacks "
          + ", ".join(f"{c} {v['ms'] * 1e3:.1f} us (bmm {v['library_ms'] * 1e3:.1f}, bound "
                      f"{v['bound_ms'] * 1e3:.1f})" for c, v in moe["k1_layer"].items())
          + f"; agree plain {moe['agree']['plain'][0]:.2e}, f32 {moe['agree']['f32'][0]:.2e}; "
          f"verify bitwise decode {moe['spec_bits']['bit_equal']} (verify drops "
          f"{moe['spec_bits'].get('verify_drops')}); "
          + "; ".join(f"{k} {v['graphed']['decode_tok_s']:.1f} decode tok/s, p50 step "
                      f"{v['graphed']['p50_step_ms']:.2f} ms, p50 TTFT "
                      f"{v['graphed']['p50_ttft_ms']:.1f} ms, device "
                      f"{v['graphed']['device_step_ms']:.3f} ms a step, idle "
                      f"{v['graphed']['idle_share']:.1%}" for k, v in ms_["runs"].items())
          + f"; {ms_['drops_per_verify']:.2f} drops per verify forward")
    for label, f in front.items():
        fb, fs = f["build"], f["serve"]
        print(f"frontend: {f['name']} {gb(fb['packed_bytes'])} packed vs "
              f"{gb(fb['dense_bytes'])} dense, peak {gb(f['peak_bytes'])}; layer-0 gyro "
              f"{fb['prune']['gyro']['wall_s']:.1f} s, retained "
              f"{fb['prune']['gyro']['mean_retained']:.6f} vs noperm "
              f"{fb['prune']['noperm']['mean_retained']:.6f}; agree plain "
              f"{f['agree']['plain'][0]:.2e}, f32 {f['agree']['f32'][0]:.2e}; verify bitwise "
              f"decode {f['spec_bits']['bit_equal']}; graphed = eager "
              f"{fs['twins']['identical']}/{fs['twins']['requests']}, spec = plain "
              f"{fs['spec']['identical']}/{fs['spec']['requests']}; "
              + "; ".join(f"{k} {m} {ln['decode_tok_s']:.1f} decode tok/s, p50 step "
                          f"{ln['p50_step_ms']:.2f} ms, p50 TTFT {ln['p50_ttft_ms']:.1f} ms, "
                          f"device {ln['device_step_ms']:.3f} ms a step, idle "
                          f"{ln['idle_share']:.1%}"
                          for k, v in fs["runs"].items() for m, ln in v.items()))
    sb, sv = ssm["build"], ssm["serve"]
    print(f"ssm: xlstm {gb(sb['packed_bytes'])} packed vs {gb(sb['dense_bytes'])} dense; period-0 "
          f"gyro {sb['prune']['gyro']['wall_s']:.1f} s, retained "
          f"{sb['prune']['gyro']['mean_retained']:.6f} vs noperm "
          f"{sb['prune']['noperm']['mean_retained']:.6f}; agree plain "
          f"{ssm['agree']['plain'][0]:.2e}, f32 {ssm['agree']['f32'][0]:.2e}; graphed = eager "
          f"{sv['streams_equal']}/{sv['requests']}; {sv['groups']} admission groups, "
          f"{len(sv['prefill_captures'])} prefill graphs; "
          + "; ".join(f"{m} {ln['decode_tok_s']:.1f} decode tok/s, p50 step "
                      f"{ln['p50_step_ms']:.2f} ms, p50 TTFT {ln['p50_ttft_ms']:.1f} ms, device "
                      f"{ln['device_step_ms']:.3f} ms a step, idle {ln['idle_share']:.1%}"
                      for m, ln in sv["runs"]["plain"].items()))
    hb, hs = hyb["build"], hyb["serve"]
    print(f"hybrid: {HYB} at {hb['layers']} layers {gb(hb['packed_bytes'])} packed vs "
          f"{gb(hb['dense_bytes'])} dense, peak {gb(hyb['peak_bytes'])}; layers {HYB_GYRO} gyro "
          f"{hb['prune']['gyro']['wall_s']:.1f} s, retained "
          f"{hb['prune']['gyro']['mean_retained']:.6f} vs noperm "
          f"{hb['prune']['noperm']['mean_retained']:.6f}; agree plain "
          f"{hyb['agree']['plain'][0]:.2e}, f32 {hyb['agree']['f32'][0]:.2e}; sequential verify "
          f"bitwise decode {hyb['spec_bits']['bit_equal']}; graphed = eager = isolated "
          f"{hs['streams_equal']}/{hs['requests']}, spec = plain {hs['spec']}; "
          + "; ".join(f"{k} {m} {ln['decode_tok_s']:.1f} decode tok/s, p50 step "
                      f"{ln['p50_step_ms']:.2f} ms, p50 TTFT {ln['p50_ttft_ms']:.1f} ms, device "
                      f"{ln['device_step_ms']:.3f} ms a step, idle {ln['idle_share']:.1%}"
                      for k, v in hs["runs"].items() for m, ln in v.items()))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in SECONDS.items()))
    print(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
