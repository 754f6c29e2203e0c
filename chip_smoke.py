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
               B 4 calls; the threefry PRNG and sampler on CUDA held equal
               to the CPU.
  4. prune   — full-width qwen2-0.5b (24 layers, bf16, random weights from
               seed 0): `ops.nm_apply` over its 24 down projections (the
               nm_select path, launch count asserted); `prune_model`
               gyro-permutation (OCP + ICP, PRUNE_ITERS iterations) on the
               card, then noperm: wall times, mean retained saliency (gyro >=
               noperm - 5e-3), every searched permutation re-checked
               against its constraints, and hinm_spmm held on gyro-pruned
               projections (permuted vec_idx).
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
  6. agree   — teacher-forced prefill + 4 paged decode steps with the
               kernels, with the plain versions and with the masked-dense
               twin (torch.matmul): logits must agree.
The line before the last holds the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import copy
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
# kernels vs plain versions through 24 bf16 layers: both round every
# projection output to bf16 but sum in different orders, so logits drift
# by bf16 rounding compounded over depth (relative to max|logit|)
AGREE_TOL = 5e-2
EOS = 151643


def phase(name):
    print(f"\n=== {name} ===", flush=True)


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


def k1_case(label, p, b, gen):
    """Hold K1 against its plain version on packed weight `p` at batch `b`
    (x random, in p's dtype) and time kernel (the variant its dispatch
    picks), plain version, `torch.matmul` on the masked-dense weight and
    the bound."""
    from repro_torch.core import packing
    from repro_torch.kernels import hinm_spmm as hs

    dtype, n_out, n_in, v = p.vals.dtype, p.n_out, p.n_in, p.config.v
    x = torch.randn((b, n_in), generator=gen, device="cuda").to(dtype)
    y = hs.hinm_spmm(x, p)
    torch.cuda.synchronize()
    y_ref = hs.hinm_spmm_ref(x, p)
    torch.cuda.synchronize()
    scale = float(y_ref.float().abs().max())
    err = float((y.float() - y_ref.float()).abs().max())
    rel = err / max(scale, 1e-30)
    w_dense = packing.unpack(p)                       # masked-dense (n_out, n_in)
    ms = time_ms(lambda: hs.hinm_spmm(x, p))
    plain_ms = time_ms(lambda: hs.hinm_spmm_ref(x, p))
    lib_ms = time_ms(lambda: torch.matmul(x, w_dense.T))
    isz = x.element_size()
    nbytes = (x.numel() * isz + p.packed_bytes() + b * n_out * isz)
    ops = 2.0 * p.vals.numel() * b
    b_ms, b_by = bound(nbytes, ops, dtype)
    tol = K1_TOL[dtype]
    variant = hs.variant(b, p, dtype)
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
               idle=None):
    """Randomly allocated paged pool with sentinel pages (unallocated table
    tail) and swept rows (kpos reset to the sentinel, as a rollback leaves).
    `full`: every slot's table allocated and every row live.  `idle`: that
    slot becomes an idle lane — its whole table the sentinel page (whose V
    is random like every page's), its position 0."""
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


def k2_case(label, b, s, window, dtype, seed, n_bt=16, hd=64, full=False, idle=None):
    """Hold K2 against its plain version on a random paged pool (B slots,
    KV 2, G 7, page 16) and time kernel, plain version, SDPA over the
    gathered view, SDPA alone (its inputs gathered and GQA-expanded before
    the timed window) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import paging

    kvh, g, page = 2, 7, 16
    n_pages = b * n_bt + 2
    q, kp, vp, kpos, bt, q_pos = paged_case(b, s, kvh, g, hd, page, n_bt, n_pages, dtype,
                                            seed, full=full, idle=idle)
    out = pa.paged_decode_attn(q, kp, vp, kpos, bt, q_pos, window=window)
    n_splits = pa.paged_decode_attn.last_splits
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
    # and scores only over the slots' allocated pages
    page_rows = torch.unique(bt).numel() * page
    alloc_rows = int((bt != paging.SENTINEL_PAGE).sum()) * page
    nbytes = (2 * q.numel() * isz + page_rows * (2 * kvh * hd * isz + 4)
              + bt.numel() * 4 + q_pos.numel() * 4)
    ops = 4.0 * kvh * s * g * alloc_rows * hd        # q.k and p.v, f32 in-kernel
    b_ms, b_by = bound(nbytes, ops, dtype)
    tol = K2_TOL[dtype]
    line = dict(case=label, B=b, s=s, window=window, KV=kvh, G=g, hd=hd, page=page,
                n_bt=n_bt, dtype=str(dtype).split(".")[-1], n_splits=n_splits,
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
          f"{line['dtype']:8s} splits {n_splits:<3d} err={err:.2e} (tol {tol:.0e}) kernel "
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
    return out


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
    k2 = k2_cases()
    k2_sweep = k2_split_sweep()
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


def k1_verify_layer(gen, ps, dense, b=16):
    """The speculative verify's decode layer: the same seven projections at
    B = slots x (k+1) = 16 rows, bf16, V 32.  The verify runs them on the
    variant decode runs for 4 slots ("rows": its sums do not depend on the
    batch, so row i is bitwise what decode computes; asserted here against
    four B = 4 calls); the dispatch's own choice at B 16 ("mma") is held and
    timed beside it.  Each: checked against the plain version, timed as one
    call of seven launches, with `torch.matmul` and the bound."""
    from repro_torch.kernels import hinm_spmm as hs

    dt = torch.bfloat16
    xs_by_n = {n: torch.randn((b, n), generator=gen, device="cuda").to(dt)
               for n in (896, 4864)}
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
                raise AssertionError("K1 rows at B 16 is not bitwise four B 4 calls")
        print(f"K1 verify layer (7 projections, B={b}, bf16, V=32, {var}): rel_err={rel:.2e} "
              f"(tol {K1_TOL[dt]:.0e}) kernel {ms*1e3:7.1f} us  matmul {lib_ms*1e3:7.1f} us  "
              f"bound {b_ms*1e3:6.2f} us ({b_by})"
              + (f"  plain {line['plain_ms']*1e3:7.1f} us  rows bitwise B4 "
                 f"{line['rows_bit_equal_b4']}" if var == "rows" else ""), flush=True)
        if not rel <= K1_TOL[dt]:
            raise AssertionError(f"K1 verify layer {var}: relative error {rel}")
        out[var] = line
    return out


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
# whose full-width search took up to 10.6 minutes on the H100 (PERF.md);
# width and depth stay full
PRUNE_ITERS = (4, 4)


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

    graph = zoo.perm_graph(cfg).containers[0].graph
    for what, perm in report.out_perms.items():
        validate_out_perm(graph.nodes[what.split("/", 1)[1]], graph, perm, what)
    expected = cfg.n_layers * len(graph.nodes)
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

    n = int((cache["pos"][0] - pos0).max())
    if n > 0:
        zoo.cache_rollback(cfg, cache, None, pos0, torch.zeros_like(pos0), n)


@torch.no_grad()
def spec_bits(cfg, model, cache, tok):
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
    stream to part by)."""
    from repro_torch.models import zoo
    from repro_torch.serve import sampler

    pos0 = zoo.cache_position(cfg, cache)
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
                rewind(cfg, cache, pos0)
            run()
            got.append((dec if fn is decode else ver)[..., : cfg.vocab].clone())
            rewind(cfg, cache, pos0)
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
    if not out["graph_bit_equal"]:
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
    return {"hinm_spmm": k1_n, "paged_decode_attn": k2_n,
            "decode_tok_s": line["decode_tok_s"], "served_p50_step_ms": line["p50_step_ms"],
            "profile": prof, "wall_s": line["wall_s"], "prefill_k1_per_admission": prefill_k1,
            "runs": {mode: ln for mode, (_, ln) in runs.items()}, "twins": twins,
            "mixed": mixed}


# examples/serve_hinm.py's workload (build_workload at its defaults: 10
# requests, 32-token prompts, one arriving per scheduler step)
MIXED_REQUESTS, MIXED_PROMPT = 10, 32


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
    of a decode program (the chunk, the fused spec loop, the unfused
    proposal and verify): their summed device time.  A replay is one host
    call, so its events bracket device work only; the unfused chain's eager
    rollbacks and the prefills are not counted."""

    def __init__(self, sched):
        self.pairs = []
        cache, run = sched.graphs, sched.graphs.run

        def timed(key, body):
            if key[0] == "prefill":
                return run(key, body)
            n = cache.replays
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run(key, body)
            end.record()
            if cache.replays > n:
                self.pairs.append((start, end))
        cache.run = timed
        self._restore = lambda: delattr(cache, "run")

    def stop(self) -> float:
        """Stop timing; the summed device ms of the replays."""
        self._restore()
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in self.pairs))


def serve_run(label, sched, make_requests):
    """Serve `make_requests()` on `sched` three times, reset before each: a
    warm-up run, whose first use of each program runs it eagerly and
    captures it; the graphed run, which replays them; and its eager twin
    under `graphs._eager()`.  Launch counts are set to 0 just before each
    measured run and read just after.  Checks every request ran to its
    budget.  The graphed run's decode programs are timed on the device
    (`DeviceClock`); the eager twin runs the same device work, so both
    runs' idle share is 1 - that device time per decode step / the run's
    wall time per decode step.  Returns {"graphed" | "eager": (requests,
    line)}."""
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.serve import graphs

    g = sched.graphs
    sched.reset()
    sched.run(make_requests())
    warm = g.captures
    runs = {}
    device_ms = None    # the graphed run's; its eager twin does the same device work
    for mode in ("graphed", "eager"):
        sched.reset()
        reqs = make_requests()
        c0, r0, o0 = g.captures, g.replays, sched._overlap_groups
        torch.cuda.synchronize()
        hs.hinm_spmm.launches = 0
        pa.paged_decode_attn.launches = 0
        clock = DeviceClock(sched) if mode == "graphed" else None
        t0 = time.perf_counter()
        with graphs._eager() if mode == "eager" else contextlib.nullcontext():
            sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if mode == "graphed":
            device_ms = clock.stop()
        k1_n, k2_n = hs.hinm_spmm.launches, pa.paged_decode_attn.launches
        st = sched.stats
        for r in reqs:
            if not (r.n_generated == r.params.max_new_tokens
                    or (r.finish_reason == "eos" and r.tokens[-1] == EOS)):
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
                    overlapped_groups=sched._overlap_groups - o0,
                    graphs_captured_warmup=warm, graphs_captured=g.captures - c0,
                    graph_replays=g.replays - r0,
                    mean_step_ms=st.decode_seconds / st.decode_steps * 1e3,
                    device_step_ms=device_ms / st.decode_steps)
        line["idle_share"] = 1 - line["device_step_ms"] / line["mean_step_ms"]
        print(f"{label:19s} {mode:7s}: {len(reqs)} requests in {wall:.2f} s, "
              f"{st.decode_tokens} decode tokens, {st.decode_steps} decode steps "
              f"({st.verify_steps} verify forwards), {line['decode_tok_s']:.1f} decode tok/s, "
              f"p50 step {line['p50_step_ms']:.2f} ms, p50 TTFT {line['p50_ttft_ms']:.1f} ms; "
              + (f"acceptance {st.acceptance_rate:.3f} ({st.draft_accepted}/"
                 f"{st.draft_proposed}), {st.tokens_per_verify_step:.3f} tokens per verify; "
                 if st.verify_steps else "")
              + f"launches hinm_spmm {k1_n}, paged_decode_attn {k2_n}; overlapped admission "
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
        margin, drawn = parting_margin(cfg, model, sched, prompts, a, groups[a.rid], j)
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


@torch.no_grad()
def parting_margin(cfg, model, sched, prompts, req, group, j):
    """The top-2 margin, in logits, of the plain run's draw of token j of
    `req`: its admission group re-prefilled exactly as `Scheduler` did
    (same members, bucket and padded width, so bitwise the same rows), its
    row inserted into a 4-slot pool of the served geometry, then decode
    steps fed its own tokens up to j.  A sampled request's margin is taken
    on its Gumbel-perturbed, top-k-masked scores (its key at index j),
    scaled back by T.  Returns (margin, the token the replay draws)."""
    from repro_torch.models import zoo
    from repro_torch.serve import prng, sampler
    from repro_torch.serve.kv import SlotKVCache

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
    kv = SlotKVCache(cfg, 4, sched.max_seq, page=16, n_pages=None, device="cuda")
    st = kv.template(k_b)
    last = zoo.prefill(model, cfg, torch.from_numpy(toks).cuda(), st,
                       n_rows=torch.from_numpy(n_rows).cuda())
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
    return float(top2.values[0] - top2.values[1]), int(top2.indices[0])


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
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, MIXED_PROMPT).astype(np.int32)
               for _ in range(MIXED_REQUESTS)]
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
    groups0 = admission_groups(plain)
    noise = prefill_width_noise(cfg, model, sched, prompts)
    delta = max(bits["max_abs_dlogit"], noise)
    partings = []
    for label in ("spec fused", "spec unfused"):
        reqs = runs[label]["graphed"][0]
        groups = admission_groups(reqs)
        for a, b in zip(plain, reqs):
            if a.tokens == b.tokens:
                continue
            j = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
            margin, drawn = parting_margin(cfg, model, sched, prompts, a, groups0[a.rid], j)
            ok = (groups[a.rid] != groups0[a.rid] and drawn == a.tokens[j]
                  and margin <= delta)
            partings.append(dict(run=label, rid=a.rid, index=j, margin=margin,
                                 group_plain=groups0[a.rid], group_spec=groups[a.rid],
                                 replay_matches=drawn == a.tokens[j], near_tie=ok))
    same = {label: sum(a.tokens == b.tokens
                       for a, b in zip(plain, runs[label]["graphed"][0]))
            for label in ("spec fused", "spec unfused")}
    print(f"graphed streams equal to the plain run's: fused {same['spec fused']}/{len(plain)}, "
          f"unfused {same['spec unfused']}/{len(plain)} requests; near-tie threshold "
          f"{delta:.3e} (verify vs decode {bits['max_abs_dlogit']:.3e}, prefill width "
          f"{noise:.3e}); {len(partings)} parting point(s)" + "".join(
              f"\n  {p['run']} request {p['rid']} at token {p['index']}: plain-run top-2 "
              f"margin {p['margin']:.3e}, group {p['group_plain']} -> {p['group_spec']}, "
              f"replay draws the plain token {p['replay_matches']}, near tie {p['near_tie']}"
              for p in partings), flush=True)
    bad = [p for p in partings if not p["near_tie"]]
    if bad:
        raise AssertionError(f"speculative streams part from the plain ones beyond the "
                             f"near-tie rule: {bad}")
    return {"runs": {k: {mode: ln for mode, (_, ln) in v.items()} for k, v in runs.items()},
            "identical": same, "near_tie_threshold": delta, "prefill_width_noise": noise,
            "partings": partings, "twins": twins}


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


def compare_logits(what, a, r):
    rel = float((a - r).abs().max()) / float(r.abs().max())
    match = float((a.argmax(-1) == r.argmax(-1)).float().mean())
    print(f"{what}: max |dlogit| / max|logit| = {rel:.2e} (tol {AGREE_TOL:.0e}); "
          f"greedy-token match {match:.3f} over {a.shape[0] * a.shape[1]} positions")
    if not rel <= AGREE_TOL:
        raise AssertionError(f"{what}: logits disagree: {rel} > {AGREE_TOL}")
    return rel, match


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
    gen = torch.Generator(device="cuda").manual_seed(2)
    model, pruned, k1_gyro = prune_phase(cfg, model, gen)
    k3.append(k3_path)
    k1 += k1_gyro

    phase("5. serve")
    served = serve_phase(cfg, model)

    phase("6. agree")
    agree_phase(cfg, model)

    k2_rep = next(c for c in k2 if c["case"] == "s=1 window=0" and c["dtype"] == "bfloat16")
    k2_verify = next(c for c in k2 if c["case"] == "verify s=4" and c["dtype"] == "bfloat16")
    mixed = served["mixed"]["runs"]
    paths = {"greedy": served} | {f"mixed {k}": v["graphed"] for k, v in mixed.items()}
    by_path = {name: {p: paths[p][name] for p in paths}
               for name in ("hinm_spmm", "paged_decode_attn")}
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
             prefill=k1_prefill_layer(k1, served["prefill_k1_per_admission"]),
             **{**layer,
                "max_abs_err": max([layer["max_abs_err"]] + [c["max_abs_err"] for c in k1]),
                "max_rel_err": max([layer["max_rel_err"]] + [c["max_rel_err"] for c in k1])},
             cases=k1),
        dict(name="paged_decode_attn", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn.py:116",
             launches=served["paged_decode_attn"],
             launches_by_path=by_path["paged_decode_attn"],
             verify={k: k2_verify[k] for k in ("s", "n_splits", "ms", "plain_ms", "library_ms",
                                               "sdpa_only_ms", "bound_ms", "bound_by",
                                               "max_abs_err", "rows_bit_equal_s1")},
             max_abs_err=max(c["max_abs_err"] for c in k2),
             timed="one decode step of one layer: B=4, s=1, KV=2, G=7, hd=64, page "
                   "16, n_bt 16 with 1-16 pages allocated per slot at random, bf16",
             **{k: k2_rep[k] for k in ("n_splits", "ms", "plain_ms", "library_ms",
                                       "sdpa_only_ms", "bound_ms", "bound_by")},
             **k2_sweep, cases=k2),
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
    twins = [served["twins"]] + list(served["mixed"]["twins"].values())
    print(f"graphs: graphed streams equal to eager {sum(t['identical'] for t in twins)}/"
          f"{sum(t['requests'] for t in twins)} requests, "
          f"{sum(len(t['partings']) for t in twins)} near-tie parting(s); captured verify "
          f"bitwise the captured decode steps {prof['spec_bits']['graph_bit_equal']}")
    print(f"spec: verify vs decode bit-equal {prof['spec_bits']['bit_equal']}; streams equal "
          f"to plain {served['mixed']['identical']}; {len(served['mixed']['partings'])} "
          f"near-tie parting(s); sampler on CUDA equal to CPU {prng_check['draws_equal']}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
