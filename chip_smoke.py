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
               never calls it) and the bound.
  4. prune   — full-width qwen2-0.5b (24 layers, bf16, random weights from
               seed 0): `ops.nm_apply` over its 24 down projections (the
               nm_select path, launch count asserted); `prune_model`
               gyro-permutation (OCP + ICP, PRUNE_ITERS iterations) on the
               card, then noperm: wall times, mean retained saliency (gyro >=
               noperm - 5e-3), every searched permutation re-checked
               against its constraints, and hinm_spmm held on gyro-pruned
               projections (permuted vec_idx).
  5. serve   — the gyro-pruned, packed model served by `Scheduler` over the
               paged KV pool: 8 greedy requests, launch counts asserted;
               then one decode step profiled on a live 4-slot pool (host vs
               device time, and the kernels' share of the device step).
  6. agree   — teacher-forced prefill + 4 paged decode steps with the
               kernels, with the plain versions and with the masked-dense
               twin (torch.matmul): logits must agree.
The line before the last holds the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.
"""
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
    print(f"K2 {label:18s} B={b:<3d} s={s} window={window:<3d} n_bt={n_bt:<4d} hd={hd:<3d} "
          f"{line['dtype']:8s} splits {n_splits:<3d} err={err:.2e} (tol {tol:.0e}) kernel "
          f"{ms*1e3:7.1f} us  plain {plain_ms*1e3:8.1f} us  sdpa(view) {lib_ms*1e3:7.1f} us  "
          f"sdpa alone {only_ms*1e3:7.1f} us  bound {b_ms*1e3:6.2f} us ({b_by})", flush=True)
    if not err <= tol:
        raise AssertionError(f"K2 {label} s={s} window={window} n_bt={n_bt} {dtype}: "
                             f"error {err} > {tol}")
    return line


def k2_cases():
    """Every K2 case: s 1/3 x window 0/64 x bf16/f32 at the served shape
    (B 4, n_bt 16, 1-16 pages allocated per slot at random); an idle lane
    (one slot's table all sentinel, position 0) in both dtypes; the context
    sweep (n_bt 16/64/256, every table full); one split (the direct-output
    path: B * KV over one wave, 4 entries); a head dim whose rows are not
    16-byte aligned (the scalar path) in both dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    out, seed = [], 0
    for dtype in (bf16, f32):
        for s in (1, 3):
            for window in (0, 64):
                out.append(k2_case(f"s={s} window={window}", 4, s, window, dtype, seed))
                seed += 1
    for dtype in (bf16, f32):
        out.append(k2_case("idle lane", 4, 1, 0, dtype, seed, idle=1))
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
    layer, crossover = k1_layer(gen)
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
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by), crossover


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


def graph_of(fn) -> torch.cuda.CUDAGraph:
    """`fn` captured once as a CUDA graph (warmed up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


@torch.no_grad()
def step_profile(cfg, model, kv):
    """Where a decode step's time goes, on a live pool: the PROFILE_LENS
    prompts prefilled into the served `SlotKVCache`, then greedy decode
    steps (`decode_step`, argmax fed back) that advance the pool in place
    as served steps do (each slot reserves rows for every step run here):
    wall_ms / host_ms — one step on the host clock, over two chunks of 8
                steps with one sync each, as the scheduler runs them:
                wall includes the sync, host only the enqueueing;
    device_ms — device time of one step, captured once as a CUDA graph and
                replayed (no host gaps between its kernels);
    k1_ms / k2_ms — device time of that step's 7 x L hinm_spmm and L
                paged_decode_attn launches alone, captured as graphs on the
                same weights and pool;
    k*_host_us — host cost of one kernel-wrapper call at decode shapes."""
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.models import zoo
    from repro_torch.serve import sampler

    b, chunk = len(PROFILE_LENS), 8
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
        kv.insert(slot, stripe, n, row=row, reserve=n + 48)
    cache = kv.cache

    def step():
        logits = zoo.decode_step(model, cfg, tok, cache)
        tok.copy_(sampler.greedy(logits[:, : cfg.vocab].float())[:, None])

    walls, hosts = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        hosts.append((t1 - t0) / chunk * 1e3)
        walls.append((time.perf_counter() - t0) / chunk * 1e3)
    device_ms = time_ms(graph_of(step).replay)

    blk0 = model.blocks[0]
    x_d = torch.zeros((b, blk0.attn.wq.w.n_in), dtype=cfg.dtype, device="cuda")
    x_f = torch.zeros((b, blk0.mlp.wd.w.n_in), dtype=cfg.dtype, device="cuda")
    q = torch.zeros((b, 1, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda")
    qpos = cache["pos"][0][:, None].clone()

    def k1_step():
        for blk in model.blocks:
            a, m = blk.attn, blk.mlp
            for lin in (a.wq, a.wk, a.wv, a.wo, m.wg, m.wu):
                hs.hinm_spmm(x_d, lin.w)
            hs.hinm_spmm(x_f, m.wd.w)

    def k2_step():
        for i in range(cfg.n_layers):
            pa.paged_decode_attn(q, cache["k"][i], cache["v"][i], cache["kpos"][i],
                                 cache["bt"][i], qpos)

    k1_ms = time_ms(graph_of(k1_step).replay)
    k2_ms = time_ms(graph_of(k2_step).replay)

    def host_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return out

    out = {"wall_ms": float(np.mean(walls)), "host_ms": float(np.mean(hosts)),
           "device_ms": device_ms, "k1_ms": k1_ms, "k2_ms": k2_ms,
           "k1_host_us": host_us(lambda: hs.hinm_spmm(x_d, blk0.mlp.wg.w)),
           "k2_host_us": host_us(lambda: pa.paged_decode_attn(
               q, cache["k"][0], cache["v"][0], cache["kpos"][0], cache["bt"][0], qpos))}
    for slot in slots:
        kv.release(slot)
    return out


def serve_phase(cfg, model):
    from repro_torch.kernels import hinm_spmm as hs
    from repro_torch.kernels import paged_attn as pa
    from repro_torch.serve import Request, SamplingParams, Scheduler

    t0 = time.perf_counter()
    # `model` arrives gyro-pruned and packed by the prune phase
    sched = Scheduler(cfg, model, max_slots=4, max_seq=256, page=16, decode_chunk=8)
    torch.cuda.synchronize()
    print(f"Scheduler built in {time.perf_counter() - t0:.1f} s on the gyro-pruned, "
          f"packed model")
    pb, db = sched.stats.packed_param_bytes, sched.stats.dense_param_bytes
    print(f"weights: {pb / 1e6:.1f} MB packed vs {db / 1e6:.1f} MB dense-equivalent; "
          f"KV pool {sched.kv.pool_bytes() / 1e6:.1f} MB ({sched.kv.n_pages} pages)")
    rng = np.random.default_rng(0)
    # warm-up request (CUDA context, cuBLAS handle, kernel module loads)
    sched.run([Request(rid=99, prompt=rng.integers(0, cfg.vocab, 16).astype(np.int32),
                       params=SamplingParams(max_new_tokens=4))])
    sched.reset()
    lens = [16, 24, 40, 64, 96, 128, 33, 80]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    params=SamplingParams(max_new_tokens=32), arrival=i)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    hs.hinm_spmm.launches = 0
    pa.paged_decode_attn.launches = 0
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_n, k2_n = hs.hinm_spmm.launches, pa.paged_decode_attn.launches
    st = sched.stats
    for r in reqs:
        print(f"req {r.rid}: prompt {len(r.prompt):4d} -> {r.n_generated:3d} tokens "
              f"({r.finish_reason})  TTFT {r.ttft * 1e3:8.1f} ms  "
              f"{r.tokens_per_second:7.1f} tok/s")
        if not (r.n_generated == 32 or (r.finish_reason == "eos" and r.tokens[-1] == EOS)):
            raise AssertionError(f"request {r.rid}: {r.n_generated} tokens, "
                                 f"finish {r.finish_reason}")
    steps = st.decode_steps
    print(f"served {len(reqs)} requests in {wall:.2f} s: {st.decode_tokens} decode "
          f"tokens over {steps} decode steps, {st.decode_tokens_per_second:.1f} decode "
          f"tok/s, p50 step {st.step_time_percentile(50) * 1e3:.2f} ms, p50 TTFT "
          f"{st.ttft_percentile(50) * 1e3:.1f} ms, packed-weight bytes per decode "
          f"token {st.weight_bytes_per_token / 1e6:.1f} MB")
    print(f"launches: hinm_spmm {k1_n} ({k1_n / max(steps, 1):.1f}/decode step), "
          f"paged_decode_attn {k2_n} ({k2_n / max(steps, 1):.1f}/decode step)")
    per_step_k1 = 7 * cfg.n_layers
    if steps == 0 or k1_n < per_step_k1 * steps or k2_n < cfg.n_layers * steps:
        raise AssertionError(f"the main path skipped a kernel: {k1_n} hinm_spmm and "
                             f"{k2_n} paged_decode_attn launches for {steps} steps")
    served_ms = st.step_time_percentile(50) * 1e3
    prof = step_profile(cfg, model, sched.kv)
    dev, w = prof["device_ms"], prof["wall_ms"]
    print(f"step profile, live pool of {len(PROFILE_LENS)} slots (prompts "
          f"{'/'.join(map(str, PROFILE_LENS))}, decoding): wall {w:.2f} ms per step "
          f"(host enqueue {prof['host_ms']:.2f} ms); device {dev:.3f} ms (one step "
          f"replayed as a CUDA graph) -> device idle {1 - dev / w:.1%} of the wall step; "
          f"of the device step: hinm_spmm x{per_step_k1} {prof['k1_ms']:.3f} ms "
          f"({prof['k1_ms'] / dev:.1%}), paged_decode_attn x{cfg.n_layers} "
          f"{prof['k2_ms']:.3f} ms ({prof['k2_ms'] / dev:.1%}), rest "
          f"{dev - prof['k1_ms'] - prof['k2_ms']:.3f} ms; wrapper host cost per "
          f"launch: hinm_spmm {prof['k1_host_us']:.1f} us, paged_decode_attn "
          f"{prof['k2_host_us']:.1f} us")
    return {"hinm_spmm": k1_n, "paged_decode_attn": k2_n,
            "decode_tok_s": st.decode_tokens_per_second, "served_p50_step_ms": served_ms,
            "profile": prof, "wall_s": wall}


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
    kernels = [
        dict(name="hinm_spmm", route="cuda", source="src/repro_torch/csrc/hinm_spmm.cu",
             replaces="src/repro/kernels/hinm_spmm.py:99", launches=served["hinm_spmm"],
             timed="one call of one decode layer's 7 projections (q,k,v,o,gate,up,"
                   "down), B=4, bf16, V=32 (variant rows)",
             crossover={"rows_max_b": K1_CROSSOVER, "layer_ms_by_B": crossover},
             **{**layer,
                "max_abs_err": max([layer["max_abs_err"]] + [c["max_abs_err"] for c in k1]),
                "max_rel_err": max([layer["max_rel_err"]] + [c["max_rel_err"] for c in k1])},
             cases=k1),
        dict(name="paged_decode_attn", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn.py:116",
             launches=served["paged_decode_attn"],
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
    print(f"serve: {served['decode_tok_s']:.1f} decode tok/s, p50 decode step "
          f"{served['served_p50_step_ms']:.2f} ms; live-pool step: wall "
          f"{prof['wall_ms']:.2f} ms, host enqueue {prof['host_ms']:.2f} ms, device "
          f"{prof['device_ms']:.3f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
