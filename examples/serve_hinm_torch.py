"""Serve a HiNM-pruned model under a staggered-arrival workload, on the
PyTorch/CUDA port (`src/repro_torch`): the port's twin of
`examples/serve_hinm.py`, with the same flags, workload and report.

  python examples/serve_hinm_torch.py                   # on the GPU
  python examples/serve_hinm_torch.py --device cpu      # plain PyTorch path

Builds the reduced qwen2-0.5b with the port's seeded init on `--device`,
prunes it one-shot with gyro-permutation (`prune_model`), packs it, and
drives the continuous-batching scheduler with requests that arrive over
time with mixed lengths and sampling parameters.  Reports per-request
TTFT / tokens/s / weight-bytes-per-token plus aggregate throughput, and
compares against the static-batching policy on the same workload.  The
speculative rerun (n-gram, `--spec-k`) must reproduce every stream;
`--compare-dense` also serves the masked-dense model and checks that its
greedy outputs are token-identical.  The weights come from torch's
generator, so the tokens are not the JAX example's: parity with the
reference lives in the tests, on converted weights.

Prefix sharing: `--shared-prefix N` prepends one N-token system prompt to
every request (full pages of it are mapped into later slots, copy-on-write
for a divergent tail); `--prefill-chunk C` splits each admission's
unshared suffix into C-row chunks interleaved with decode steps.

Observability: `--metrics-json PATH` serves with telemetry on and writes
the metrics-registry snapshot (kernel dispatch decisions included) as
JSON; `--trace-out PATH` writes the request-lifecycle spans as Chrome
trace-event JSON (open it at https://ui.perfetto.dev).

Flight recorder: `--record OUT.jsonl` captures every scheduler decision as
a JSON-lines record; `--replay IN.jsonl` rebuilds the workload from such a
record and re-drives a fresh scheduler, asserting event-for-event and
token-for-token identity.  Run it with the same flags the record was
captured with: a mismatched configuration is named as the first diverging
event.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch


def build_workload(cfg, n_requests, prompt_len, rng, shared_prefix=0):
    from repro_torch.serve import Request, SamplingParams

    system = rng.integers(0, cfg.vocab, (shared_prefix,)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        params = SamplingParams(
            max_new_tokens=24 if i % 3 == 0 else 8,
            temperature=0.8 if i % 4 == 3 else 0.0,   # mix greedy + sampled
            top_k=16 if i % 4 == 3 else 0,
        )
        tail = rng.integers(0, cfg.vocab, (prompt_len,)).astype(np.int32)
        reqs.append(Request(
            rid=i,
            prompt=np.concatenate([system, tail]) if shared_prefix else tail,
            params=params,
            arrival=i,  # one new request per scheduler step
        ))
    return reqs


def main():
    from repro_torch.configs.base import load_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import zoo
    from repro_torch.serve import Scheduler
    from repro_torch.train import pruning

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and serves (cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--page", type=int, default=16,
                    help="KV pool page size (full pages of a shared prefix "
                         "are what the prefix cache can map)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend one N-token system prompt to every "
                         "request; full pages of it serve from the prefix "
                         "cache instead of recomputing prefill")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="split admission prefill into C-row chunks "
                         "interleaved with decode steps")
    ap.add_argument("--compare-dense", action="store_true")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per verify for the speculative rerun "
                         "(0 disables the comparison)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="serve with telemetry on and dump the metrics "
                         "registry snapshot (JSON) here")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="serve with telemetry on and dump the Chrome "
                         "trace-event JSON here (open in Perfetto)")
    ap.add_argument("--record", default=None, metavar="OUT.jsonl",
                    help="serve with the flight recorder on and dump the "
                         "decision record here (JSON lines)")
    ap.add_argument("--replay", default=None, metavar="IN.jsonl",
                    help="rebuild the workload from a recorded run and "
                         "re-drive it, asserting event- and token-identical "
                         "behaviour (use the same scheduler flags)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = load_arch("qwen2_0_5b").reduced(n_layers=4, d_model=256, n_heads=4,
                                          n_kv_heads=2, d_ff=512, vocab=2048,
                                          head_dim=64, max_seq=256)
    model = zoo.init(cfg, device=device)
    print(f"pruning with gyro-permutation on {device}...")
    newp, masks, packed, report = pruning.prune_model(
        model, cfg, method="gyro", ocp_iters=4, icp_iters=4)
    print(f"mean retained saliency: {report.mean_retained:.4f} "
          f"at {cfg.hinm.total_sparsity:.0%} sparsity")

    max_seq = args.shared_prefix + args.prompt_len + 32
    geom = dict(max_slots=args.slots, max_seq=max_seq, decode_chunk=args.decode_chunk,
                device=device)
    rng = np.random.default_rng(0)
    workload = build_workload(cfg, args.requests, args.prompt_len, rng,
                              shared_prefix=args.shared_prefix)

    telemetry = None
    if args.metrics_json or args.trace_out:
        from repro_torch.serve import Telemetry

        telemetry = Telemetry(enabled=True)
    sched = Scheduler(cfg, packed, telemetry=telemetry, page=args.page,
                      prefill_chunk=args.prefill_chunk,
                      flightrec=bool(args.record or args.replay), **geom)

    if args.replay:
        from repro_torch.serve import replay as replay_record

        rep = replay_record(args.replay, sched)
        print(rep.render())
        rep.assert_equal()
        print("replay OK: event- and token-identical with the record")
        return

    done = sched.run(workload)
    st = sched.stats
    pb = st.packed_param_bytes

    print(f"\n{'rid':>3} {'new':>4} {'temp':>5} {'ttft_ms':>8} {'tok/s':>7} "
          f"{'kB/tok':>7}  reason")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"{r.rid:>3} {r.n_generated:>4} {r.params.temperature:>5.2f} "
              f"{r.ttft * 1e3:>8.1f} {r.tokens_per_second:>7.1f} "
              f"{r.weight_bytes_per_token(pb) / 1e3:>7.1f}  {r.finish_reason}")

    print(f"\ncontinuous: {st.tokens_generated} tokens, "
          f"{st.decode_tokens_per_second:.1f} tok/s decode, "
          f"{st.decode_steps} batched steps, "
          f"{st.finished_at_eos} finished at EOS")
    print(f"weight bytes: packed/dense = {st.weight_bytes_ratio:.3f} "
          f"(~{1 / st.weight_bytes_ratio:.1f}x less HBM traffic per read)")
    print(f"latency: p50 ttft {1e3 * st.ttft_percentile(50):.1f}ms, "
          f"p99 ttft {1e3 * st.ttft_percentile(99):.1f}ms, "
          f"p99 decode step {1e6 * st.step_time_percentile(99):.0f}us")

    if sched.prefix is not None:
        print(f"prefix cache: {st.prefix_hit_tokens} prompt rows served "
              f"from cache ({st.prefix_hit_rate:.1%} hit rate), "
              f"{sched.kv.cow_copies} copy-on-write pages, "
              f"{int(sched.kv.n_shared_pages)} pages shared now, "
              f"{sched.prefix.evictions} evicted under pressure")
        if args.prefill_chunk:
            print(f"chunked prefill: {st.prefill_chunks} chunks over "
                  f"{st.prefill_rows} unshared prompt rows")

    if telemetry is not None:
        if args.metrics_json:
            telemetry.dump_metrics(args.metrics_json)
            print(f"metrics snapshot -> {args.metrics_json}")
        if args.trace_out:
            telemetry.dump_trace(args.trace_out)
            print(f"chrome trace -> {args.trace_out} "
                  f"(open at https://ui.perfetto.dev)")

    if args.record:
        sched.flight.dump(args.record)
        print(f"flight record -> {args.record} "
              f"({len(sched.flight)} events; replay with --replay)")

    static = Scheduler(cfg, packed, policy="static", **geom)
    static.run(build_workload(cfg, args.requests, args.prompt_len,
                              np.random.default_rng(0),
                              shared_prefix=args.shared_prefix))
    print(f"static baseline: {static.stats.decode_steps} batched steps "
          f"(continuous saved "
          f"{static.stats.decode_steps - st.decode_steps} full-batch steps)")

    if args.spec_k:
        from repro_torch.serve import SpecConfig

        spec = Scheduler(cfg, packed, page=args.page, prefill_chunk=args.prefill_chunk,
                         spec=SpecConfig(k=args.spec_k), **geom)
        spec_reqs = build_workload(cfg, args.requests, args.prompt_len,
                                   np.random.default_rng(0),
                                   shared_prefix=args.shared_prefix)
        spec.run(spec_reqs)
        ss = spec.stats
        by_rid = {r.rid: r for r in spec_reqs}
        same = all(r.tokens == by_rid[r.rid].tokens for r in done)
        print(f"\nspeculative (n-gram, k={args.spec_k}): "
              f"tokens identical: {same}; "
              f"acceptance {ss.acceptance_rate:.3f}, "
              f"{ss.tokens_per_verify_step:.2f} tok/verify, "
              f"bytes/tok {ss.weight_bytes_per_accepted_token / 1e3:.1f}kB "
              f"vs {st.weight_bytes_per_token / 1e3:.1f}kB chunked")
        if not same:  # greedy + "match" sampled requests reproduce the stream
            raise SystemExit("speculative streams differ from the plain run's")

    if args.compare_dense:
        masked = pruning.apply_masks(newp, masks)
        greedy = [r for r in workload if r.params.temperature <= 0.0]
        dense = Scheduler(cfg, masked, page=args.page, prefill_chunk=args.prefill_chunk,
                          **geom)
        dense_reqs = build_workload(cfg, args.requests, args.prompt_len,
                                    np.random.default_rng(0),
                                    shared_prefix=args.shared_prefix)
        dense.run(dense_reqs)
        by_rid = {r.rid: r for r in dense_reqs}
        same = all(r.tokens == by_rid[r.rid].tokens for r in greedy)
        print(f"packed vs masked-dense greedy outputs identical: {same}")
        if not same:
            raise SystemExit("packed and masked-dense greedy outputs differ")

    if device.type == "cuda":
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
