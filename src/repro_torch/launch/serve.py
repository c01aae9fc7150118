"""Serving CLI of the port: the continuous-batching subset of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arrival bursty \\
      --paged --async-datapath --attn-kernel fused-async
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --arrival bursty --paged --async-datapath --attn-kernel fused-async \\
      --trace t.json

Serves ``--arch`` (default qwen2.5-3b; ``--smoke`` picks its small config)
through ``ModelExecutor``, or the synthetic executor with ``--synthetic``.
Runs on the GPU unless ``--device cpu`` is given. Exits non-zero on a
tiered/flat pin break, on unfinished requests, on a page leak, on a
page-conservation break, or with ``--trace`` on trace totals that diverge
from the pool counters. The batch driver (``--arrival batch``), shards,
chaos and the §12 lifecycle are ported in later slices.
"""

from __future__ import annotations

import argparse

from repro_torch.obs.export import (write_chrome_trace, write_jsonl,
                                    write_request_jsonl)
from repro_torch.paging.tiered_kv import normalize_attn_kernel
from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                        build_executor)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small config instead of its full one")
    ap.add_argument("--arrival", choices=("constant", "bursty", "churn"),
                    default="bursty",
                    help="request arrival process of the continuous engine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent serving slots (tiered streams)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens consumed per engine step per slot")
    ap.add_argument("--chunk", type=int, default=4,
                    help="context pages demanded per sweep step")
    ap.add_argument("--ring-size", type=int, default=8,
                    help="in-flight ring capacity for --async-datapath")
    ap.add_argument("--length-jitter", type=float, default=0.0)
    ap.add_argument("--link-budget", type=int, default=None,
                    help="pages/step the shared link moves across all "
                         "streams' prefetches (demand first)")
    ap.add_argument("--paged", action="store_true",
                    help="accepted for the reference's spelling: the engine "
                         "always serves through the tiered paged-KV path")
    ap.add_argument("--async-datapath", action="store_true",
                    help="sweep through the issue/wait in-flight ring")
    ap.add_argument("--attn-kernel", default="ref",
                    choices=("ref", "kernel", "fused", "fused-async"),
                    help="decode-attention consumer (fused / fused-async "
                         "read the hot slots in place through the hot-slot "
                         "kernel; fused-async double-buffers its page "
                         "tiles with cp.async)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the page-lifecycle and request events as a "
                         "Chrome trace (Perfetto-loadable) plus .jsonl and "
                         ".requests.jsonl siblings")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic executor (hashed K/V, no model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    scfg = ServeConfig(
        requests=args.requests, slots=args.slots,
        prompt_len=args.prompt_len, gen=args.gen,
        length_jitter=args.length_jitter, page_size=args.page_size,
        prefill_chunk=args.prefill_chunk, chunk=args.chunk,
        ring_size=args.ring_size, async_datapath=args.async_datapath,
        link_budget=args.link_budget,
        attn_kernel=normalize_attn_kernel(args.attn_kernel),
        arrival=args.arrival, seed=args.seed, trace=bool(args.trace))
    executor = build_executor(None if args.synthetic else args.arch,
                              smoke=args.smoke, seed=args.seed,
                              device=args.device)
    engine = ServingEngine(scfg, executor, device=args.device)
    result = engine.run()
    if args.trace:
        write_chrome_trace(args.trace, engine.events,
                           request_phases=engine.phases)
        write_jsonl(args.trace + ".jsonl", engine.events)
        write_request_jsonl(args.trace + ".requests.jsonl", engine.phases)
        result["trace_path"] = args.trace
    if not result["tiered_equiv_ok"]:
        print(result)
        raise SystemExit("tiered/flat decode attention mismatch under "
                         "continuous batching (first bad step "
                         f"{result.get('tiered_first_bad_step')})")
    if result["requests_finished"] != args.requests:
        print(result)
        raise SystemExit(f"{result['requests_finished']}/{args.requests} "
                         "requests finished")
    if result["alloc_in_use_end"] != 0:
        print(result)
        raise SystemExit(f"page leak: {result['alloc_in_use_end']} pages "
                         "still allocated after drain")
    if result["pages_allocated"] != result["pages_recycled"]:
        print(result)
        raise SystemExit("page conservation violated: "
                         f"{result['pages_allocated']} allocated vs "
                         f"{result['pages_recycled']} recycled")
    if args.trace and not result["trace_totals_ok"]:
        print(result)
        raise SystemExit("trace event totals diverge from pool counters")
    print(result)
    return result


if __name__ == "__main__":
    main()
