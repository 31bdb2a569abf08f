"""Offload-split tuning — the paper's Table 5 experiment as a tool.

Sweeps the weight-offload fraction for a target deployment, reports the
throughput curve and the optimum, and shows the beyond-paper overlap win.
The port of the reference's ``examples/offload_tuning.py``: pure cost
model, no device, the same output.

    python -m repro_torch.examples.offload_tuning \\
        --model-gib 130 --hbm-gib 72 --link-gbs 25
"""

import argparse

from repro_torch.core.costmodel import offload_sweep, optimal_offload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-gib", type=float, default=130)
    ap.add_argument("--hbm-gib", type=float, default=72)
    ap.add_argument("--link-gbs", type=float, default=25)
    ap.add_argument("--kv-mib-per-seq", type=float, default=200)
    ap.add_argument("--flops-per-token", type=float, default=2 * 70e9)
    ap.add_argument("--peak-tflops", type=float, default=900)
    ap.add_argument("--max-concurrency", type=int, default=150)
    args = ap.parse_args(argv)

    kw = dict(model_bytes=int(args.model_gib * 2**30),
              hbm_capacity=int(args.hbm_gib * 2**30),
              link_bw=int(args.link_gbs * 2**30),
              kv_bytes_per_seq=int(args.kv_mib_per_seq * 2**20),
              flops_per_token=args.flops_per_token,
              peak_flops=args.peak_tflops * 1e12, hbm_bw=3 << 40,
              max_concurrency=args.max_concurrency)

    print(f"{'offload GiB':>12} {'batch':>6} {'tok/s':>9} {'bound':>9}   "
          f"{'tok/s (overlap)':>15}")
    for p, po in zip(offload_sweep(**kw, n_points=12),
                     offload_sweep(**kw, n_points=12, overlap=1.0)):
        print(f"{p.offload_bytes/2**30:12.1f} {p.max_batch:6d} "
              f"{p.tokens_per_s:9.1f} {p.bound:>9}   {po.tokens_per_s:15.1f}")

    best = optimal_offload(**kw)
    best_o = optimal_offload(**kw, overlap=1.0)
    print(f"\npaper-faithful optimum: {best.offload_bytes/2**30:.1f} GiB "
          f"-> {best.tokens_per_s:.1f} tok/s")
    print(f"beyond-paper (double-buffered streaming): "
          f"{best_o.offload_bytes/2**30:.1f} GiB -> "
          f"{best_o.tokens_per_s:.1f} tok/s "
          f"(+{(best_o.tokens_per_s/best.tokens_per_s-1)*100:.0f}%)")
    return {"best": best, "best_overlap": best_o}


if __name__ == "__main__":
    main()
