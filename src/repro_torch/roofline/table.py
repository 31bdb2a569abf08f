"""The dry-run's records as the reference's two tables (markdown).

The port of the reference's ``benchmarks/roofline_table.py``: per mesh, a
dry-run table (status, trace seconds in the reference's "compile s"
column, the walker's per-chip FLOPs, bytes and collective bytes, the
placement's offloaded groups) and a roofline table (the terms against the
reference's v5e constants, the bottleneck, MODEL/walker FLOPs, the
roofline fraction, the per-chip temporaries at the walker's peak).

It reads ``build/dryrun/<arch>_<shape>_<mesh>.json``, the records of
``python -m repro_torch.launch.dryrun`` without ``--tag``.

Usage:
  python -m repro_torch.roofline.table [--mesh 16x16] [--dir build/dryrun]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DRYRUN_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def fmt_time(t: float) -> str:
    if t >= 1:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t*1e3:.1f}ms"
    return f"{t*1e6:.0f}us"


def load(mesh: str, directory: Path = DRYRUN_DIR) -> list[dict]:
    """The untagged records of ``mesh``, by arch and the reference's shape
    order."""
    recs = []
    for f in sorted(Path(directory).glob("*.json")):
        r = json.loads(f.read_text())
        if (r.get("mesh") == mesh and r.get("shape") in ORDER
                and f.stem == f"{r['arch']}_{r['shape']}_{mesh}"):
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], ORDER.index(r["shape"])))
    return recs


def table(mesh: str, directory: Path = DRYRUN_DIR) -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck | "
            "MODEL/HLO | roofline frac | HBM temp/chip | note |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(mesh, directory):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | - | {r['status']} |")
            continue
        rf = r["roofline"]
        temp = r["memory_analysis"].get("temp_size_in_bytes", 0) / 2**30
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_time(rf['t_compute'])} | "
            f"{fmt_time(rf['t_memory'])} | {fmt_time(rf['t_collective'])} | "
            f"{rf['bottleneck']} | {rf['flops_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.3f} | {temp:.1f}GiB | "
            f"{rf.get('note', '')} |")
    return "\n".join(rows)


def dryrun_table(mesh: str, directory: Path = DRYRUN_DIR) -> str:
    rows = ["| arch | shape | status | trace s | HLO GFLOPs/chip | "
            "HLO GiB/chip | coll GiB/chip | placement |",
            "|---|---|---|---|---|---|---|---|"]
    for r in load(mesh, directory):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['status']} | - | "
                        f"- | - | - | - |")
            continue
        w = r["hlo_walk"]
        kinds = r.get("placement", {}).get("kinds", {})
        off = ",".join(k for k, v in kinds.items() if v != "device") or "none"
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['lower_s']} | "
            f"{w['flops']/1e9:.1f} | {w['bytes']/2**30:.1f} | "
            f"{w['collective_bytes']/2**30:.2f} | offload:{off} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dir", default=str(DRYRUN_DIR),
                    help="the directory of the dry-run's records")
    args = ap.parse_args(argv)
    meshes = [args.mesh] if args.mesh else ["16x16", "2x16x16"]
    for m in meshes:
        print(f"\n### Dry-run — mesh {m}\n")
        print(dryrun_table(m, Path(args.dir)))
        print(f"\n### Roofline — mesh {m}\n")
        print(table(m, Path(args.dir)))


if __name__ == "__main__":
    main()
