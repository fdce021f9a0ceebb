"""The dry run's records of two PyTorch versions side by side, cell by cell.

``python -m repro_torch.launch.dryrun`` writes one record per (arch, shape,
mesh) to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>__torch<X.Y>.json``;
DTensor's strategies differ between versions, so a layout judged under one
may count other collectives under another.  For every cell recorded under
``--a`` this prints whether its record under ``--b`` (in ``--b-dir``, default
the same directory) has the same status, per-device argument bytes (which
depend on the specs only) and FLOPs, and each record's peak bytes a device,
collective bytes by kind and dominant roofline term:

    python scripts/dryrun_compare_torch.py --a torch2.11 --b torch2.13
    python scripts/dryrun_compare_torch.py --a torch2.13 --b torch2.13 \\
        --b-dir experiments/dryrun_torch/before

Host-side; reads records only.  Prints one line per cell and a JSON summary
last.
"""
import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RECORDS = ROOT / "experiments" / "dryrun_torch"


def _coll(rec):
    return {k: v["bytes"] for k, v in sorted(rec.get("collectives",
                                                     {}).items())}


def compare(a_dir: Path, a_tag: str, b_dir: Path, b_tag: str) -> list:
    rows = []
    for pa in sorted(a_dir.glob(f"*__{a_tag}.json")):
        cell = pa.name[:-len(f"__{a_tag}.json")]
        pb = b_dir / f"{cell}__{b_tag}.json"
        a = json.loads(pa.read_text())
        b = json.loads(pb.read_text()) if pb.exists() else None
        row = {"cell": cell, "a_status": a["status"],
               "b_status": b["status"] if b else None}
        if a["status"] == "ok" and b and b["status"] == "ok":
            ma, mb = a["memory"], b["memory"]
            ra, rb = a["roofline"], b["roofline"]
            row.update(
                argument_bytes_equal=(ma["argument_bytes"]
                                      == mb["argument_bytes"]),
                argument_bytes=ma["argument_bytes"],
                flops_equal=ra["flops_per_device"] == rb["flops_per_device"],
                flops=[ra["flops_per_device"], rb["flops_per_device"]],
                peak_bytes=[ma["peak_bytes_per_device"],
                            mb["peak_bytes_per_device"]],
                collective_bytes=[_coll(a), _coll(b)],
                dominant=[ra["dominant"], rb["dominant"]],
                host_s=[a["step_s"], b["step_s"]])
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="torch tag, e.g. torch2.11")
    ap.add_argument("--b", required=True, help="torch tag, e.g. torch2.13")
    ap.add_argument("--a-dir", type=Path, default=RECORDS)
    ap.add_argument("--b-dir", type=Path, default=RECORDS)
    args = ap.parse_args(argv)
    rows = compare(args.a_dir, args.a, args.b_dir, args.b)
    for r in rows:
        if "flops" not in r:
            print(f"{r['cell']}: status {r['a_status']} / {r['b_status']}")
            continue
        print(f"{r['cell']}: args {'=' if r['argument_bytes_equal'] else '!='}"
              f" ({r['argument_bytes']}), flops "
              f"{'=' if r['flops_equal'] else '!='} {r['flops']}, peak "
              f"{r['peak_bytes']}, collectives {r['collective_bytes']}, "
              f"dominant {r['dominant']}, host s {r['host_s']}")
    ok = [r for r in rows if "flops" in r]
    print(json.dumps({
        "a": args.a, "b": args.b, "cells": len(rows), "both_ok": len(ok),
        "argument_bytes_equal": sum(r["argument_bytes_equal"] for r in ok),
        "flops_equal": sum(r["flops_equal"] for r in ok),
        "peak_equal": sum(r["peak_bytes"][0] == r["peak_bytes"][1]
                          for r in ok),
        "collectives_equal": sum(r["collective_bytes"][0]
                                 == r["collective_bytes"][1] for r in ok)}))


if __name__ == "__main__":
    main()
