"""Render the §Dry-run + §Roofline tables from results/dryrun.

Port of `repro/launch/report.py`: plain JSON in, markdown rows out. The
port's cells differ in two ways that the rows show: a value the dry run
did not measure (`temp_bytes_per_device`, hence a peak that counts
arguments and outputs only; a record-only cell's collective term) is
null in the JSON and renders as "-", and each row ends with the cell's
`scope` ("global" for a record-only cell, "rank 0" for a routed one).
A routed cell has no roofline (its rank-0 counts describe no one chip)
and is counted under "not shown" as `rank-0-scope`. A cell JSON from the
reference has no scope and renders as the reference's rows do.

  PYTHONPATH=src python -m repro_torch.launch.report --out results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(out: str) -> Dict[str, dict]:
    cells = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        # observability sidecars live next to the cells; they are not cells
        if path.endswith((".run_report.json", ".trace.json")):
            continue
        with open(path) as f:
            r = json.load(f)
        key = f"{r.get('arch')}|{r.get('shape')}|{'mp' if r.get('multi_pod') else 'sp'}"
        cells[key] = r
    return cells


def fmt_bytes(n) -> str:
    return "-" if n is None else f"{n/1e9:.2f}"


def fmt_s(x) -> str:
    return "-" if x is None else f"{x:.3f}"


def _scope(r: dict) -> str:
    """' [scope]' appended to a port cell's row; '' for a reference cell."""
    return f" [{r['scope']}]" if r.get("scope") else ""


def dryrun_table(cells: Dict[str, dict]) -> List[str]:
    rows = ["| arch | shape | mesh | compile | peak GB/dev | collectives |",
            "|---|---|---|---|---|---|"]
    for key in sorted(cells):
        r = cells[key]
        arch, shape, m = key.split("|")
        mesh = "2x16x16" if m == "mp" else "16x16"
        if r.get("status") != "ok":
            rows.append(f"| {arch} | {shape} | {mesh} | FAIL | - | "
                        f"{str(r.get('error'))[:60]} |")
            continue
        f = r["full"]
        rows.append(
            f"| {arch} | {shape} | {mesh} | ok ({f['compile_s']:.0f}s) | "
            f"{fmt_bytes(f['peak_bytes_per_device'])} | "
            f"{f['collectives'][:70]} |{_scope(r)}")
    return rows


def roofline_table(cells: Dict[str, dict]) -> List[str]:
    """Single-pod roofline rows + an explicit tally of every cell left out.

    A skipped cell used to vanish without a trace, so a failed or
    roofline-less run silently shrank the table; now the reasons are
    counted and appended as a visible note."""
    rows = ["| arch | shape | compute s | memory s | collective s | dominant | "
            "roofline frac | MODEL/HLO | bottleneck note |",
            "|---|---|---|---|---|---|---|---|---|"]
    skipped: Dict[str, int] = {}
    for key in sorted(cells):
        r = cells[key]
        arch, shape, m = key.split("|")
        if m != "sp":
            skipped["multi-pod"] = skipped.get("multi-pod", 0) + 1
            continue
        if r.get("status") != "ok":
            skipped["not-ok"] = skipped.get("not-ok", 0) + 1
            continue
        if r.get("scope") == "rank 0":
            skipped["rank-0-scope"] = skipped.get("rank-0-scope", 0) + 1
            continue
        if "roofline" not in r:
            skipped["no-roofline-section"] = \
                skipped.get("no-roofline-section", 0) + 1
            continue
        rf, acc = r["roofline"], r["accounting"]
        dom = rf["dominant"].replace("_s", "")
        ratio = ("-" if acc.get("useful_ratio") is None
                 else f"{acc['useful_ratio']:.2f}")
        note = {
            "compute": "MXU-bound: fuse/alignment wins only",
            "memory": "HBM-bound: fewer bytes/act re-reads (fusion, dtype, remat policy)",
            "collective": "ICI-bound: reshard/overlap collectives",
        }[dom]
        rows.append(
            f"| {arch} | {shape} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | {dom} | "
            f"{rf['roofline_fraction']:.3f} | {ratio} | {note} |{_scope(r)}")
    if skipped:
        parts = ", ".join(f"{n} {reason}"
                          for reason, n in sorted(skipped.items()))
        rows.append(f"\n{sum(skipped.values())} cell(s) not shown: {parts}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args()
    cells = load(args.out)
    ok = sum(1 for r in cells.values() if r.get("status") == "ok")
    print(f"## Dry-run matrix ({ok}/{len(cells)} cells ok)\n")
    print("\n".join(dryrun_table(cells)))
    print("\n## Roofline (single-pod 16x16, per-cell three terms)\n")
    print("\n".join(roofline_table(cells)))


if __name__ == "__main__":
    main()
