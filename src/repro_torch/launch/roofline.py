"""The roofline table of the dry-run (PyTorch counterpart of
``benchmarks/roofline.py``): reads ``launch/dryrun.py``'s JSONL and
prints, per (arch × shape × mesh), the compute, memory and collective
terms on the named card, the dominant one and MODEL_FLOPS / counted
FLOPs. Runs nothing itself.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--tag baseline]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import RESULTS, load_done


def _ms(v) -> str:
    return "null" if v is None else f"{v * 1e3:.3f}"


def table(recs) -> list:
    """One text line per record, then the ok / skipped / error tally."""
    lines, tally = [], {"ok": 0, "skipped": 0, "error": 0}
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        tally[r["status"]] += 1
        head = f"{r['arch']:<22} {r['shape']:<12} {r['mesh']:<7}"
        if r["status"] == "skipped":
            lines.append(f"{head} skipped: {r['reason']}")
        elif r["status"] == "error":
            lines.append(f"{head} ERROR: {r['error']}")
        else:
            u = r["useful_flops_ratio"]
            lines.append(
                f"{head} {r['device']}: dom={r['dominant']} "
                f"compute_ms={_ms(r['compute_s'])} "
                f"memory_ms={_ms(r['memory_s'])} "
                f"collective_ms={_ms(r['collective_s'])} "
                f"useful={'null' if u is None else f'{u:.3f}'} "
                f"fits={r['fits']}")
    lines.append(json.dumps({"roofline": tally}))
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default=None)
    ap.add_argument("--path", default=str(RESULTS))
    args = ap.parse_args(argv)
    recs = [r for r in load_done(pathlib.Path(args.path)).values()
            if args.tag is None or r.get("tag") == args.tag]
    lines = table(recs)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
