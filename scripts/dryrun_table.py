"""Summarise the dry run's records as Markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python scripts/dryrun_table.py DIR

One row an arch of ``DIR/*.json`` (written by
``repro_torch.launch.dryrun``), a column a (shape, mesh) cell: a rank's
peak GB, whether it fits one H100, the dominant roofline term, and the
GB a rank sends by collective kind (all-gather / all-reduce /
reduce-scatter, each summed over the axes its calls ran on). The skipped
cells' reason below the table, then the trace time by family and kind.
"""
import collections
import json
import pathlib
import sys

GB = 1e9
MESHES = ("16x16", "2x16x16")
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
KINDS = ("all_gather", "all_reduce", "reduce_scatter")
DOMINANT = {"compute_s": "comp", "memory_s": "mem", "collective_s": "coll"}


def kinds(colls: dict) -> collections.Counter:
    """Bytes by collective kind, the axes summed."""
    out = collections.Counter()
    for key, n in colls.items():
        out[key.split(":")[0]] += n
    return out


def cell(r: dict) -> str:
    """A record as "peak GB, fits, dominant term; AG/AR/RS GB"."""
    if "skipped" in r:
        return "skipped"
    by = kinds(r["collectives"])
    return (f"{r['memory']['peak_bytes'] / GB:.2f} "
            f"{'yes' if r['memory']['fits'] else '**no**'} "
            f"{DOMINANT[r['dominant']]}; "
            + "/".join(f"{by.get(k, 0) / GB:.2f}" for k in KINDS))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    recs = {}
    for p in sorted(pathlib.Path(argv[0]).glob("*.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    shapes = sorted({k[1] for k in recs}, key=SHAPE_ORDER.index)
    cols = [(sh, m) for sh in shapes for m in MESHES]
    print("| arch | " + " | ".join(f"{sh} {m}" for sh, m in cols) + " |")
    print("|" + "---|" * (1 + len(cols)))
    skipped, other = set(), set()
    for arch in sorted({k[0] for k in recs}):
        row = []
        for sh, m in cols:
            r = recs[(arch, sh, m)]
            if "skipped" in r:
                skipped.add(r["skipped"])
            else:
                other |= set(kinds(r["collectives"])) - set(KINDS)
            row.append(cell(r))
        print(f"| {arch} | " + " | ".join(row) + " |")
    print()
    for reason in skipped:
        print(f"skipped: {reason}")
    if other:
        print(f"Other collective kinds (not in the table): {sorted(other)}")
    print()
    from repro_torch.configs import get_config
    trace = collections.defaultdict(list)
    for r in recs.values():
        if "skipped" not in r:
            trace[(get_config(r["arch"]).family, r["kind"])].append(
                r["trace_s"])
    print("| family | kind | cells | trace s (min-max) |")
    print("|---|---|---|---|")
    for (fam, kind), ts in sorted(trace.items()):
        print(f"| {fam} | {kind} | {len(ts)} | {min(ts)}-{max(ts)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
