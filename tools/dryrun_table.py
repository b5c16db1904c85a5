#!/usr/bin/env python3
"""The markdown table of a dry-run sweep, one line a pair with both
meshes side by side (``PERF.md`` §6), from the JSONL rows of

    python -m repro_torch.launch.dryrun --all --both-meshes --out BF16
    python -m repro_torch.launch.dryrun --all --both-meshes \\
        --tune kv_cache_dtype=int8 --out INT8

Usage: ``python3 tools/dryrun_table.py BF16 [INT8]``. Terms in ms
against the H100's data-sheet peaks, bytes in GiB a device; ``a / b``
is 16 x 16 / 2 x 16 x 16. With INT8, a decode pair's memory term and
argument bytes under the int8 K/V cache follow in brackets.
"""
import json
import sys


def load(path):
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def two(rows, arch, shape, key, scale, fmt):
    vals = [rows[(arch, shape, m)][key] * scale for m in ("16x16",
                                                          "2x16x16")]
    return " / ".join(fmt.format(v) for v in vals)


def main(argv):
    bf16 = load(argv[0])
    int8 = load(argv[1]) if len(argv) > 1 else None
    pairs = []
    for arch, shape, _ in bf16:
        if (arch, shape) not in pairs:
            pairs.append((arch, shape))
    ok = sum(r["ok"] for r in bf16.values())
    print(f"{ok} / {len(bf16)} rows ok" + (
        f"; int8: {sum(r['ok'] for r in int8.values())} / {len(int8)}"
        if int8 else ""))
    print("| arch | shape | compute ms | memory ms | dominant | useful "
          "| args GiB | temp GiB | trace s |")
    print("|---|---|---|---|---|---|---|---|---|")
    gib = 1 / 2 ** 30
    for arch, shape in pairs:
        r = bf16[(arch, shape, "16x16")]
        mem = two(bf16, arch, shape, "memory_s", 1e3, "{:.2f}")
        args = two(bf16, arch, shape, "arg_bytes_per_device", gib, "{:.2f}")
        if int8 and r["kind"] == "decode":
            mem += " [" + two(int8, arch, shape, "memory_s", 1e3,
                              "{:.2f}") + "]"
            args += " [" + two(int8, arch, shape, "arg_bytes_per_device",
                               gib, "{:.2f}") + "]"
        comp = two(bf16, arch, shape, "compute_s", 1e3, "{:.3g}")
        temp = two(bf16, arch, shape, "temp_bytes_per_device", gib, "{:.2f}")
        print(f"| {arch} | {shape} | {comp} | {mem} | {r['dominant']} | "
              f"{r['useful_flops_ratio']:.2f} | {args} | {temp} | "
              f"{r['seconds']} |")


if __name__ == "__main__":
    main(sys.argv[1:])
