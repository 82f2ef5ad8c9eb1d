"""Run one cell of the benchmark of tpurt_torch on this machine's card.

    python3 rtbench/run.py --workload sponza1m.frames --seed 1 --seconds 10 --trace 0

Prints, as its last line on stdout, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 a breakdown,
and last the numbers the check compared, each with its limit (also the
last lines on stderr).  Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), without the port's
sources beside the benchmark, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "rtbench", "_cache")
# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "src", "tpurt_torch")):
        print("rtbench: the port's sources (src/tpurt_torch) are not beside the benchmark",
              file=sys.stderr)
        return 3
    import torch

    from rtbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, measured = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), device="cuda", t_start=T_START)
    for key, value in measured.notes.items():
        if key not in ("device", "breakdown"):
            print(f"note {key} = {json.dumps(value)}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
