"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Makes the cell's inputs from the seed, warms up (set-up), measures for S
seconds, checks what the timed path produced against the plain reference
in ``portbench/reference``, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and ``checks`` (each compared number beside its
limit, also the last lines on standard error). Exits 2 without a result
when the cell's cards are not there, and 3 when JAX or the JAX package was
imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness
    wl_path = os.path.join(harness.HERE, "workloads", args.workload + ".json")
    if not os.path.exists(wl_path):
        print(f"unknown workload {args.workload!r}; cells: {harness.names('workloads')}",
              file=sys.stderr)
        return 2
    chips = harness.load_json(wl_path)["chips"]
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ.setdefault(name, os.path.join(ROOT, ".portbench_cache", name.lower()))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); {have} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"imported during the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
