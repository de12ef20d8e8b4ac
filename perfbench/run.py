"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

With ``--trace 0`` the run's result line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a short window
under ``torch.profiler``.  The last line of standard output is the result
as one JSON object; the numbers that decide ``correct`` are printed with
their limits as the last lines of standard error too.  Without a CUDA
device the run exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the program or torch would write stays in the checkout
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import harness
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    chips = harness.cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         args.trace, "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
