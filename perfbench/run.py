"""Run one cell of the benchmark once, on the card this process is given.

    python3 perfbench/run.py --workload terrain_1m.bounce --seed 7 \
        --seconds 20 --trace 0

Prints the result as one JSON object on the last line of standard output
and, as the last lines of standard error, each number the check compared
beside its limit. Exits non-zero without a result when there is no CUDA
card, too few cards, or when JAX or the JAX package was loaded.

The program's kernel build stays where the program puts it
(``snail_tpu_torch/build/``, named by a hash of its sources); the scene
cache and any compiler cache go under ``.perfbench_cache/`` at the root
of the checkout, at fixed paths.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one host thread: the load comes from one process with few threads
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from perfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, CACHE / "scenes")
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in res["checked"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
