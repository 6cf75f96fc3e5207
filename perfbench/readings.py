"""Readings for the limits of the check: the numbers it compares, for the
program on many seeds, for the control (the reference computed in
bfloat16, put in the program's place) on a few and, in a step cell, for
each planted fault on a few, all in one process so that the set-up is
paid once.

    python3 perfbench/readings.py --workload terrain_1m.invert_ss \
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 5

The faults of a step: ``stale``, each kept step answered with the one
before it (the reference's step at the previous camera); ``half``, the
reference's step with the mean over the first half of the rows alone;
``altered``, the program's own answer with the light position's
gradient negated.

Prints one JSON line per seed and side: the numbers, the frames or steps
the window ran, its ms per iteration and the reference's seconds. The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


FAULTS = ("stale", "half", "altered")


def fault_answer(fault: str, cfg, trf, inp, at, i: int, out, target,
                 device):
    """Step ``i``'s answer with ``fault`` planted in it (``out`` is the
    program's own answer)."""
    from perfbench import check
    from perfbench.reference.render import Scene, step

    if fault == "altered":
        loss, grads = out
        return loss, {**grads, "light_pos": -grads["light_pos"]}
    pos, tgt = at(i - 1 if fault == "stale" else i)
    w, h = trf["width"], trf["height"]
    return step(Scene(inp), pos.to(device), tgt.to(device), w, h, target,
                check.ref_opts(cfg, trf),
                rows=h // 2 if fault == "half" else None)


def read(spec: dict, seeds, control_seeds, seconds: float, device,
         cache: Path, control_dtype="bfloat16", fault_seeds=()):
    """Yield one dict per seed and side: the program's seeds, then the
    control's, then each fault's (steps only)."""
    import torch

    from perfbench import check, harness

    cfg, trf = spec["config"], spec["traffic"]
    kind = trf["kind"]
    first = (list(seeds) + list(control_seeds) + list(fault_seeds))[0]
    inp = harness.make_inputs(cfg, trf, device)
    prog = harness.setup_program(cfg, trf, inp, device, cache, first)
    at = harness.orbit(inp, cfg, first)
    for k in range(harness.WARMUP):
        prog.call(*at(-1 - k))
    ctrl = getattr(torch, control_dtype)
    sides = ([("program", s) for s in seeds]
             + [("control", s) for s in control_seeds]
             + [(f, s) for f in (FAULTS if kind == "step" else ())
                for s in fault_seeds])
    for side, seed in sides:
        at = harness.orbit(inp, cfg, seed)
        if kind == "step":
            prog.feed["target"] = harness.target_image(trf, seed, device)
        win, _ = harness.run_window(prog, kind, at, seconds,
                                    trf["check"]["iters"], seed, device)
        harness._sync(device)
        kept = [(i, at(i), out) for i, out in win.kept]
        t0 = time.perf_counter()
        if side in FAULTS:
            kept = [(i, c, fault_answer(side, cfg, trf, inp, at, i, out,
                                        prog.feed["target"], device))
                    for i, c, out in kept]
        nums = check.numbers(kind, cfg, trf, inp, kept, seed, device,
                             ctrl if side == "control" else None)
        harness._sync(device)
        yield {"side": side, "seed": seed, **nums, "iters": len(win.times),
               "ms": win.seconds / len(win.times) * 1e3,
               "reference_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    for row in read(spec, ints(args.seeds), ints(args.control_seeds),
                    args.seconds, "cuda", ROOT / ".perfbench_cache" / "scenes",
                    fault_seeds=ints(args.fault_seeds)):
        print(json.dumps(row), flush=True)
    print(json.dumps({"setup_and_all_s": time.perf_counter() - T_START,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
