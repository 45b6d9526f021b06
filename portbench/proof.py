"""The readings that a cell's limits are set from, in one process.

    python3 portbench/proof.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--precisions float32,tfloat32,bfloat16,float8_e4m3fn] \
        [--seconds 2] [--out <file.json>]

For each of ``--seeds`` the program runs a short window at the cell's own
size and the check gives its numbers (the lower readings). For each of
``--control-seeds`` and each precision the control, the plain reference
with its syndromes taken as bit-plane products in that precision, takes
the program's place for one call on each batch of the ring (the upper
readings). The benchmark's own runs never run the control. Prints one JSON
object last (and writes it to ``--out``): every reading, the largest
program reading and the smallest control reading of each number.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from portbench.run import prepare  # noqa: E402


def readings(cell, seeds, seconds, harness):
    out = []
    for seed in seeds:
        ring = cell.make_ring(seed)
        w = harness.measure(cell, ring, seconds, T_PROCESS)
        checks, failed = harness.check(cell, ring, w)
        out.append({"seed": seed, "calls": w.calls, "failed": failed,
                    **{k: v["value"] for k, v in checks.items()}})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--precisions", default="float32,tfloat32,bfloat16,float8_e4m3fn")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--batch", type=int, default=None, help="a smaller batch (tests only)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    prepare()

    import torch

    from portbench import harness

    spec = harness.load_spec()
    _, config, mix = harness.cell_parts(spec, args.workload)
    if args.batch:
        mix = {**mix, "batch": args.batch}
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    Cell = harness.kind_module(config).Cell
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    result = {"workload": args.workload, "batch": mix["batch"], "card": torch.cuda.get_device_name()}
    numbers = list(harness.LIMITS)
    if seeds:
        cell = Cell(config, mix, "cuda")
        warm = cell.make_ring(seeds[0])
        cell.call(warm[0])
        del warm
        prog = readings(cell, seeds, args.seconds, harness)
        result["program"] = prog
        result["lower"] = {k: max(r[k] for r in prog) for k in numbers}
    result["control"], result["upper"] = {}, {}
    for precision in [s for s in args.precisions.split(",") if s] if cseeds else []:
        ctrl = Cell(config, mix, "cuda", control=precision)
        got = readings(ctrl, cseeds, 0.0, harness)
        result["control"][precision] = got
        result["upper"][precision] = {k: min(r[k] for r in got) for k in numbers}
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
