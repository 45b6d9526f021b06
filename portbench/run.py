"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``galois_tpu_torch/``). With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics; with ``--trace 1`` the window's
last seconds run under torch.profiler and they are its per-layer metrics. The numbers
compared for ``correct`` are printed with their limits as the last lines of
standard error and under the result's last key, ``check``. The run exits
with 2, and prints no result, without enough CUDA cards, and with 3 if the
process holds a JAX module or the JAX package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def prepare() -> None:
    """Triton's kernel cache at a fixed path inside the checkout, set before
    torch or triton is imported (nvcc's libraries go to
    build/galois_tpu_torch/), and the checkout first on the import path."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    cell, _, _ = harness.cell_parts(spec, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import galois_tpu_torch

    if not pathlib.Path(galois_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: galois_tpu_torch came from {galois_tpu_torch.__file__}, outside {ROOT}", file=sys.stderr)
        return 2

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS, spec=spec)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process holds {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("card: " + card_line(), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why there is none."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"unknown ({type(exc).__name__})"


if __name__ == "__main__":
    prepare()
    sys.exit(main())
