"""One run of one benchmark cell on the card; prints one JSON result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result. The last line
of standard output is the result: ``correct``, ``attempted`` (steps in
the measured window), ``failed`` (steps whose loss was not finite),
``metrics`` (the cell's end-to-end metrics, or its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` the ``breakdown``, and
last ``checks``: each number compared with its limit, which also end
standard error.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Every module a run imports is compiled to bytecode once a checkout and
# kept inside it at a fixed path (gitignored): where the environment
# turns bytecode writing off, each run would compile again the modules
# torch imports lazily (some 6 s of every set-up on the card's host).
sys.dont_write_bytecode = False
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / ".bench_cache" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

# The JAX package and the libraries it rests on: none may be loaded in
# a run (compared by whole top-level module names).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "arvae_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), STARTED,
                           log=lambda phase, at: print(f"[setup] {phase} done at {at:.3f} s",
                                                       file=sys.stderr, flush=True))
    run = out["run"]
    metrics = harness.read_metrics(run, bool(args.trace))
    device = {"platform": "gpu", "kind": run.device_kind, "count": chips,
              "memory_peak_bytes": out["peak"], "card": card_line()}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if run.stretch is not None:
        device["busy_s"], device["window_s"] = run.stretch.busy_s, run.stretch.window_s
        result["breakdown"] = {"device_ops": run.stretch.device_ops(),
                               "idle_gaps": run.stretch.idle_gaps()}
    if run.stretch is not None and run.window.steps:
        s, w = run.stretch, run.window
        print(f"[trace] ms a step: window {1e3 * w.seconds / w.steps:.4f}, profiled host "
              f"{1e3 * s.host_s / s.steps:.4f}, profiled device span "
              f"{1e3 * s.window_s / s.steps:.4f} (the tracer's cost is the difference)",
              file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": out["limits"][n]}
                        for n, v in run.checks.items()}
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in the run's process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
