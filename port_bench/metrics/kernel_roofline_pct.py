"""``kernel_roofline_pct.<set>``: the least time of a kernel set's work
over the device time of the kernels that did it, in the profiled
stretch. The set's kernel names are the union of
``kernel_sets/<set>/*.txt``; its work a step in a model family is
``work/<set>/<family>.py``'s ``least_seconds(cfg, traffic, peaks)``: each call's operations at the peak FLOP rate or its bytes at
the peak bandwidth, the larger, summed over the calls of a step. No
reading where the family has no such file or no kernel of the set ran."""

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
SETS = BENCH / "kernel_sets"


def kernel_names(name):
    names = set()
    for path in sorted((SETS / name).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#")[0].strip()
            if line:
                names.add(line)
    return names


def read(run, suffix=None):
    if run.stretch is None or run.peaks is None or suffix is None:
        return None
    work = BENCH / "work" / suffix / f"{run.cell.family}.py"
    if not work.exists():
        return None
    spec = importlib.util.spec_from_file_location(f"port_bench.work.{suffix}.{run.cell.family}", work)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    busy = run.stretch.device_time_s(kernel_names(suffix))
    if busy <= 0:
        return None
    least = mod.least_seconds(run.cell.cfg, run.cell.traffic, run.peaks) * run.stretch.steps
    return 100.0 * least / busy
