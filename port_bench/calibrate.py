"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 [--control] [--faults frozen,...]

For each seed, in one process: a run of the cell with no measured
window (its checked steps against the reference: the program's
readings); with ``--control``, the reference in TF32 put in the
program's place against the reference in float32; with ``--faults``,
a run with each fault of ``faults.py`` planted. Prints one JSON line a
seed and reading.
"""

import argparse
import json
import time

import torch

from port_bench import compare, data, faults, harness


def detail(program, reference, start) -> dict:
    """The loss gap, and of the gradient and change gaps the worst leaf
    (its name and value), the median leaf's and the next-worst leaf's."""
    loss, grad, update = compare.gap_maps(program, reference, start)
    out = {"loss_gap": loss, "token_gap": reference.token_gap,
           "logit_gap": compare.logit_gap(program, reference)}
    for name, gaps in (("grad", grad), ("update", update)):
        order = sorted(gaps, key=gaps.get, reverse=True)
        out.update({f"{name}_worst": gaps[order[0]], f"{name}_worst_leaf": order[0],
                    f"{name}_second": gaps[order[1]], f"{name}_median": compare.median(gaps)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    cell, dev = harness.load_cell(args.workload), torch.device("cuda", 0)
    reference = cell.module("reference")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(cell, seed, 0.0, False, dev, t)
        print(json.dumps({"seed": seed, "side": "program", "s": time.perf_counter() - t,
                          **detail(out["program"], out["reference"], out["start"])}),
              flush=True)
        if args.control:
            inputs = data.make_inputs(cell.traffic, cell.cfg, seed, dev)
            n = cell.traffic["checked_steps"]
            ctl = reference.run_steps(cell.cfg, cell.traffic, seed, inputs, out["start"], n,
                                      tf32=True)
            judge = reference.run_steps(cell.cfg, cell.traffic, seed, inputs, out["start"], n,
                                        fed=ctl.fed)
            print(json.dumps({"seed": seed, "side": "control",
                              **detail(ctl, judge, out["start"])}), flush=True)
        del out
        for fault in filter(None, args.faults.split(",")):
            if fault not in faults.FAULTS:
                raise SystemExit(f"unknown fault {fault!r}")
            out = harness.run_cell(cell, seed, 0.0, False, dev, time.perf_counter(), fault=fault)
            print(json.dumps({"seed": seed, "side": fault,
                              **detail(out["program"], out["reference"], out["start"])}),
                  flush=True)
            del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
