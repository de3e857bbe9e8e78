"""The readings the check's limits are set from, on the card: for each
seed one run of the cell (a short window, the program's numbers: the lower
readings); for the first ``--control`` seeds the control's numbers on the
same segments (the reference with TF32 on in the program's place: the
upper readings); and for the first ``--fault-seeds`` seeds one run with
each fault of ``--faults`` planted in the program (``faults.py``). All
runs in one process, so the kernel library loads once.

    python3 -m ptzbench.calibrate --workload <cell> --seconds 5 --control 3 \\
        --faults half insert:5e-3 --fault-seeds 3 --frames out.jsonl --seeds 11 12 ...

Prints one JSON line a run and a summary line: each number's largest
program reading, smallest control reading and smallest reading of each
fault. ``--frames`` writes each kept segment's frame table (one JSON line
a segment: ``check.frames_row``), for a look at the readings. Not part of
a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import time

from ptzbench import check as checklib
from ptzbench import faults, run


def _fault(spec: str):
    name, _, by = spec.partition(":")
    return faults.make(name, float(by) if by else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also run the control")
    ap.add_argument("--faults", nargs="*", default=[], help="faults as name or name:by (faults.make)")
    ap.add_argument("--fault-seeds", type=int, default=3, help="seeds (the first ones) that run each fault")
    ap.add_argument("--frames", default=None, help="a file for each kept segment's frame table")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from ptzbench.registry import Registry

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    reg = Registry(run.ROOT)
    cell = reg.cell(args.workload)
    dump = open(args.frames, "a") if args.frames else None
    lower = dict.fromkeys(checklib.NUMBERS, float("-inf"))
    upper = {"control": dict.fromkeys(checklib.NUMBERS, float("inf"))}
    for f in args.faults:
        upper[f] = dict.fromkeys(checklib.NUMBERS, float("inf"))
    runs = [(seed, None, k < args.control) for k, seed in enumerate(args.seeds)]
    runs += [(seed, f, False) for f in args.faults for seed in args.seeds[: args.fault_seeds]]
    for seed, fault, control in runs:
        t0 = time.perf_counter()
        frames: list = []
        res, _ = run.run_cell(
            reg, cell, seed, args.seconds, False, torch.device("cuda", 0), t_import=t0,
            program_cls=_fault(fault) if fault else None, control=control, frames=frames,
        )
        prog = res["look"]
        line = {"seed": seed, "fault": fault, "correct": res["correct"], "program": prog,
                "control": res.get("control"), "attempted": res["attempted"], "failed": res["failed"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if dump is not None:
            for row in frames:
                dump.write(json.dumps({"workload": cell.name, "seed": seed, "fault": fault, **row}) + "\n")
            dump.flush()
        for n in checklib.NUMBERS:
            if fault:
                upper[fault][n] = min(upper[fault][n], prog[n])
            else:
                lower[n] = max(lower[n], prog[n])
                if res.get("control"):
                    upper["control"][n] = min(upper["control"][n], res["control"][n])
    if dump is not None:
        dump.close()
    print(json.dumps({"workload": cell.name, "seeds": args.seeds, "program_max": lower, "min": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
