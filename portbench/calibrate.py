"""Readings from which the limits of ``portbench/limits/`` are set.

    python3 portbench/calibrate.py --cells rbf16k.predict,pod2k.fit \
        --seeds 12 --control-seeds 3 --seconds 1 [--out FILE]

For each cell, in one process: the program's compared numbers over
``--seeds`` seeds (the lower readings), then the control's, the reference
computed in the precision below the configuration's
(``harness.control_arith``) in the program's place, over
``--control-seeds`` other seeds (the upper readings). Each run is a whole
run of the cell (set-up, a window of ``--seconds``, the comparison) at the
cell's own sizes. One JSON line a run goes to standard output and to
``--out``. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

# seeds above 2^31, as the benchmark's runs get them
_SEED_BASE = 2_400_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=_SEED_BASE)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    spec = harness.load_spec()
    try:
        for name in args.cells.split(","):
            cfg = harness.find_cell(spec, name).config
            driver, reference = harness.import_model(cfg["model"])
            control = harness.ControlDriver(driver, reference,
                                            harness.control_arith(cfg))
            runs = ([("program", None, args.first_seed + i)
                     for i in range(args.seeds)]
                    + [("control", control, args.first_seed + 1000 + i)
                       for i in range(args.control_seeds)])
            for side, drv, seed in runs:
                t0 = time.perf_counter()
                code, res = harness.run_cell(name, seed, args.seconds, False,
                                             t_start=t0, driver=drv)
                line = {"cell": name, "side": side, "seed": seed,
                        "code": code, "wall_s": time.perf_counter() - t0}
                if res is not None:
                    line.update(correct=res["correct"],
                                checks={k: c["value"] for k, c
                                        in res["checks"].items()},
                                metrics={k: m["value"] for k, m
                                         in res["metrics"].items()},
                                peak=res["device"]["memory_peak_bytes"])
                text = harness.result_line(line)
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
