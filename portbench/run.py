"""Run one cell of the benchmark of ``corrla_rs_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result's JSON object;
the last lines of standard error are the compared numbers with their
limits. Exit codes: 0 a result was printed (``correct`` may be false); 2 too
few CUDA devices; 3 a module of JAX or of the JAX package was loaded; 4 the
matrix products' TF32 setting is not the configuration's ``tf32``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, roofline  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, result = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START)
    if result is None:
        return code
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    result["card"] = roofline.card_line()
    result["checks"] = result.pop("checks")
    print(f"card {result['card']}", file=sys.stderr)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
