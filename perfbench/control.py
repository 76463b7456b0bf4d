"""The control of a cell's check: the plain reference, computed in a lower
precision, put in the program's place; its answers go through the same
comparison as a run's and have to come out not correct.

    python3 perfbench/control.py --workload medium.batch128 --seeds 11,12,13 \
        --precision bfloat16
    python3 perfbench/control.py --workload traffic_eq.drift128 --seeds 11,12,13 \
        --precision bfloat16

``bfloat16`` runs the whole reference in bfloat16, the control of every
cell; ``tf32`` runs it in float32 with TF32 on for its dense products (the C
rows of an equality-constrained cell), which no compared number separates
from sound runs at the cells' budgets (PERF.md).  An equality-constrained
answer reports its objective and violation as the program does, in float64
from its x.  At the cell's own size: each answer is a whole request of the
cell (``--requests`` of them; a stream's requests are solved side by side,
which gives each the same answer as alone).  Prints one JSON line per seed
with the compared numbers beside the cell's limits.
"""
import argparse
import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, core  # noqa: E402
from reference import al as RA  # noqa: E402
from reference import pgd as RP  # noqa: E402

PRECISIONS = {"bfloat16": (torch.bfloat16, False), "tf32": (torch.float32, True),
              "float32": (torch.float32, False), "float64": (torch.float64, False)}


def control_answers(cell, inst, pool, requests: int, precision: str, device) -> list:
    """Answers of the first ``requests`` pool entries from the reference in
    ``precision``, reported as the program reports them."""
    dtype, tf32 = PRECISIONS[precision]
    tr = cell.traffic
    solve, chunk = tr["solve"], tr["endpoint"]["chunk"]
    B = np.stack([np.atleast_2d(pool[p]) for p in range(requests)])  # (R, S, m)
    R, S = B.shape[:2]
    out = []
    if cell.config["reference"] == "pgd":
        X, f = RP.solve(inst.rows, inst.vals, inst.m, inst.sizes, B.reshape(R * S, -1),
                        solve["max_iter"], chunk, device, dtype=dtype)
        X, f = X.reshape(R, S, -1), f.reshape(R, S)
        for p in range(R):
            x, obj = (X[p, 0], f[p, 0]) if tr["scenarios"] == 1 else (X[p], f[p])
            out.append({"pool": p, "result": SimpleNamespace(x=x, objective=obj)})
    else:
        for p in range(R):
            x, f, viol = RA.solve_eq(inst.rows, inst.vals, inst.m, inst.sizes, inst.C, B[p],
                                     inst.d, max_iter=solve["max_iter"],
                                     inner_iters=solve["inner_iters"], chunk=chunk,
                                     eq_tol=solve["eq_tol"], device=device, dtype=dtype, tf32=tf32)
            out.append({"pool": p, "result": SimpleNamespace(x=x, objective=f, eq_violation=viol)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", choices=sorted(PRECISIONS), default="bfloat16")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests answered by the control (default: 2, a stream's 64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    dev = torch.device("cuda", 0)
    requests = args.requests or (64 if cell.traffic["scenarios"] == 1 else
                                 (1 if cell.config["reference"] == "al" else 2))
    for seed in (int(s) for s in args.seeds.split(",")):
        inst, pool = core.inputs(cell, seed, dev, requests)
        answers = control_answers(cell, inst, pool, requests, args.precision, dev)
        values = check.numbers(cell.config["reference"], inst, cell.traffic, pool, answers,
                               seed, dev)
        correct, table = check.judge(values, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "precision": args.precision,
                          "correct": correct, "numbers": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
