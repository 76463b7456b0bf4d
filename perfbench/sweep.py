"""Find the highest rate an open-loop cell sustains: one set-up, then a window
at each offered rate, lowest first.

    python3 perfbench/sweep.py --workload medium.stream --seed 11 --seconds 20 \
        --rates 20,30,40,45,50,60

Prints one JSON line per rate: requests due, answered by the window's close,
the backlog then (due and not yet answered), p50 and p95 latency from the
due time (an unanswered request counts as answered at the end of the wait),
answered requests per second, the queue's mean batch width and the
generator's worst lateness.  The knee is the highest rate whose backlog at
the close stays within one batch and whose p95 stays within a few batch
times.  Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core, drive, instances, stats  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    dev = torch.device("cuda", 0)
    inst, _ = core.inputs(cell, args.seed, dev, 0)
    ep, queue = core.serve(cell, inst, args.seed, dev)
    tr = cell.traffic
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        b0, r0 = queue.batches_run, queue.requests_served
        offsets = drive.arrival_offsets(rate, args.seconds, args.seed)
        # each rate's requests of their own, made before its window
        pool = instances.Requests(inst, tr, args.seed, dev, len(offsets), stream=10 + k)
        reqs, (t0, t_close, deadline) = drive.open_loop(queue.submit, pool, offsets, args.seconds,
                                                        tr["wait_s"])
        lat = drive.latencies(reqs, deadline)
        in_time = [r for r in reqs if r["ok"] and r["end"] is not None and r["end"] <= t_close]
        print(json.dumps({
            "rate_per_s": rate, "due": len(reqs), "answered_by_close": len(in_time),
            "backlog_at_close": len(reqs) - len(in_time),
            "answered_per_s": len(in_time) / args.seconds,
            "p50_s": stats.percentile(lat, 0.5), "p95_s": stats.percentile(lat, 0.95),
            "failed": sum(1 for r in reqs if not r["ok"]),
            "batch_width": (queue.requests_served - r0) / max(queue.batches_run - b0, 1),
            "generator_late_max_s": max(r["start"] - r["due"] for r in reqs),
        }), flush=True)
        time.sleep(1.0)
    queue.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
