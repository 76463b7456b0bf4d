#!/usr/bin/env python3
"""Time the projection kernel of this tree against an older tree's and
against variants of this tree's source, in one call on one GPU.

    git archive <commit> bsls_tpu_torch | tar -x -C .smoke_parent
    python3 proj_probe.py --parent .smoke_parent [--variants w4_only,...]

Every kernel is built from its own source (nvcc, into a temporary
directory), held against the plain version and timed by ``chip_smoke.py``'s
``check_rows_at`` (device time of one launch, inputs cycled past the L2)
at the buckets of the solve paths, with random block widths in (w/2, w] and
radii: ``w4`` (medium x 128's w = 4 bucket alone), ``medium`` (its two
buckets), ``eq`` (traffic_like x 128's four) and ``rank_tile`` (a rank's tile
of the eq mesh).  The older tree's kernel is taken through its one-bucket
entry point ``bsls_proj_simplex_rows`` (PR 9's interface), a bucket a
launch.  Turns run parent, tree, variants, variants reversed, tree, parent;
each prints one JSON line per case, and ``ptxas`` lines give the registers.
A variant is this tree's source with one edit (VARIANTS).
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (exits without a GPU)
from bsls_tpu_torch.ops import cudalib, rowkernels  # noqa: E402

CSRC = os.path.join(HERE, "bsls_tpu_torch", "csrc")
CASES = {"w4": ([(3330, 4)], 128), "medium": ([(3330, 4), (6670, 8)], 128),
         "eq": ([(962, 2), (1770, 4), (3617, 8), (3651, 12)], 128),
         "rank_tile": ([(481, 2), (885, 4), (1808, 8), (1825, 12)], 64)}
_TABLE = re.compile(r"#define BSLS_PROJ_FORMS\(X\).*?\n\n", re.S)


def _table(forms):
    return "#define BSLS_PROJ_FORMS(X) " + " ".join(f"X({lo}, {hi}, {g}, {k})"
                                                    for lo, hi, g, k in forms) + "\n\n"


# name -> (edit of the source, widths it covers)
VARIANTS = {
    # the w = 4 form alone: the registers and code of one form
    "w4_only": (lambda s: _TABLE.sub(_table([(4, 4, 1, 4)]), s, count=1), {4}),
    # thread forms up to w = 8 only: no form past 8 sets the register count
    "narrow_only": (lambda s: _TABLE.sub(_table([(w, w, 1, w) for w in range(1, 9)]), s,
                                         count=1), set(range(1, 9))),
}


def _nvcc(src, lib, include):
    return subprocess.Popen(
        [cudalib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", include, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _buckets_entry(lib):
    fn = ctypes.CDLL(lib).bsls_proj_simplex_buckets
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.restype = ctypes.c_int
    fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _parent_fn(lib):
    old = ctypes.CDLL(lib).bsls_proj_simplex_rows
    old.restype = ctypes.c_int
    old.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]

    def run(v, widths, radius):
        out = torch.empty_like(v)
        err = old(v.data_ptr(), widths.data_ptr(), radius.data_ptr(), out.data_ptr(),
                  v.numel() // v.shape[-1], v.shape[-1], v.shape[-2],
                  torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"parent kernel: launch error {err}")
        return out
    return run


def _buckets(shapes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for Bk, w in shapes:
        sizes = rng.integers(w // 2 + 1, w + 1, size=Bk).astype(np.int32)
        radius = rng.uniform(0.5, 2.0, size=Bk).astype(np.float32)
        mask = (np.arange(w)[None] < sizes[:, None]).astype(np.float32)
        to = lambda a: torch.from_numpy(a).to(cs.DEV)
        out.append(types.SimpleNamespace(mask=to(mask), sizes=to(sizes), radius=to(radius),
                                         width=w))
    return types.SimpleNamespace(buckets=tuple(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an older tree unpacked with git archive")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    cs.phase_device()
    cs.phase_build(False)
    tmp = tempfile.mkdtemp()
    src = open(os.path.join(CSRC, "proj_simplex_rows.cu")).read()
    procs = {"parent": _nvcc(os.path.join(args.parent, "bsls_tpu_torch", "csrc",
                                          "proj_simplex_rows.cu"),
                             os.path.join(tmp, "parent.so"), CSRC)}
    for name in names:
        edited = VARIANTS[name][0](src)
        cs.check(edited != src, f"variant {name}: the edit did not apply")
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(edited)
        procs[name] = _nvcc(path, os.path.join(tmp, f"{name}.so"), CSRC)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log[-3000:]}")
        res = re.findall(r"Function properties for (\S+)\s+(\d+) bytes stack frame.*?"
                         r"Used (\d+) registers", log, re.S)
        print(json.dumps({"ptxas": name, "kernels": res}), flush=True)

    dps = {case: _buckets(shapes, 5) for case, (shapes, _) in CASES.items()}
    spec = dict(cs.KERNELS["proj_simplex_rows"], fn=_parent_fn(os.path.join(tmp, "parent.so")),
                plan=lambda w: "parent")
    spec.pop("grouped")
    cs.KERNELS["parent"] = spec
    tree_fn = rowkernels._buckets_fn
    libs = {name: os.path.join(tmp, f"{name}.so") for name in names}
    order = ["parent", "tree"] + names + names[::-1] + ["tree", "parent"]
    for turn, name in enumerate(order):
        for case, (shapes, S) in CASES.items():
            if name in VARIANTS and any(w not in VARIANTS[name][1] for _, w in shapes):
                continue
            if name == "parent":
                err, per, grouped = cs.check_rows_at("parent", dps[case], S, seed=3)
            else:
                fn = tree_fn() if name == "tree" else _buckets_entry(libs[name])
                rowkernels._buckets_fn = lambda fn=fn: fn
                err, per, grouped = cs.check_rows_at("proj_simplex_rows", dps[case], S, seed=3)
            print(json.dumps({
                "turn": turn, "kernel": name, "case": case, "max_abs_err": err,
                "per_bucket": [[b["shape"], b["ms"], b["share_of_bound"]] for b in per],
                "sum_ms": sum(b["ms"] for b in per),
                "grouped_ms": grouped and grouped["ms"],
                "grouped_share_of_bound": grouped and grouped["share_of_bound"]}), flush=True)
    rowkernels._buckets_fn = tree_fn


if __name__ == "__main__":
    main()
