#!/usr/bin/env python3
"""Time a row kernel of this tree (the projection or PAVA) against an older
tree's and against variants of this tree's source, in one call on one GPU.

    git archive <commit> bsls_tpu_torch | tar -x -C .smoke_parent
    python3 proj_probe.py --parent .smoke_parent [--kernel proj|pava] [--variants a,b]

Every kernel is built from its own source (nvcc, into a temporary
directory; the older tree's with its own headers), held against the plain
version and timed by ``chip_smoke.py``'s ``check_rows_at`` (device time of
one launch, inputs cycled past the L2) at the buckets of the solve paths,
with random block widths in (w/2, w] and radii.  The projection's cases:
``w4`` (medium x 128's w = 4 bucket alone), ``medium`` (its two buckets),
``eq`` (traffic_like x 128's four) and ``rank_tile`` (a rank's tile of the eq
mesh).  PAVA's (z-space widths, block size - 1): ``medium``, ``eq`` and
``eq_s4`` (the eq buckets at S = 128 and S = 4), and ``sweep_<w>``, one
bucket of (128, 1003, w) at each width of ``chip_smoke.py``'s sweep.  The
older tree's kernel is taken through its one-bucket entry point
(``bsls_proj_simplex_rows`` or ``bsls_pava_rows``), a bucket a launch.  Turns run parent, tree, variants, variants reversed, tree, parent;
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
from bsls_tpu_torch.ops.isotonic import pava_padded  # noqa: E402

CSRC = os.path.join(HERE, "bsls_tpu_torch", "csrc")
EQ = [(962, 2), (1770, 4), (3617, 8), (3651, 12)]


def _table_edit(macro, entry, forms):
    table = re.compile(r"#define " + macro + r"\(X\).*?\n\n", re.S)
    text = "#define " + macro + "(X) " + " ".join(entry(*f) for f in forms) + "\n\n"
    return lambda s: table.sub(text, s, count=1)


_proj = lambda forms: _table_edit("BSLS_PROJ_FORMS", lambda lo, hi, g, k: f"X({lo}, {hi}, {g}, {k})",
                                  forms)
_pava = lambda forms: _table_edit("BSLS_PAVA_FORMS", lambda lo, hi, r: f"X({lo}, {hi}, {r})", forms)
_STACK = [(33, 64, 64), (65, 128, 32)]


def _cut(start, end, insert=""):
    """An edit that replaces the source from ``start`` up to ``end`` (kept)."""
    def edit(s):
        a = s.index(start)
        return s[:a] + insert + s[s.index(end, a):]
    return edit


_FIT_START = "  const int t = static_cast<int>(threadIdx.x);\n  if (t < nrows) {"
_FIT_END = "  __syncthreads();\n  stage_rows<P, false>"
_EXPAND_START = "    // expand from the last slot down"
_EXPAND_END = "    for (int i = max(n, 0); i < w; ++i)"
# The stack form with its levels indexed by depth (a level's sum at slot
# `top` of the row, its count in a second shared array) in place of the
# level starts' bit mask.
_INDEX_STACK = """  const int t = static_cast<int>(threadIdx.x);
  if (t < nrows) {
    const unsigned int b = block_of(first_block_index(bk, r0), t, bk.Bk, R);
    const int n = min(bk.widths[b], w);
    const float rad = bk.radius[b];
    float* col = sm + t;
    int* cnt = reinterpret_cast<int*>(sm + w * P) + t;
    bool bad = false;
    int top = -1, tcnt = 0;
    float tsum = 0.0f, tmean = 0.0f;
    float next = (n > 0) ? col[0] : 0.0f;
    for (int i = 0; i < n; ++i) {
      const float v = next;
      if (i + 1 < n) next = col[(i + 1) * P];
      bad |= isnan(v);
      float csum = v, cmean = v;
      int ccnt = 1;
      while (top >= 0 && tmean > cmean) {
        csum += tsum;
        ccnt += tcnt;
        cmean = level_mean(csum, ccnt);
        if (--top >= 0) {
          tsum = col[top * P];
          tcnt = cnt[top * P];
          tmean = level_mean(tsum, tcnt);
        }
      }
      ++top;
      col[top * P] = csum;
      cnt[top * P] = ccnt;
      tsum = csum;
      tcnt = ccnt;
      tmean = cmean;
    }
    const float nan = __int_as_float(0x7fffffff);
    int left = 0;
    float o = 0.0f;
    for (int i = n - 1; i >= 0; --i) {
      if (left == 0) {
        left = cnt[top * P];
        o = bad ? nan : fminf(fmaxf(level_mean(col[top * P], left), 0.0f), rad);
        --top;
      }
      col[i * P] = o;
      --left;
    }
    for (int i = max(n, 0); i < w; ++i) col[i * P] = 0.0f;
  }
"""
_SMEM = "smem = (R) ? w * ((R) + 1) * static_cast<int>(sizeof(float)) : 0;"


def _index_stack(s):
    s = _cut(_FIT_START, _FIT_END, _INDEX_STACK)(s)
    return s.replace(_SMEM, _SMEM.replace("w * ((R) + 1)", "2 * w * ((R) + 1)"))

# kernel -> its name in chip_smoke.KERNELS, source, the older tree's entry
# point, this tree's entry getter in rowkernels and its C entry point, cases
# {name: (buckets, S)}
# and variants {name: (edit of the source, widths it covers[, False: timed
# only, its output not held against the plain version])}
PROBES = {
    "proj": dict(
        name="proj_simplex_rows", source="proj_simplex_rows.cu",
        parent_entry="bsls_proj_simplex_rows", entry="_buckets_fn",
        c_entry="bsls_proj_simplex_buckets",
        cases={"w4": ([(3330, 4)], 128), "medium": ([(3330, 4), (6670, 8)], 128),
               "eq": (EQ, 128), "rank_tile": ([(481, 2), (885, 4), (1808, 8), (1825, 12)], 64)},
        variants={
            # the w = 4 form alone: the registers and code of one form
            "w4_only": (_proj([(4, 4, 1, 4)]), {4}),
            # thread forms up to w = 8 only: no form past 8 sets the register count
            "narrow_only": (_proj([(w, w, 1, w) for w in range(1, 9)]), set(range(1, 9))),
        }),
    "pava": dict(
        name="pava_rows", source="pava_rows.cu", parent_entry="bsls_pava_rows",
        entry="_pava_fn", c_entry="bsls_pava_buckets",
        cases={"medium": ([(3330, 4), (6670, 8)], 128), "eq": (EQ, 128), "eq_s4": (EQ, 4),
               **{f"sweep_{w}": ([(1003, w)], 128)
                  for w in cs.KERNELS["pava_rows"]["sweep_widths"]}},
        variants={
            # the thread form up to w = 12 and up to w = 24 (the stack form
            # above): the register count of the whole kernel against the
            # widths the thread form takes
            "thread_to_12": (_pava([(w, w, 0) for w in range(1, 13)] + [(13, 32, 128)] + _STACK),
                             set(range(1, 129))),
            "thread_to_24": (_pava([(w, w, 0) for w in range(1, 25)] + [(25, 32, 128)] + _STACK),
                             set(range(1, 129))),
            # the stack form's parts, timed only (their output is not the fit):
            # the rows staged in and out, no fit; the forward pass without the
            # expansion
            "stage_only": (_cut(_FIT_START, _FIT_END), set(range(17, 129)), False),
            "forward_only": (_cut(_EXPAND_START, _EXPAND_END,
                                  "    col[0] = tsum + static_cast<float>(lo + hi) + (bad ? 1.f : 0.f);\n"),
                             set(range(17, 129)), False),
            # the levels indexed by depth, counts in a second shared array
            "index_stack": (_index_stack, set(range(1, 129))),
        }),
}


def _nvcc(src, lib, include):
    return subprocess.Popen(
        [cudalib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", include, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _buckets_entry(lib, fn_name):
    fn = getattr(ctypes.CDLL(lib), fn_name)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.restype = ctypes.c_int
    fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _parent_fn(lib, fn_name):
    old = getattr(ctypes.CDLL(lib), fn_name)
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
                                         zwidths=to(np.maximum(sizes - 1, 0)), width=w))
    return types.SimpleNamespace(buckets=tuple(out))


def _time_only(fn, probe, dp, S):
    """Device time of one launch of ``fn`` on every bucket of ``dp`` at S
    scenarios (inputs cycled past the L2), its output not looked at."""
    spec = cs.KERNELS[probe["name"]]
    inputs = []
    for i, bk in enumerate(dp.buckets):
        n_in = cs.inputs_in_turn(4 * S * bk.mask.numel())
        gen = torch.Generator(device=cs.DEV).manual_seed(i)
        vs = [torch.randn((S,) + tuple(bk.mask.shape), generator=gen, device=cs.DEV)
              for _ in range(n_in)]
        inputs.append((vs, spec["widths_of"](bk), bk.radius))
    entry = getattr(rowkernels, probe["entry"])
    setattr(rowkernels, probe["entry"], lambda: fn)
    try:
        return cs.device_ms(lambda j: spec["buckets_fn"](
            tuple(vs[j % len(vs)] for vs, _, _ in inputs), tuple(w for _, w, _ in inputs),
            tuple(r for _, _, r in inputs)))
    finally:
        setattr(rowkernels, probe["entry"], entry)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an older tree unpacked with git archive")
    ap.add_argument("--kernel", choices=sorted(PROBES), default="proj")
    ap.add_argument("--variants", default=None, help="comma-separated; default: all")
    ap.add_argument("--cases", default=None, help="comma-separated; default: all")
    args = ap.parse_args()
    probe = PROBES[args.kernel]
    variants = probe["variants"]
    names = [v for v in (args.variants if args.variants is not None
                         else ",".join(variants)).split(",") if v]
    cs.phase_device()
    cs.phase_build(False)
    tmp = tempfile.mkdtemp()
    src = open(os.path.join(CSRC, probe["source"])).read()
    parent_csrc = os.path.join(args.parent, "bsls_tpu_torch", "csrc")
    procs = {"parent": _nvcc(os.path.join(parent_csrc, probe["source"]),
                             os.path.join(tmp, "parent.so"), parent_csrc)}
    for name in names:
        edited = variants[name][0](src)
        cs.check(edited != src, f"variant {name}: the edit did not apply")
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(edited)
        procs[name] = _nvcc(path, os.path.join(tmp, f"{name}.so"), CSRC)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log[-3000:]}")
        res = re.findall(r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes "
                         r"spill stores.*?Used (\d+) registers", log, re.S)
        print(json.dumps({"ptxas": name, "kernels": res}), flush=True)

    kname = probe["name"]
    if kname == "pava_rows":
        # the plain version in chunks of 8192 rows: (rows, w, w) temporaries
        # at w = 128 stay a few GB
        cs.KERNELS[kname]["plain"] = lambda v, widths, radius: pava_padded(
            v, cs._mask(v, widths), 0.0, radius, chunk=8192)
    dps = {case: _buckets(shapes, 5) for case, (shapes, _) in probe["cases"].items()}
    spec = dict(cs.KERNELS[kname], buckets_fn=None, plan=lambda w: "parent",
                fn=_parent_fn(os.path.join(tmp, "parent.so"), probe["parent_entry"]))
    cs.KERNELS["parent"] = spec
    tree_fn = getattr(rowkernels, probe["entry"])
    libs = {name: os.path.join(tmp, f"{name}.so") for name in names}
    order = ["parent", "tree"] + names + names[::-1] + ["tree", "parent"]
    cases = {c: probe["cases"][c] for c in (args.cases.split(",") if args.cases
                                            else probe["cases"])}
    for turn, name in enumerate(order):
        for case, (shapes, S) in cases.items():
            if name in variants and any(w not in variants[name][1] for _, w in shapes):
                continue
            if name in variants and len(variants[name]) > 2 and not variants[name][2]:
                fn = _buckets_entry(libs[name], probe["c_entry"])
                print(json.dumps({"turn": turn, "kernel": name, "case": case,
                                  "timed_only_ms": _time_only(fn, probe, dps[case], S)}),
                      flush=True)
                continue
            if name == "parent":
                err, per, grouped = cs.check_rows_at("parent", dps[case], S, seed=3)
            else:
                fn = tree_fn() if name == "tree" else _buckets_entry(libs[name],
                                                                      probe["c_entry"])
                setattr(rowkernels, probe["entry"], lambda fn=fn: fn)
                err, per, grouped = cs.check_rows_at(kname, dps[case], S, seed=3)
                setattr(rowkernels, probe["entry"], tree_fn)
            print(json.dumps({
                "turn": turn, "kernel": name, "case": case, "max_abs_err": err,
                "per_bucket": [[b["shape"], b["ms"], b["share_of_bound"]] for b in per],
                "sum_ms": sum(b["ms"] for b in per),
                "grouped_ms": grouped and grouped["ms"],
                "grouped_share_of_bound": grouped and grouped["share_of_bound"]}), flush=True)


if __name__ == "__main__":
    main()
