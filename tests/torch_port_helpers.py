"""Shared helpers of the tests/test_torch_*.py files: flatten the device
objects of both packages to dictionaries of numpy arrays (the only thing that
crosses between them) and build the small seeded instances the tests use."""
import numpy as np

# every hand-written kernel of the port, under the name its wrapper counts
KERNELS = ("proj_simplex_rows", "pava_rows", "band_zmv", "band_grmv", "pgd_chunk")


def _arr(a):
    # works for jax arrays, torch CPU tensors and numpy alike
    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach") else a)


def _flatten_ell(d, stem, A):
    d[f"{stem}.rows"], d[f"{stem}.vals"] = _arr(A.rows), _arr(A.vals)
    if isinstance(A.mv_cols, tuple):
        for i, (c, v) in enumerate(zip(A.mv_cols, A.mv_vals)):
            d[f"{stem}.mv_cols[{i}]"], d[f"{stem}.mv_vals[{i}]"] = _arr(c), _arr(v)
    elif A.mv_cols is not None:
        d[f"{stem}.mv_cols"], d[f"{stem}.mv_vals"] = _arr(A.mv_cols), _arr(A.mv_vals)
    if A.rt_rows is not None:
        for i, (c, v) in enumerate(zip(A.rt_rows, A.rt_vals)):
            d[f"{stem}.rt_rows[{i}]"], d[f"{stem}.rt_vals[{i}]"] = _arr(c), _arr(v)
        d[f"{stem}.rt_inv"] = _arr(A.rt_inv)
    d[f"{stem}.rt_zeros"] = int(A.rt_zeros)


def _flatten_matrix(d, stem, A):
    if hasattr(A, "data"):
        d[f"{stem}.data"] = _arr(A.data)
    elif hasattr(A, "split"):  # the stacked operator of the eq path
        _flatten_matrix(d, f"{stem}.top", A.top)
        _flatten_matrix(d, f"{stem}.bottom", A.bottom)
        d[f"{stem}.bottom_scale"] = _arr(A.bottom_scale)
        d[f"{stem}.split"] = int(A.split)
    elif hasattr(A, "bands"):
        for i, band in enumerate(A.bands):
            d[f"{stem}.bands[{i}]"] = _arr(band)
        d[f"{stem}.back"], d[f"{stem}.wpages"] = int(A.back), int(A.wpages)
        d[f"{stem}.seg_lens"] = tuple(int(v) for v in A.seg_lens)
        d[f"{stem}.pages"] = int(A.pages) if A.pages else int(A.bands[0].shape[0])
        if A.resid is not None:
            _flatten_ell(d, f"{stem}.resid", A.resid)
    else:
        _flatten_ell(d, stem, A)


def flatten_device_problem(dp) -> dict:
    """A DeviceProblem of either package -> {field name: numpy array}, under
    the key names that bsls_tpu_torch.convert documents."""
    d = {}
    _flatten_matrix(d, "A", dp.A)
    d["b"] = _arr(dp.b)
    d["perm"] = _arr(dp.perm)
    d["row_perm"] = None if dp.row_perm is None else _arr(dp.row_perm)
    d["n_user"], d["num_rows"] = int(dp.n_user), int(dp.num_rows)
    for i, bk in enumerate(dp.buckets):
        d[f"buckets[{i}].mask"] = _arr(bk.mask)
        d[f"buckets[{i}].sizes"] = _arr(bk.sizes)
        d[f"buckets[{i}].radius"] = _arr(bk.radius)
        d[f"buckets[{i}].width"] = int(bk.width)
    return d


def flatten_state(st) -> dict:
    """A PGDState of either package -> {field name: numpy array}."""
    d = {f"xp[{i}]": _arr(x) for i, x in enumerate(st.xp)}
    for name in ("r", "f", "gap", "x_prev", "g_prev"):
        d[name] = _arr(getattr(st, name))
    d["k"] = np.asarray(st.k)
    return d


def small_instance(synthetic, kind: str, scenarios: int = 1):
    """The small seeded instances, from either package's ``synthetic``."""
    if kind == "dense":
        prob = synthetic.tiny_dense(seed=3, num_blocks=12, dim=5, m=64)
    elif kind == "ell":
        prob = synthetic.medium_sparse(seed=3, num_blocks=64, m=512)
    elif kind == "banded":
        prob = synthetic.medium_banded(seed=2, num_blocks=300, m=3000, spread=120)
    else:
        raise KeyError(kind)
    if scenarios > 1:
        prob = synthetic.with_scenarios(prob, scenarios, seed=4)
    return prob
