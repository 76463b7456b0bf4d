"""Structure-adaptive banded-split layout: gather-free sparse products for
bandable instances.

Uniform-random incidence matrices force one random-access row per nonzero in
any layout.  Real route-incidence matrices are different: routes traverse
spatially local links, so after a bandwidth-reducing ordering (RCM on the
bipartite adjacency; ``models/reorder.py``) each column's nonzero rows fall in
a narrow window that advances with the column index.  This layout exploits
that with a hot loop that contains NO gathers and NO scatters:

  * rows are padded to Mp = ceil(m/128) pages of 128;
  * within each width bucket, blocks are sorted by their row window
    (``models/partition.py`` order_key), so PF position correlates with the
    window; each bucket's PF range is cut into Mp equal column groups
    (C_b = L_b/Mp), group g owning the static window
    [128*(g - back), 128*(g - back + wpages));
  * columns whose nonzeros fit their group window are stored DENSE in a
    per-bucket band tensor (Mp, C_b, W), W = 128*wpages; the rest go to a
    small residual dual-ELL.

Per iteration the banded part is pure dense algebra:

    A@x  : Z_b = band_zmv(band_b, x_b)   per bucket, summed;
           y   = sum_j shift(Z[:, :, j*128:(j+1)*128], j pages)
           (wpages static shifted adds — the overlap-add of a block-
           bidiagonal matrix)
    A^T r: Rw[g] = rp[g*128 : g*128 + W]   (a strided view of the padded r)
           g_b = band_grmv(band_b, Rw)

so the least time of a product is the time to stream the band tensors once.
The residual rides the gather path.  Profitability is decided at prepare time
from the measured fit fraction and the band memory.

Block sharding: the band tensors shard along the GROUP axis.  In the
value-grouped layout groups are contiguous block ranges, so a group shard is
exactly a block shard, and shard d's contribution to A x is the contiguous
row window starting at ladder page ``page_off = d * gl``, placed into a
zero full-m partial that the caller sums over the column shards (the same
collective as the gather layout's); its A^T r reads its windows of the
padded residual at that page offset.

Counterpart of ``bsls_tpu/ops/banded.py``.  Scenarios are an explicit leading
axis: vectors are (n,) or (S, n), and the contractions go to
``ops/pagekernels.py`` with S as their leading dimension.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .pagekernels import band_grmv, band_zmv

__all__ = ["PAGE", "DeviceBanded", "block_window_key", "build_banded_split",
           "banded_matvec", "banded_rmatvec"]

PAGE = 128


@dataclass(frozen=True)
class DeviceBanded:
    """Banded-split device matrix.  ``bands[b]`` is (Mp, C_b, W) for bucket b
    whose PF range is ``seg_lens[b] = Mp * C_b`` long; ``resid`` holds the
    non-fitting nonzeros as a ``DeviceEll`` (or None).

    Group g's window covers logical row pages [g - back, g - back + wpages)
    — in the front-padded page coordinates the products use, the window of
    group g always starts at padded page g, which keeps every slice static.

    A block shard holds gl = ``bands[0].shape[0]`` < ``pages`` groups, the
    ones from global ladder page ``page_off`` on; ``n_pf`` and ``seg_lens``
    are then the shard's."""

    bands: tuple  # tuple[(gl, C_b, W) tensor]
    resid: Optional[object]  # DeviceEll or None
    num_rows: int  # original m
    wpages: int  # window width in pages
    back: int  # pages the window extends BEHIND the ladder page
    n_pf: int
    seg_lens: tuple  # PF length per bucket segment
    pages: int  # GLOBAL ladder page count Mp (padded to the shard count)
    page_off: int = 0  # global ladder page of this shard's first group


def block_window_key(rows_pf: np.ndarray, vals_pf: np.ndarray) -> np.ndarray:
    """Per-PF-column window key (min nonzero row; big for empty columns)."""
    nz = vals_pf != 0
    r = np.where(nz, rows_pf, np.iinfo(np.int32).max)
    return r.min(axis=1)


def _choose_window(rows_pf, vals_pf, seg_lens, Mp, max_pages,
                   min_fit: float = 0.5,
                   gather_ns: float = 6.0, stream_gbs: float = 819.0):
    """Cost-model window choice.

    Band bytes scale linearly with the window width (the (Mp, C_b, W) tensors
    keep a slot for every column whether or not it fits), while a spilled
    column only costs its nonzeros' gathered rows.  So instead of a fixed
    percentile cut, enumerate candidate (back, end) pairs from the per-column
    page-delta quantiles and pick the one minimising the modeled
    per-iteration cost

        2 * band_bytes(wpages) / stream_BW  +  2 * nnz_spilled * gather_ns

    (both products stream the band once and gather the residual once).
    ``gather_ns`` and ``stream_gbs`` are the reference's constants, kept so
    that both packages choose the same window; they were not measured on the
    card this package runs on.  Candidates whose nnz fit-fraction drops below
    ``min_fit`` are skipped so the layout stays recognisably banded; the
    2nd..98th percentile window is the fallback when nothing qualifies."""
    deltas_lo, deltas_hi, nnzs = [], [], []
    nz = vals_pf != 0
    off = 0
    for L in seg_lens:
        C = max(-(-L // Mp), 1)
        pos = np.arange(L)
        g = pos // C
        seg_nz = nz[off : off + L]
        r = rows_pf[off : off + L]
        rmin = np.where(seg_nz, r, np.iinfo(np.int32).max).min(axis=1)
        rmax = np.where(seg_nz, r, -1).max(axis=1)
        valid = rmax >= 0
        deltas_lo.append(rmin[valid] // PAGE - g[valid])
        deltas_hi.append(rmax[valid] // PAGE - g[valid])
        nnzs.append(seg_nz.sum(axis=1)[valid])
        off += L
    dlo = np.concatenate(deltas_lo) if deltas_lo else np.zeros(1, np.int64)
    dhi = np.concatenate(deltas_hi) if deltas_hi else np.zeros(1, np.int64)
    colnnz = np.concatenate(nnzs) if nnzs else np.zeros(1, np.int64)
    nnz_total = max(int(colnnz.sum()), 1)

    # fallback: percentile window
    fb_back = int(np.clip(-np.percentile(dlo, 2), 0, max_pages - 1))
    fb_end = int(np.clip(np.percentile(dhi, 98) + 1, 1 - fb_back, max_pages - fb_back))
    fallback = (fb_back, max(fb_back + fb_end, 1))

    # band bytes per page of window width (fixed by the segment shapes)
    bytes_per_wpage = sum(Mp * max(-(-L // Mp), 1) for L in seg_lens) * PAGE * 4

    qs = (0, 0.5, 1, 2, 5, 10, 25, 50)
    backs = sorted({int(np.clip(-np.percentile(dlo, q), 0, max_pages - 1)) for q in qs})
    ends = sorted({int(np.clip(np.percentile(dhi, 100 - q) + 1, 1, max_pages)) for q in qs})
    best = None
    for ba in backs:
        for en in ends:
            wp = ba + en
            if wp < 1 or wp > max_pages:
                continue
            spilled = (dlo < -ba) | (dhi > en - 1)
            nnz_spill = int(colnnz[spilled].sum())
            if 1.0 - nnz_spill / nnz_total < min_fit:
                continue
            cost = (2.0 * bytes_per_wpage * wp / (stream_gbs * 1e9)
                    + 2.0 * nnz_spill * gather_ns * 1e-9)
            if best is None or cost < best[0]:
                best = (cost, ba, wp)
    if best is None:
        return fallback
    return best[1], best[2]


def build_banded_split(
    rows_pf: np.ndarray,
    vals_pf: np.ndarray,
    num_rows: int,
    seg_lens: list[int],
    max_pages: int = 8,
    dtype=np.float32,
    pages: int = 0,
):
    """Build the banded split from PF column-ELL data (host, numpy).

    ``seg_lens``: PF length of each bucket segment (concatenated = n_pf).
    ``pages`` overrides the ladder page count (extra groups are empty).
    Returns (bands, back, wpages, fit_fraction, (resid_rows, resid_vals)).
    """
    n_pf, k = rows_pf.shape
    assert sum(seg_lens) == n_pf
    Mp = pages if pages else -(-num_rows // PAGE)
    nz = vals_pf != 0
    back, wpages = _choose_window(rows_pf, vals_pf, seg_lens, Mp, max_pages)
    wmax = wpages * PAGE

    bands = []
    resid_rows = np.zeros_like(rows_pf)
    resid_vals = np.zeros_like(vals_pf)
    nnz_total = int(nz.sum())
    nnz_fit = 0
    off = 0
    for L in seg_lens:
        C = max(-(-L // Mp), 1)
        # the products rely on the value-grouped partition's exact ladder
        # (every group padded to the max page load): L == Mp*C
        assert L == Mp * C, (L, Mp, C)
        band = np.zeros((Mp, C, wmax), dtype)
        seg_rows = rows_pf[off : off + L]
        seg_vals = vals_pf[off : off + L]
        seg_nz = nz[off : off + L]
        pos = np.arange(L)
        g = pos // C  # ladder page of each column
        c = pos % C
        lo = ((g - back) * PAGE)[:, None]  # window start row per column
        fits = seg_nz & (seg_rows >= lo) & (seg_rows < lo + wmax)
        col_fits = fits.sum(axis=1) == seg_nz.sum(axis=1)
        nnz_fit += int(seg_nz[col_fits].sum())
        # dense-fill fitting columns (np.add.at: duplicate (row,col) entries
        # in the ELL accumulate, matching the gather path's semantics)
        fi = np.nonzero(col_fits[:, None] & seg_nz)
        if fi[0].size:
            gg = g[fi[0]]
            cc = c[fi[0]]
            ww = seg_rows[fi] - (gg - back) * PAGE
            np.add.at(band, (gg, cc, ww), seg_vals[fi])
        # residual: whole non-fitting columns
        nf = ~col_fits
        resid_rows[off : off + L][nf] = seg_rows[nf]
        resid_vals[off : off + L][nf] = seg_vals[nf]
        bands.append(band)
        off += L
    fit_fraction = nnz_fit / max(nnz_total, 1)
    return bands, back, wpages, fit_fraction, (resid_rows, resid_vals)


def _matvec_core(A: DeviceBanded, x_pf: torch.Tensor) -> torch.Tensor:
    """The band's contribution to A @ x for x_pf of shape (S, n_pf): a
    full-m partial whose nonzero rows lie in pages [page_off - back,
    page_off + gl - back + wpages)."""
    S, gl, wpages = x_pf.shape[0], A.bands[0].shape[0], A.wpages
    Z = None
    off = 0
    for band in A.bands:
        C = band.shape[1]
        L = gl * C  # exact: the value-grouped partition pads every group
        z = band_zmv(band, x_pf[:, off:off + L].reshape(S, gl, C))
        Z = z if Z is None else Z.add_(z)  # z is a fresh buffer
        off += L
    # overlap-add in front-padded page coordinates (group g starts at padded
    # page g): wpages static shifted adds, no scatter
    pages = x_pf.new_zeros((S, gl + wpages, PAGE))
    for j in range(wpages):
        pages[:, j:j + gl] += Z[:, :, j * PAGE:(j + 1) * PAGE]
    flat = pages.view(S, -1)
    if gl < A.pages:  # a block shard: place its window in a zero full-m partial
        y = x_pf.new_zeros((S, (A.pages + wpages) * PAGE))
        y[:, A.page_off * PAGE:A.page_off * PAGE + flat.shape[1]] = flat
        flat = y
    return flat[:, A.back * PAGE:A.back * PAGE + A.num_rows]


def _rp_flat(A: DeviceBanded, r: torch.Tensor) -> torch.Tensor:
    """Front-pad ``back`` zero pages (group g's window then starts at padded
    page g) and tail-pad to the ladder length: (S, (Mp + wpages) * PAGE)."""
    rp = r.new_zeros((r.shape[0], (A.pages + A.wpages) * PAGE))
    rp[:, A.back * PAGE:A.back * PAGE + r.shape[1]] = r
    return rp


def _rmatvec_core(A: DeviceBanded, rp_flat: torch.Tensor) -> torch.Tensor:
    """A_band^T r from the front-padded residual.  The window matrix
    Rw[s, g, :] = rp[s, (page_off + g)*PAGE : (page_off + g)*PAGE + W] is a
    strided view: the windows of neighbouring pages overlap and are never
    copied."""
    S, gl, W = rp_flat.shape[0], A.bands[0].shape[0], A.wpages * PAGE
    Rw = rp_flat[:, A.page_off * PAGE:].as_strided((S, gl, W), (rp_flat.stride(0), PAGE, 1))
    outs = [band_grmv(band, Rw).reshape(S, -1) for band in A.bands]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _with_scenarios(fn, vec: torch.Tensor) -> torch.Tensor:
    return fn(vec[None])[0] if vec.ndim == 1 else fn(vec)


def banded_matvec(A: DeviceBanded, x_pf: torch.Tensor) -> torch.Tensor:
    """A_band @ x for x_pf of shape (n_pf,) or (S, n_pf); the residual is
    added by the caller (``layout.matvec``)."""
    return _with_scenarios(lambda x: _matvec_core(A, x), x_pf)


def banded_rmatvec(A: DeviceBanded, r: torch.Tensor) -> torch.Tensor:
    """A_band^T @ r for r of shape (m,) or (S, m)."""
    return _with_scenarios(lambda rr: _rmatvec_core(A, _rp_flat(A, rr)), r)
