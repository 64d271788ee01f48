"""Overlapping-window decoding of DEM-based decoders on the device (port of
``ldpc_tpu.ckt_noise.device_scan``).

The host OWD loop (base_overlapping_window_decoder.py) decodes windows
sequentially with one ``decode_batch`` round-trip per window. Circuit DEMs
from repeated measurement rounds are *time-translation invariant*: every
window sees the same check sub-matrix, shifted along the error-mechanism
axis by a constant stride. :func:`analyze_uniform_windows` (a copy of the
JAX package's, numpy and scipy) detects that structure;
:func:`make_device_owd` decodes the middle windows as a Python loop of
launches over device tensors, as ``parallel/window.py`` does, each window

    look-back adjustment from the running correction -> BP (K1', one
    (wdec,) prior) -> OSD-0 (K2') or LSD-0 (K4', through the growth loop)
    on the lanes BP leaves unconverged -> commit

(reference: base_overlapping_window_decoder.py:89-137,
lsd_overlapping_window.py:11). Irregular DEMs (boundary windows that differ
structurally) return None from :func:`analyze_uniform_windows` and keep the
host loop.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ldpc_tpu_torch.device import resolve_device


class UniformWindows(NamedTuple):
    """Time-translation-invariant window structure of a DCM."""

    NW: int  # number of windows (= decodings)
    w_lo: int  # first scanned window (boundary windows stay on host)
    w_hi: int  # one past the last scanned window
    R: int  # detector rows per window
    stride_rows: int  # detector-row stride between windows
    lo0: int  # first window's first active column
    col_stride: int  # column stride between windows
    lookback: int  # columns of committed look-back inside each window
    wdec: int  # active columns per window (incl. look-back)
    commit_span: int  # columns committed per non-final window
    H_win: np.ndarray  # (R, wdec) uint8 canonical window matrix
    weights_win: np.ndarray  # (wdec,) base weights restricted to a window
    num_cols: int  # total DCM columns


def analyze_uniform_windows(
    dcm: csr_matrix,
    decodings: int,
    window: int,
    commit: int,
    num_checks: int,
    weights: np.ndarray,
) -> Optional[UniformWindows]:
    """Detect whether every window sees the same (shifted) sub-matrix.

    Mirrors ``current_round_inds`` (base_overlapping_window_decoder.py:
    287-334) for the active-column ranges, then requires: constant
    active width, constant column stride, identical canonical blocks,
    and identical restricted weight vectors. The look-back block is the
    column range shared with previously committed windows (window 0's
    block must be empty-equivalent: all-zero columns in its rows).
    """
    dcm = csr_matrix(dcm)
    R = num_checks * window
    stride_rows = num_checks * commit
    if decodings < 4:
        return None  # too few middle windows to be worth a device scan
    if window > 2 * commit:
        # the scan recomputes each window's committed-syndrome adjustment
        # from scratch; with more than two windows overlapping a row the
        # host loop's telescoping passes cannot be reproduced exactly
        return None
    w_lo, w_hi = 1, decodings - 1  # boundary windows stay on the host
    infos = []
    for w in range(decodings):
        start = w * stride_rows
        rows = dcm[start : start + R, :]
        cols = rows.nonzero()[1]
        if cols.size == 0:
            return None
        crows = dcm[start : start + num_checks * commit, :]
        ccols = crows.nonzero()[1]
        if ccols.size == 0:
            return None
        infos.append(
            dict(
                lo=int(cols.min()),
                hi=int(cols.max()),
                commit_lo=int(ccols.min()),
                commit_hi=int(ccols.max()),
                rows=rows,
            )
        )
    mids = infos[w_lo:w_hi]
    wdec = mids[0]["hi"] - mids[0]["lo"] + 1
    if any(i["hi"] - i["lo"] + 1 != wdec for i in mids):
        return None
    col_stride = mids[1]["lo"] - mids[0]["lo"]
    if any(
        mids[k + 1]["lo"] - mids[k]["lo"] != col_stride
        for k in range(len(mids) - 1)
    ):
        return None
    # committed look-back: columns shared with the previous window's
    # commit region (the host decodes window w_lo-1, so the first
    # scanned window's look-back is committed too)
    lookbacks = [
        infos[w - 1]["commit_hi"] + 1 - infos[w]["lo"]
        for w in range(w_lo, w_hi)
    ]
    lookback = lookbacks[0]
    if lookback < 0 or any(lb != lookback for lb in lookbacks):
        return None
    commit_spans = [i["commit_hi"] - i["lo"] + 1 for i in mids]
    if any(c != commit_spans[0] for c in commit_spans):
        return None
    commit_span = commit_spans[0]
    lo0 = mids[0]["lo"]

    def block(k):
        lo = lo0 + k * col_stride
        return mids[k]["rows"][:, lo : lo + wdec].toarray().astype(np.uint8)

    canon = block(0)
    for k in range(1, len(mids)):
        if block(k).tobytes() != canon.tobytes():
            return None
    weights = np.asarray(weights, np.float64)
    wts = weights[lo0 : lo0 + wdec]
    for k in range(1, len(mids)):
        lo = lo0 + k * col_stride
        if not np.allclose(weights[lo : lo + wdec], wts):
            return None
    return UniformWindows(
        NW=decodings,
        w_lo=w_lo,
        w_hi=w_hi,
        R=R,
        stride_rows=stride_rows,
        lo0=lo0,
        col_stride=col_stride,
        lookback=lookback,
        wdec=wdec,
        commit_span=commit_span,
        H_win=canon,
        weights_win=wts,
        num_cols=dcm.shape[1],
    )


def lookback_rows(H_win: np.ndarray, lookback: int) -> np.ndarray:
    """Each window row's look-back columns, as an (R, k) int64 table padded
    with ``lookback`` (a zero column appended to the look-back block): the
    committed-syndrome adjustment of a row is the parity of the running
    correction on its entries, an exact integer sum."""
    block = np.asarray(H_win[:, :lookback], np.uint8)
    k = max(int(block.sum(axis=1).max(initial=0)), 1)
    table = np.full((block.shape[0], k), lookback, np.int64)
    for r in range(block.shape[0]):
        cols = np.flatnonzero(block[r])
        table[r, : cols.size] = cols
    return table


def make_device_owd(
    uw: UniformWindows,
    min_weight: float,
    *,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    postprocess: str = "osd0",
    bits_per_step: int = 1,
    device="cuda",
):
    """Build the middle windows' decoder on ``device``.

    Returns ``decode(shots: (B, num_detectors) uint8, total_in: (B,
    num_cols) uint8) -> total_corr (B, num_cols) uint8``, tensors on
    ``device``, with the semantics of the JAX package's scan over windows
    ``[w_lo, w_hi)``: per window, the recorded detectors are XOR-adjusted by
    the committed corrections' syndrome, decoded against the canonical window
    matrix (committed look-back columns re-weighted to ``min_weight``), and
    the first ``commit_span`` columns of the decoding are XORed into the
    running correction. The post-processor runs on the lanes BP leaves
    unconverged (``window._postprocess``: one host sync a window), which
    gives the JAX package's ``where(converged, bp, post)`` over every lane.
    """
    from ldpc_tpu_torch.ops import bp as bp_ops
    from ldpc_tpu_torch.ops.pcm import compile_pcm
    from ldpc_tpu_torch.parallel import window

    if postprocess not in ("osd0", "lsd0"):
        raise ValueError(f"unsupported postprocess {postprocess!r}")
    device = resolve_device(device)
    graph = compile_pcm(csr_matrix(uw.H_win))
    method = (
        bp_ops.MINIMUM_SUM
        if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
        else bp_ops.PRODUCT_SUM
    )

    # OWD weights are error PRIORS (probabilities); committed look-back
    # columns get the subclass's _min_weight (0.0 for the BP family:
    # probability zero, a +inf prior, pins them off for later windows,
    # exactly like the host loop's `weights[commit_inds] = _min_weight` +
    # error_channel rebuild). Window 0's look-back columns are all-zero in
    # its rows (verified by analyze_uniform_windows), so one prior serves
    # every window.
    probs_mid = uw.weights_win.copy()
    probs_mid[: uw.lookback] = min_weight
    llr_mid = torch.from_numpy(bp_ops.channel_llr(probs_mid, dtype=np.float32)).to(device)

    bp_fn = bp_ops.make_parallel_decoder(graph, method, max_iter, ms_scaling_factor, device)
    if postprocess == "osd0":
        from ldpc_tpu_torch.ops import osd as osd_ops

        _osd = osd_ops.make_osd_decoder(graph, probs_mid, osd_ops.OSD_0, 0, device)

        def post(syn, llr):
            return _osd(syn, llr)[0]

    else:
        from ldpc_tpu_torch.ops import lsd as lsd_ops

        _lsd = lsd_ops.make_lsd_decoder(
            graph, lsd_method=lsd_ops.LSD_0, lsd_order=0,
            bits_per_step=bits_per_step, device=device,
        )

        def post(syn, llr):
            return _lsd(syn, llr)[0]

    lb_table = torch.from_numpy(lookback_rows(uw.H_win, uw.lookback)).to(device)

    def decode(shots: torch.Tensor, total_in: torch.Tensor) -> torch.Tensor:
        """Decode windows [w_lo, w_hi) given the host-committed state so
        far; returns the updated global correction."""
        shots = torch.as_tensor(shots, device=device).to(torch.uint8)
        total_in = torch.as_tensor(total_in, device=device).to(torch.uint8)
        B = shots.shape[0]
        # a window's width of zero columns past the end, as the JAX scan pads
        total = torch.cat(
            [total_in, torch.zeros((B, uw.wdec), dtype=torch.uint8, device=device)], dim=1
        )
        for k in range(uw.w_hi - uw.w_lo):
            start = (k + uw.w_lo) * uw.stride_rows
            s_win = shots[:, start : start + uw.R]
            lo = uw.lo0 + k * uw.col_stride
            if uw.lookback:
                lb = torch.nn.functional.pad(total[:, lo : lo + uw.lookback], (0, 1))
                adj = lb[:, lb_table].sum(dim=2, dtype=torch.int32) & 1
                s_win = s_win ^ adj.to(torch.uint8)
            s_win = s_win.contiguous()
            bp = bp_fn(s_win, llr_mid)
            dec = window._postprocess(post, s_win, bp)
            total[:, lo : lo + uw.commit_span] ^= dec[:, : uw.commit_span]
        return total[:, : uw.num_cols]

    return decode
