"""Peaks of the cards the benchmark knows, and the bytes the hop work needs.

The peaks are the published ones (NVIDIA's data sheet for the H100 SXM,
dense rates), which assume the card's full power limit: a card set below it
runs slower under load, so a run records the limit it found beside them.

The bytes of a query batch are counted from the work the search reports,
whatever kernels do it: each distance computed reads one row of the table
it runs on (the f32 row, with its norm under l2; or on the int8 tier the
code row, its scale and, under l2, its cached norm), each hop reads one
adjacency row, and on the int8 tier the rescore reads the f32 rows of the
final beam.  Each row is counted once per query that needs it.
"""
from __future__ import annotations

PEAKS = {
    # name as torch.cuda.get_device_name() gives it
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "power_limit_w": 700.0,
    },
}


def peak(device_name: str, key: str):
    """A published peak of the card, or None for a card not in the table."""
    return PEAKS.get(device_name, {}).get(key)


def traversal_row_bytes(dim: int, metric: str, quantized: bool) -> int:
    """Bytes one distance computation of the hop reads."""
    norm = 4 if metric == "l2" else 0
    if quantized:
        return dim + 4 + norm
    return 4 * dim + norm


def rescore_row_bytes(dim: int, metric: str) -> int:
    return 4 * dim + (4 if metric == "l2" else 0)


def query_batch_bytes(*, comps: float, hops: float, n_queries: int,
                      dim: int, r: int, l: int, metric: str,
                      quantized: bool) -> float:
    """The bytes a query batch's hop work needs.

    ``comps`` and ``hops`` are the batch's summed ``SearchResult.n_comps``
    and ``n_hops``.  On the int8 tier ``n_comps`` also counts the rescore of
    the final beam, ``l`` rows a query where the beam is full (at least
    ``l`` live points and no tombstones, as in every cell here); those rows
    are counted at f32 width, the rest at the traversal width."""
    rescored = n_queries * l if quantized else 0
    trav = comps - rescored
    return (trav * traversal_row_bytes(dim, metric, quantized)
            + rescored * rescore_row_bytes(dim, metric)
            + hops * 4 * r)


def roofline_pct(nbytes: float, device_seconds: float, device_name: str):
    """Least time of ``nbytes`` at the card's HBM peak over the measured
    device time, in percent; None without a peak or a time."""
    bw = peak(device_name, "hbm_bytes_per_s")
    if bw is None or device_seconds <= 0:
        return None
    return 100.0 * (nbytes / bw) / device_seconds
