"""The byte counts behind ``hop_roofline_pct``."""
from __future__ import annotations

import pytest

from bench import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_row_bytes():
    assert roofline.traversal_row_bytes(100, "l2", False) == 404
    assert roofline.traversal_row_bytes(100, "ip", False) == 400
    assert roofline.traversal_row_bytes(768, "ip", True) == 772
    assert roofline.traversal_row_bytes(768, "l2", True) == 776
    assert roofline.rescore_row_bytes(768, "ip") == 3072


def test_f32_batch_bytes():
    # 1,000 distances of 404 bytes and 10 hops of a 64-wide adjacency row
    got = roofline.query_batch_bytes(comps=1000, hops=10, n_queries=4,
                                     dim=100, r=64, l=128, metric="l2",
                                     quantized=False)
    assert got == 1000 * 404 + 10 * 256


def test_int8_batch_bytes_count_the_rescore_at_f32():
    # 2 queries: 2 x 128 rescored rows at 3,072 bytes, the other 744
    # distances at 772 bytes, 6 hops
    got = roofline.query_batch_bytes(comps=1000, hops=6, n_queries=2,
                                     dim=768, r=64, l=128, metric="ip",
                                     quantized=True)
    assert got == 744 * 772 + 256 * 3072 + 6 * 256


def test_roofline_share():
    # 3.35 GB at 3.35 TB/s is 1 ms; measured in 4 ms: 25%
    assert roofline.roofline_pct(3.35e9, 4e-3, H100) == pytest.approx(25.0)
    assert roofline.roofline_pct(1e9, 1e-3, "some other card") is None
    assert roofline.roofline_pct(1e9, 0.0, H100) is None
    assert roofline.peak(H100, "power_limit_w") == 700.0
