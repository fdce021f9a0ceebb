"""Quickstart on the PyTorch/CUDA port: build a streaming IP-DiskANN index,
query it, delete in place, and keep querying — no consolidation pauses.
The twin of ``examples/quickstart.py``; the index lives on the card unless
``--device cpu`` is given (the plain PyTorch versions of the kernels).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import test_scale
from repro_torch.core import StreamingIndex, make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the index lives (default: the card)")
    args = ap.parse_args(argv)

    # 1. data: 4k synthetic embeddings (Gaussian mixture), 32 held-out queries
    data, queries = make_dataset(4000, dim=32, n_queries=32, seed=0)

    # 2. a streaming index in in-place mode (the paper's algorithm)
    cfg = test_scale(dim=32, n_cap=4096)
    index = StreamingIndex(cfg, mode="ip", max_external_id=10_000,
                           device=args.device)

    # 3. insert the first 3k points (incremental build == Algorithm 2)
    index.insert(np.arange(3000), data[:3000])
    print(f"built index on {index.device}: {index.n_active} points, "
          f"recall@10 = {index.recall(queries):.3f}")

    # 4. search
    ext_ids, dists, _ = index.search(queries[:4], k=5)
    print("top-5 for query 0:", ext_ids[0].tolist())

    # 5. delete 1k points IN PLACE (Algorithm 5) and insert 1k more
    index.delete(np.arange(1000))
    index.insert(np.arange(3000, 4000), data[3000:4000])
    print(f"after churn: {index.n_active} points, "
          f"recall@10 = {index.recall(queries):.3f}, "
          f"light consolidations = {index.counters.n_consolidations}")

    # 6. deleted points are really gone
    ext_ids, _, _ = index.search(data[:8], k=1)
    assert not set(ext_ids[:, 0]).intersection(range(1000))
    print("deleted ids never returned — OK")


if __name__ == "__main__":
    main()
