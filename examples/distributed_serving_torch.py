"""Distributed serving on PyTorch: the two-tower retrieval arch composed with
the paper's streaming index over 8 logical shards — candidate embeddings
stream in and out while queries run (the twin of
``examples/distributed_serving.py``).

  retrieval path A: exact top-k through kernel 4
                    (``repro_torch.kernels.ops.topk_search``, metric ip)
  retrieval path B: the sharded IP-DiskANN graph index (sub-linear search)

    python examples/distributed_serving_torch.py                # on the card
    python examples/distributed_serving_torch.py --device cpu   # plain kernels

The eight shards are eight entries of one device (``ShardedIndex``'s
``devices``); the index's answers do not depend on the layout.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import test_scale  # noqa: E402
from repro_torch.core import ShardedIndex  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.kernels.ops import topk_search  # noqa: E402
from repro_torch.models.recsys import (  # noqa: E402
    TwoTower,
    TwoTowerConfig,
    init_two_tower_params,
)


def demo_config(n_items: int = 4000, dim: int = 64) -> TwoTowerConfig:
    return TwoTowerConfig(name="demo", embed_dim=dim,
                          tower_mlp=(128, 64, 32), user_vocab=1000,
                          item_vocab=n_items)


def embed(model: TwoTower):
    """(item embeddings (N, d), the first user's vector (1, d)): the item
    tower over the whole catalogue, the user tower over user 0."""
    with torch.no_grad():
        items = model.item_embeddings()
        user = model.user_tower(model.user_emb[:1])
    return items, user


def path_b(item_embs, user_vec, devices, n_logical=None, k=10, l=32):
    """The sharded index over the catalogue (external id = item id):
    insert every item, search, delete every second item in place, search
    again.  Returns the index and ``{"before", "after"}``, each ``search``'s
    ``(ext ids, owner rows, dists, comps)``, and the dropped ids."""
    item_embs = np.asarray(item_embs, np.float32)
    n_items = item_embs.shape[0]
    cfg = test_scale(item_embs.shape[1], n_cap=n_items, metric="ip")
    idx = ShardedIndex(cfg, devices, n_logical=n_logical)
    ext = np.arange(n_items)
    idx.insert(ext, item_embs)
    before = idx.search(user_vec, k=k, l=l)
    drop = ext[::2]
    idx.delete(drop)
    after = idx.search(user_vec, k=k, l=l)
    return idx, {"before": before, "after": after, "drop": drop}


def main(argv=None, params=None):
    """Run the three steps; ``params``: a two-tower parameter tree (of
    tensors on the device) to serve instead of the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--n-items", type=int, default=4000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg_tt = demo_config(args.n_items)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_two_tower_params(gen, cfg_tt, device=dev)
    model = TwoTower(cfg_tt, params)

    # item-tower embeddings = the streaming corpus
    item_embs, user_vec = embed(model)
    n_items = item_embs.shape[0]
    print(f"embedded {n_items} items -> {item_embs.shape[1]}-d")

    # --- path A: exact scoring with the top-k kernel -------------------------
    t0 = time.perf_counter()
    _, ids = topk_search(user_vec, item_embs, k=10, metric="ip")
    ids = ids.cpu().numpy()
    print(f"exact top-10 (fused kernel): {ids[0][:5].tolist()}... "
          f"in {time.perf_counter()-t0:.2f}s")

    # --- path B: sharded streaming graph index -------------------------------
    # external-id semantics end to end: each shard runs the unified apply
    # op stream of StreamingIndex
    user_np = user_vec.cpu().numpy()
    idx, res = path_b(item_embs.cpu().numpy(), user_np,
                      [dev] * 8)
    found, _, _, comps = res["before"]
    print(f"sharded index built over {idx.n_shards} shards")
    exact = set(int(i) for i in ids[0])
    overlap = len(exact.intersection(found[0].tolist())) / 10
    print(f"graph fan-out top-10: {found[0][:5].tolist()}... "
          f"recall vs exact = {overlap:.1f}, comps = {comps} "
          f"(vs {n_items} brute-force)")

    # --- streaming churn: delete half the catalogue, serve again -------------
    drop = res["drop"]
    found2 = res["after"][0]
    if set(found2[0].tolist()).intersection(drop.tolist()):
        raise RuntimeError("deleted items served!")
    print(f"after deleting {len(drop)} items in place: "
          f"top-10 contains no deleted items — OK")
    return res


if __name__ == "__main__":
    main()
