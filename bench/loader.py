"""Hand the starting graph to the program, as a deployment loads an index
built offline.

The state is written in the reference's numpy layout (``repro_torch.
convert``'s docstring) and goes in through the program's entry for it,
``repro_torch.convert.index_state_from_numpy``, set on a ``StreamingIndex``
handle.  A later change to that entry changes what the benchmark loads.

Slot ``i`` holds external id ``i`` of the starting set; the free stack is
the one the program leaves after inserting ``n_live`` points into an empty
table.  The int8 tier's codes follow the program's documented rule
(``core/quant.py``): per-row scale ``max|x| / 127`` (1 for a zero row),
codes ``round(x / scale)`` clipped to [-127, 127], and the squared norm of
the dequantized row.
"""
from __future__ import annotations

import numpy as np
import torch


def quantize_rows(x: torch.Tensor) -> dict:
    """The int8 tier of rows ``x`` (n, D): ``{codes, scale, qnorms}``."""
    amax = x.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    deq = codes.to(torch.float32) * scale[:, None]
    return {"codes": codes, "scale": scale, "qnorms": (deq * deq).sum(-1)}


def numpy_state(config: dict, base: torch.Tensor, adj: torch.Tensor,
                start: int, max_external_id: int) -> dict:
    """The index state in the reference's numpy layout."""
    n_cap, dim, r = int(config["n_cap"]), int(config["dim"]), int(config["r"])
    n = base.shape[0]
    vectors = np.zeros((n_cap, dim), np.float32)
    vectors[:n] = base.cpu().numpy()
    norms = np.zeros(n_cap, np.float32)
    norms[:n] = (base * base).sum(1).cpu().numpy()
    table = np.full((n_cap, r), -1, np.int32)
    table[:n] = adj.cpu().numpy()
    active = np.zeros(n_cap, np.bool_)
    active[:n] = True
    quant = None
    if config["quantized"]:
        q = {k: v.cpu().numpy() for k, v in quantize_rows(base).items()}
        quant = {"codes": np.zeros((n_cap, dim), np.int8),
                 "scale": np.ones(n_cap, np.float32),
                 "qnorms": np.zeros(n_cap, np.float32)}
        for k, v in q.items():
            quant[k][:n] = v
    ext2slot = np.full(max_external_id, -1, np.int32)
    ext2slot[:n] = np.arange(n, dtype=np.int32)
    slot2ext = np.full(n_cap, -1, np.int32)
    slot2ext[:n] = np.arange(n, dtype=np.int32)
    i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
    graph = {
        "vectors": vectors, "norms": norms, "adj": table, "active": active,
        "tombstone": np.zeros(n_cap, np.bool_),
        "quarantine": np.zeros(n_cap, np.bool_),
        "free_stack": np.arange(n_cap - 1, -1, -1, dtype=np.int32),
        "free_top": i32(n_cap - n), "start": i32(start),
        "n_active": i32(n), "n_pending": i32(0), "quant": quant,
    }
    return {"graph": graph, "ext2slot": ext2slot, "slot2ext": slot2ext,
            "n_inserts": i32(0), "n_deletes": i32(0),
            "insert_comps": i32(0), "delete_comps": i32(0)}


def ann_config(config: dict):
    """The program's ``ANNConfig`` for a configuration file."""
    from repro_torch.core.types import ANNConfig

    keys = ("dim", "n_cap", "r", "l_build", "l_search", "l_delete",
            "k_delete", "n_copies", "alpha", "metric",
            "consolidation_threshold", "quantized")
    return ANNConfig(**{k: config[k] for k in keys})


def max_external_id(config: dict) -> int:
    """The external-id range of the handle: ``StreamingIndex``'s default."""
    return 4 * int(config["n_cap"])


def load_index(config: dict, state: dict, device):
    """A ``StreamingIndex`` holding ``state`` (``numpy_state``'s layout),
    on ``device``."""
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core.index import StreamingIndex

    cfg = ann_config(config)
    max_ext = max_external_id(config)
    idx = StreamingIndex(cfg, mode=config["policy"], max_external_id=max_ext,
                         batch_updates=bool(config["batch_updates"]),
                         device="meta")
    idx.device = torch.device(device)
    idx.istate = index_state_from_numpy(state, device)
    return idx
