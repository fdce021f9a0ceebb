"""Streaming-ANNS serving launcher (``repro/launch/serve.py``): one process
standing in for the online service.  It absorbs a continuous insert /
delete stream while answering queries, with no consolidation pauses.

    python -m repro_torch.launch.serve --ticks 40 --rate 64 --dim 32
    python -m repro_torch.launch.serve --device cpu --ticks 12 --rate 16
    python -m repro_torch.launch.serve --shards 4    # the sharded index

The launcher drives the ``repro_torch.serving`` front door: each tick's
queries are admitted one at a time and coalesced by the deadline-driven
dynamic batcher (``--deadline-ms`` / ``--bucket``), updates ride the
writer lane, and every search runs against the latest PUBLISHED snapshot,
never the writer's live handle.  The summary line gives the serving
percentiles and the per-phase service time (search / update / publish).
The index lives on the card unless ``--device`` names another device.

Durability: ``--checkpoint-dir`` checkpoints the index every
``--checkpoint-every`` ticks and restores and replays after a crash.
``--kill-at T`` injects a simulated process death at tick T; because
``VectorStream`` is stateless (batch = f(seed, tick)), the replayed ticks
rebuild exactly the state an uninterrupted run would have had:

    python -m repro_torch.launch.serve --checkpoint-dir DIR --kill-at 17
    python -m repro_torch.launch.serve --shards 4 --checkpoint-dir DIR

``--shards N`` serves a ``ShardedIndex`` of N logical rows through a
``ShardedEngine``, laid over N entries of ``--device`` (one device
repeated; the answers do not depend on the layout).  As in the reference,
the sharded index runs the ip policy and its tick lines carry no recall.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Run the launcher; returns the final ``StreamingIndex`` (with
    ``--shards``: the final ``ShardedIndex``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--rate", type=int, default=64, help="inserts per tick")
    ap.add_argument("--lifetime", type=int, default=30, help="ticks till delete")
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--mode", default="ip", choices=["ip", "fresh"])
    ap.add_argument("--shards", type=int, default=0,
                    help="serve a ShardedIndex of N logical rows over N "
                         "entries of --device")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="dynamic-batcher admission deadline per query")
    ap.add_argument("--bucket", type=int, default=32,
                    help="widest (and target) dispatch bucket, power of two")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint the index here and restore on restart")
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="ticks between checkpoints")
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="inject a simulated crash at this tick (once); "
                         "requires --checkpoint-dir to recover")
    ap.add_argument("--device", default=None,
                    help="where the index lives (default: the card)")
    args = ap.parse_args(argv)
    if args.shards < 0:
        ap.error(f"--shards {args.shards}: the number of logical rows "
                 f"must be >= 0 (0: the single StreamingIndex)")

    from ..checkpoint import CheckpointManager
    from ..configs.ann import test_scale
    from ..core import ShardedIndex, StreamingIndex
    from ..core.api import delete_batch, insert_batch
    from ..core.types import resolve_device
    from ..data import VectorStream
    from ..ft.supervisor import SimulatedFailure
    from ..serving import (ServingFront, ServingMetrics, ShardedEngine,
                           StreamingEngine)

    n_cap = args.rate * (args.lifetime + 4)
    stream = VectorStream(dim=args.dim, rate=args.rate,
                          lifetime=args.lifetime)
    mgr = (CheckpointManager(args.checkpoint_dir)
           if args.checkpoint_dir else None)
    kill_budget = {args.kill_at: 1} if args.kill_at >= 0 else {}
    max_ext = args.rate * (args.ticks + 1)
    cfg = test_scale(args.dim, n_cap)

    device = resolve_device(args.device)
    if args.shards:
        devices = [device] * args.shards

        def fresh_index():
            return ShardedIndex(cfg, devices, max_external_id=max_ext)

        def restore(mgr):
            idx, t = ShardedIndex.restore(mgr, cfg, devices)
            print(f"restored sharded checkpoint at tick {t} "
                  f"({idx.n_logical} logical shards on {idx.n_shards} "
                  f"devices)", flush=True)
            return idx, t

        make_engine = ShardedEngine
    else:
        def fresh_index():
            return StreamingIndex(cfg, mode=args.mode,
                                  max_external_id=max_ext, device=device)

        def restore(mgr):
            idx, t = StreamingIndex.restore(mgr, cfg, device=device)
            print(f"restored checkpoint at tick {t}", flush=True)
            return idx, t

        make_engine = StreamingEngine

    # one metrics object across crash / restore cycles: the summary
    # reflects everything this process served, replayed ticks included
    metrics = ServingMetrics()

    def make_front(idx):
        return ServingFront(
            make_engine(idx),
            deadline_s=args.deadline_ms * 1e-3,
            max_bucket=args.bucket,
            k=10,
            metrics=metrics,
        )

    t = 0
    if mgr is not None and mgr.latest() is not None:
        idx, t = restore(mgr)
    else:
        idx = fresh_index()
        if mgr is not None:
            idx.save(mgr, 0)
    front = make_front(idx)

    wall0 = time.perf_counter()
    while t < args.ticks:
        try:
            if kill_budget.get(t, 0) > 0:
                kill_budget[t] -= 1
                raise SimulatedFailure(f"injected kill at tick {t}")
            # writer lane: this tick's stream step as admitted updates
            ins_ids, vecs, del_ids = stream.step_at(t)
            front.submit_update(
                insert_batch(ins_ids, vecs, device=device),
                time.perf_counter()
            )
            if len(del_ids):
                front.submit_update(
                    delete_batch(del_ids, args.dim, device=device),
                    time.perf_counter()
                )
            # reader lane: admit queries one at a time; full buckets leave
            # on admission, the partial tail leaves at its deadline
            q = stream.queries_at(t, args.queries)
            for v in q:
                front.submit_query(v, time.perf_counter())
                front.pump(time.perf_counter())
            nd = front.next_event_time()
            if nd is not None:
                front.pump(nd)      # flush the tick's deadline tail
            if t % 10 == 0:
                line = f"tick {t:3d} {front.metrics.log_line()}"
                if not args.shards:
                    line += (f" recall@10={idx.recall(q, k=10):.3f}"
                             f" active={idx.n_active}")
                print(line, flush=True)
            t += 1
            if mgr is not None and t % args.checkpoint_every == 0:
                idx.save(mgr, t)
        except SimulatedFailure as e:
            if mgr is None:
                raise
            idx, t = restore(mgr)
            front = make_front(idx)
            print(f"crash ({e}); restored tick {t}, replaying", flush=True)

    s = metrics.stats(horizon_s=time.perf_counter() - wall0)
    label = f"shards={args.shards}" if args.shards else f"mode={args.mode}"
    print(
        f"served {args.ticks} ticks {label}: "
        f"q={s['n_queries']} p50={s['p50_ms']:.2f}ms "
        f"p99={s['p99_ms']:.2f}ms fill={s['batch_fill']:.2f} | "
        f"phase wall-clock: search={s['search_s']:.2f}s "
        f"update={s['update_s']:.2f}s publish={s['publish_s']:.2f}s "
        f"(snapshot reads: no consolidation latency spikes = "
        f"the paper's claim)"
    )
    return idx


if __name__ == "__main__":
    main()
