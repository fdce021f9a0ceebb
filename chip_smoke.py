#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, any failure exits non-zero:

  1. device and build: the card's name, count and power limit; build the
     hand-written kernels (``src/repro_torch/csrc``) with nvcc;
  2. kernel parity at the main path's shapes (n_cap = 10^6, D = 128, R = 64,
     l = 128, mv = 192, B = 512, H = 4): all six kernels (the f32 ones and
     the int8 twins over ``quantize_rows`` of the same tables) against
     their plain PyTorch versions, bitwise on grid-valued data (entries
     k/16, where every sum is exact in float32) and to rtol 1e-5 on
     Gaussian data; CUDA-event times of the wrapper call (the serial
     gather, the int8 gather and the fused hops through the launchers
     bound once per search, their public wrappers beside them; the batched
     gathers in turns with their yardsticks; the int8 gather at a hop's
     (B, R) tile and at the start column, K = 1), the plain version, a
     one-call PyTorch yardstick where one exists, the kernel's device-only
     time from a ``torch.profiler`` trace, and the bound from the bytes /
     flops the inputs need; where the gathers' host time goes, step by
     step; what the batched search's loop pays per super-step; the fused
     hops' status word against ``lane_active``; no spills in the
     redesigned kernels;
  3. the f32 main path end to end: ``ANNConfig(dim=128, n_cap=1_000_000)``
     on the card, a serial bootstrap, batched insert windows, Recall@10,
     in-place deletes with the Alg-6 sweep, reinserts, Recall@10 again, a
     timed query-only phase — with every kernel's launches counted;
 3c. on phase 3's index, ``search_batch_vmap`` (the reference's lockstep
     per-query engine, ``backend="cuda"``: kernel 1 a hop) over its 1,024
     queries in batches of 256, in turns with ``search_batch`` at
     ``hop_fused = 0`` and H = 4: on the Gaussian queries the ids, visited
     lists and counters equal H = 0's; on grid-valued queries over the same
     graph with grid-valued rows every field equals H = 4's and, for 64
     queries, the plain run's on a CPU copy; one kernel-1 launch a hop
     (plus the start's) and no other; QPS of the three engines, and one
     more batch of the vmap engine and of H = 0 under the profiler (the
     device's busy share, the largest kernels);
 3b. the quantized path at full width: ``StreamingIndex(ANNConfig(dim=128,
     n_cap=1_000_000, quantized=True), batch_updates=True)`` replaying a
     sliding-window runbook through ``run_runbook``; Recall@10 per eval, no
     deleted id returned, the returned distances bitwise equal to the f32
     rescore of the returned slots, both int8 kernels launched; then the
     same index's query-only phase at ``hop_fused = 0`` (the int8 gather
     on every hop) and at H = 4, batch by batch in turns: QPS and launches
     per batch of each, every result identical;
  4. short grid-data streams at test size, each sub-phase timed: the f32
     ``apply`` stream with backend "cuda" and "torch", a quantized
     ``StreamingIndex`` stream that grows through two capacity buckets
     with backend "cuda" (hop fusion off, so the int8 gather carries every
     hop, and on) and "torch", and the policy streams: fresh through an
     Alg-4 consolidation, local on the int8 tier at H = 0 and H = 4, HNSW
     through a delete-and-replace round; each must end in identical
     states and results;
  5. the fresh and local policies (``StreamingIndex(ANNConfig(dim=128,
     n_cap=1_000_000), mode=..., batch_updates=True)`` replaying a
     sliding window through ``run_runbook``) and the HNSW baseline
     (``HNSWIndex(HNSWConfig(dim=128, n_cap=1_000_000, m=48))`` through
     ``run_runbook(baseline="hnsw")``) at full width: average Recall@10
     >= 0.90, no deleted id returned, fresh consolidated (and, after a
     forced pass, no tombstone and no edge into an inactive slot), local
     with nothing pending after any delete and no such edge, HNSW reusing
     tombstoned slots; updates/s, QPS, launches and peak memory of each.
     Phase 2 also holds kernels 3 and 2 at the HNSW shapes (r = 96 with
     two staging rounds, and r = 48 at l = 1);
  6. whole-segment update streams and durability at full width (a
     10^6-slot f32 handle with 1,024 live points):
     (a) 16 kind-major ops of 32 inserts and 32 deletes through
     ``run_segments(plan_segments(..., max_t=8))`` against ``apply`` plus
     the trigger op by op, for ip, fresh and local: every leaf and result
     row identical, a mid-segment trigger for ip and fresh, nothing
     pending under local; (b) ``run_runbook(segmented=True)`` against the
     per-op ``run_runbook`` (ip, serial updates, a 160-point sliding
     window): the same evals, counters and final state; (c)
     ``run_segments_supervised`` on (a)'s ip plan with a failure and a
     kill inside a save, bitwise at (a)'s end, and a
     ``StreamingIndex.save`` / ``restore`` round trip onto the card:
     identical leaves and a 1,024-query search; seconds per save and
     restore and bytes per checkpoint;
  7. the serving front door (``repro_torch.serving``) over clones of
     phase 6's start state: (a) for ip, fresh and local, 8 queries served
     from snapshot 0 are bitwise the same after the writer inserts at
     their locations, deletes their top-1 ids and forces the policy's
     consolidation, and after a publish top-1 is the new ids and no
     deleted id comes back; publish ms against its bound, peak memory;
     (b) open-loop Poisson load at half the capacity of one warm 64-query
     dispatch (``benchmarks/serve_bench.py``'s three workloads:
     query_only, mixed, mixed_serialized; 8 update batches of 32 lanes):
     p50 / p95 / p99, QPS, fill, depth; mixed p99 within 1.5x + 2 ms of
     query-only p99 and Recall@10 of the final snapshot's answers >= 0.90
     against ``topk_score``; (c) ``repro_torch.launch.serve`` at D = 128,
     plain and killed at tick 6 with a checkpoint every 4 ticks: the
     replayed run ends at the plain run's state;
  8. the sharded index (``repro_torch.core.ShardedIndex``): L = 4 logical
     rows of 2^18 slots at D = 128 (1,048,576 slots in all): (a) 256
     serial inserts through ``insert`` and a checkpoint; (b) the
     checkpoint restored onto one card as S = 1 and S = 2 (and onto two
     cards where there are two) with ``sequential=False``, each fed one
     ``update_stream`` of 768 inserts and 256 deletes in 64-lane steps:
     every leaf of every row bitwise equal across layouts; (c) 1,024
     queries at B = 256 with both search partitions on every layout: the
     same ids, rows and distances, equal to a host merge of the per-row
     ``search`` answers, Recall@10 >= 0.90 against ``topk_score`` over the
     union of the rows, no deleted id; (d) one batch under replicate
     routing equal to compact routing, and a two-row ``fresh`` index
     through a delete-heavy stream: consolidated, nothing pending, no
     edge into an inactive slot; (e) ``ServingFront(ShardedEngine(...))``
     snapshot isolation and read-your-writes, publish ms against its
     bound, and ``repro_torch.launch.serve --shards 2`` plain and killed:
     equal rows;
  9. the recsys family and the two-tower retrieval path: (a) each arch at
     its published widths (two-tower-retrieval, dlrm-rm2, din; dlrm-mlperf
     with each Criteo-1TB table capped at 2^23 rows, 23.6 GB, since the
     96.1 GB of whole tables do not fit one card) through
     ``spec.make_step`` at ``serve_p99``, ``serve_bulk`` and
     ``retrieval_cand`` (din's 10^6 candidates in four slices): ms per
     step (warm, median of 5), peak memory, every score finite,
     ``serve_p99`` and two-tower's ``retrieval_cand`` equal to the same
     step on a CPU copy; (c) the twin of ``examples/distributed_serving.py``
     over two-tower's 1,000,448 item embeddings (D = 256, ip): path A,
     kernel 4 for 1,024 user vectors against its plain version, and path
     B, ``ShardedIndex(high_recall(256, 2^18, "ip"), n_logical=4)`` fed
     256 serial inserts, 1,792 streamed in 64-lane steps and 1,024
     in-place deletes, queried under both partitions (equal to a host
     merge of the per-row searches, no deleted id; Recall@10 against
     kernel 4 before and after the deletes), kernels 1-4 launched; (b)
     kernels 1-3 at D = 256 under ip against their plain versions (grid
     data bitwise; the gathers timed cold, each call on a new tile of ids
     whose rows the L2 does not hold, and warm).  The kernels' launches
     on the recsys path are counted over paths A and B up to the end of
     B's own searches, before its checks and the recall oracle;
 10. training (``repro_torch.training`` through ``spec.make_step`` on
     ``train`` shapes): (a) the four recsys archs' ``train_batch`` steps
     (B = 65,536) at their published widths (dlrm-mlperf's tables capped at
     2^22 rows: parameters, dense gradients and AdamW's moments hold four
     copies), (b) gcn-cora's four shapes at full width (``minibatch_lg``'s
     hops from the port's sampler on the card, every sampled id checked as
     a neighbour of its parent in the CSR it was drawn from): per cell the
     first step, then 5 steps on the same batch, ms per step (CUDA events,
     warm, median of 5), TFLOP/s of ``model_flops``, peak memory, the loss
     finite and lower after them, then 3 steps under ``torch.profiler``
     for the device time by kernel group and the idle share; after the
     first step, 4,096 embedding rows per table that no id read equal
     ``p - lr * (wd * p)`` bitwise;
     no kernel of ``csrc`` launched; every reduced train step equal to its
     CPU copy over two steps (the tolerance of
     ``repro_torch.training.tolerance``, as in the CPU tests); (c)
     ``adamw_update`` (float32 and bfloat16 moments) and
     ``compressed_psum`` over four per-device gradients on the card against
     the CPU;
 11. the LM family (``repro_torch.models.transformer`` through
     ``spec.make_step``): (a) the five archs at their published widths at
     ``prefill_32k`` and ``decode_32k`` (S = 32,768): olmo-1b with its 16
     layers (prefill B = 2 through the chunked attention, decode B = 8
     over a 34.4 GB cache), the other four with their first 1-2 layers
     (``LM_SERVE``): ms a step (CUDA events, warm median), tokens/s,
     TFLOP/s of ``model_flops``, peak memory, every logit finite; on
     olmo-1b whole, ``prefill`` of 30,720 tokens then ``decode_step``
     against ``forward``'s row 30,720 over 32,768 tokens (B = 1), within
     the tolerance the CPU tests pin (``LOGITS[bfloat16]``); (b) train_4k
     for olmo-1b (16 layers, B = 4, remat) and qwen3-moe-30b-a3b (2 layers,
     B = 8, accum_steps 8): the first step, then 5 on the same batch, the
     loss finite and lower; (c) every reduced prefill, decode and train
     step against its CPU copy; (d) ``repro_torch.launch.train --steps
     30`` plain and ``--supervise --fail-at 12``: bitwise the same final
     state; no kernel of ``csrc`` launched;
 12. the mesh (``repro_torch.launch.mesh``, the ``*_shardings`` rules,
     ``make_step(shape, axes)``): (a) under a one-rank NCCL group and a 1x1
     ("data", "model") mesh on the card, olmo-1b's train_4k (phase 11b's
     cut) and decode_32k (phase 11a's cut: 16 layers, B = 8),
     two-tower's retrieval_cand (10^6 candidates, two-phase top-k) and
     train_batch, dlrm-rm2's serve_p99 and train_batch (B = 65,536) with
     their state and inputs placed as DTensors by ``state_shardings`` /
     ``input_shardings``: bitwise equal to the same step on plain tensors,
     ms a step of each and peak bytes; the train cells' bytes and FLOPs
     (``FlopCounterMode``) counted; (b) ``Supervisor.run(shardings=...)``
     over olmo-1b's reduced train step with an injected failure: restored
     onto the placements, bitwise at the uninterrupted run's end; (c)
     host-side, ``launch.dryrun.run_cell`` on a fake 16x16 mesh at full
     size for two-tower's retrieval_cand and train_batch, olmo-1b's
     decode_32k and train_4k, dlrm-rm2's train_batch and gcn-cora's
     ogb_products (each ``ok``, its per-device argument bytes equal to
     the specs' shard shapes and to the PyTorch 2.13 sweep's record), and
     for (a)'s olmo-1b train cell on a fake 1x1 mesh, whose argument bytes
     and FLOPs equal the card's exactly; (d) host-side, the split-mesh
     cases of ``tests/test_torch_mesh.py`` (``tests/torch_mesh_worker.py``
     ``SPLIT``: reduced cells whose leaves divide (2, 2)) on a real (2, 2)
     mesh of four gloo ranks made by ``launch.mesh.spawn``, each gathered
     result within its tolerance of the plain step; no kernel of ``csrc``
     launched.

Prints the kernels line, the card's name and power limit, and last the
``{"ok": true, "device": ...}`` line; the full record goes to
``chiprun_out/chip_smoke.json``.  Usage: ``python3 chip_smoke.py [--seed S]
[--live N] [--runbook-n N] [--policy-n N] [--hnsw-n N]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
# each TPU kernel's pl.pallas_call line, and the line of the def around it
TPU_SITES = {
    "gather_distance_batched": "src/repro/kernels/gather_distance.py:186",
    "gather_distance": "src/repro/kernels/gather_distance.py:104",
    "beam_hop_fused": "src/repro/kernels/beam_hop.py:315",
    "topk_score": "src/repro/kernels/topk_score.py:110",
    "gather_distance_batched_q": "src/repro/kernels/quant_gather.py:113",
    "beam_hop_fused_q": "src/repro/kernels/beam_hop.py:467",
}
TPU_DEFS = {
    "gather_distance_batched": "src/repro/kernels/gather_distance.py:144",
    "gather_distance": "src/repro/kernels/gather_distance.py:66",
    "beam_hop_fused": "src/repro/kernels/beam_hop.py:245",
    "topk_score": "src/repro/kernels/topk_score.py:86",
    "gather_distance_batched_q": "src/repro/kernels/quant_gather.py:71",
    "beam_hop_fused_q": "src/repro/kernels/beam_hop.py:406",
}
SOURCES = {
    "gather_distance_batched": "src/repro_torch/csrc/gather_distance.cu",
    "gather_distance": "src/repro_torch/csrc/gather_distance.cu",
    "beam_hop_fused": "src/repro_torch/csrc/beam_hop.cu",
    "topk_score": "src/repro_torch/csrc/topk_score.cu",
    "gather_distance_batched_q": "src/repro_torch/csrc/quant_gather.cu",
    "beam_hop_fused_q": "src/repro_torch/csrc/beam_hop.cu",
}
# the CUDA kernels (by name) each wrapper launches, for the device times
DEVICE_KERNELS = {
    "gather_distance_batched": ("gather_distance_kernel",),
    "gather_distance": ("gather_one_kernel",),
    "beam_hop_fused": ("beam_hop_kernel",),
    "topk_score": ("topk_partial_kernel", "topk_merge_kernel"),
    "gather_distance_batched_q": ("quant_gather_block_kernel",),
    "beam_hop_fused_q": ("beam_hop_kernel",),
}
# kernels redesigned for Hopper whose ptxas report must show no spills
NO_SPILL = ("topk_partial_kernel", "gather_one_kernel", "beam_hop_kernel",
            "quant_gather_block_kernel")
# the fields of a search result compared exactly on Gaussian data
EXACT_FIELDS = ("topk_ids", "visited_ids", "n_visited", "n_comps", "n_hops")
# the kernels each path must launch
F32_PATH = ("gather_distance_batched", "gather_distance", "beam_hop_fused",
            "topk_score")
QUANT_PATH = ("gather_distance_batched_q", "beam_hop_fused_q",
              "gather_distance_batched", "gather_distance", "topk_score")


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def bound_ms(bytes_, flops):
    t_b = bytes_ / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def cuda_ms(fn, reps, warmup=2, setup=None):
    """Mean device ms of ``fn(x)`` over ``reps`` runs, each on a fresh input
    from ``setup()`` (made outside the timed region)."""
    import torch

    for _ in range(warmup):
        fn(setup() if setup else None)
    total = 0.0
    for _ in range(reps):
        x = setup() if setup else None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(x)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def interleaved_ms(fns, reps):
    """Median ms (CUDA events around one call) of each of ``fns``, their
    calls alternating over one window, so that each sees the same host."""
    import statistics

    import torch

    for fn in fns:
        fn()
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
    return [statistics.median(ts) for ts in times]


# the ``names`` of each device_ms reading that came from spun CUDA events,
# because the profiler's traces held no record of them
DEVICE_MS_BY_EVENTS = []


def spun_event_ms(fn, reps, setup=None):
    """Device ms per ``fn(x)`` call from CUDA events around ``reps`` calls
    queued behind a spin kernel, so that the card runs them back to back
    and the host's launch time stays out (inputs from ``setup()`` made
    beforehand).  The spin lasts twice a first, synchronised pass of the
    same calls; if the host still took longer to launch them, the time
    holds the card's waits and that is logged."""
    import torch

    xs = [setup() if setup else None for _ in range(reps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xs:
        fn(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    xs = [setup() if setup else None for _ in range(reps)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    # the spin counts clock cycles; at most 2 GHz, so it lasts >= 2 first_s
    torch.cuda._sleep(int(4e9 * first_s) + 100_000)
    ev[1].record()
    t0 = time.perf_counter()
    for x in xs:
        fn(x)
    launch_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if launch_ms > ev[0].elapsed_time(ev[1]):
        log(f"spun_event_ms: the launches took {launch_ms:.3f} ms, longer "
            f"than the spin; the time holds the card's waits")
    return ev[1].elapsed_time(ev[2]) / reps


def device_ms(fn, reps, names, setup=None):
    """Mean device-only ms per ``fn(x)`` call of the CUDA kernels whose names
    contain one of ``names``, from a ``torch.profiler`` trace of ``reps``
    calls (copies made by ``setup`` are not counted): for each name, the
    mean over the kernel records the trace holds, times its launches per
    call, so that a trace holding fewer records than launches cannot make
    a kernel read fast; a shortfall is logged.  A trace that shows none of
    those kernels is taken again, three traces in all; when none of them
    does (the card's traces at times hold only the host's side of a run),
    the time is ``spun_event_ms`` of the same calls, which counts the
    card's gaps between them too, and ``names`` goes into
    ``DEVICE_MS_BY_EVENTS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(setup() if setup else None)
    torch.cuda.synchronize()
    traces = 3
    for _ in range(traces):
        xs = [setup() if setup else None for _ in range(reps)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in xs:
                fn(x)
            torch.cuda.synchronize()
        us, seen = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            for nm in names:
                if nm in ev.key and t > 0:
                    us[nm] += t
                    seen[nm] += ev.count
        if any(seen.values()):
            short = {nm: c for nm, c in seen.items() if 0 < c < reps}
            if short:
                log(f"device_ms: the trace holds {short} records of "
                    f"{reps} calls")
            return sum(us[nm] / c * max(1, round(c / reps))
                       for nm, c in seen.items() if c) / 1e3
    held = sorted({ev.key[:60] for ev in prof.key_averages()})
    log(f"device_ms: the profiler saw no device time for {names} in "
        f"{traces} traces (the last one holds {held}); timed by spun CUDA "
        f"events instead")
    DEVICE_MS_BY_EVENTS.append(tuple(names))
    return spun_event_ms(fn, reps, setup)


def gather_host_split(ids, q, vec, norms, reps=2000):
    """Where one call of the single-query gather spends its host time: mean
    us of each step of the public ``gather_distance_cuda`` and of the
    bound launcher's call, each step repeated ``reps`` times on its own."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import gather_distance as gd

    lib = build.lib("gather_distance")
    i2 = ids.reshape(1, -1).contiguous()
    q2 = q.reshape(1, -1).contiguous()
    out = torch.empty((1, ids.shape[0]), dtype=torch.float32, device="cuda")
    bound = gd.BoundGather(q, vec, norms)

    def checks():
        for t, what in ((q2, "queries"), (vec, "vectors"), (norms, "norms")):
            build.require_dtype(t, torch.float32, what)
        build.require_dtype(i2, torch.int32, "ids")
        b, k = i2.shape
        return q2.shape == (b, vec.shape[1]) and norms.shape == vec.shape[:1]

    args = (i2.data_ptr(), q2.data_ptr(), vec.data_ptr(), norms.data_ptr(),
            out.data_ptr(), 1, i2.shape[1], vec.shape[0], vec.shape[1], 1,
            build.stream(i2))

    steps = {
        "reshape_contiguous": lambda: (ids.reshape(1, -1).contiguous(),
                                       q.reshape(1, -1).contiguous()),
        "require_cuda": lambda: build.require_cuda(i2, q2, vec, norms),
        "dtype_shape_checks": checks,
        "torch_empty": lambda: torch.empty((1, ids.shape[0]),
                                           dtype=torch.float32,
                                           device=ids.device),
        "build_lib": lambda: build.lib("gather_distance"),
        "build_stream": lambda: build.stream(i2),
        "data_ptrs": lambda: [build.ptr(t) for t in (i2, q2, vec, norms,
                                                     out)],
        "ctypes_launch": lambda: lib.gather_one_launch(*args),
        "index_0": lambda: out[0],
        "public_call": lambda: gd.gather_distance_cuda(ids, q, vec, norms),
        "bound_call": lambda: bound(ids),
    }
    return time_steps(steps, reps)


def batched_host_split(ids, qb, vec, norms, reps=2000):
    """The same split for one call of the batched gather's public wrapper,
    ``gather_distance_batched_cuda``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import gather_distance as gd

    lib = build.lib("gather_distance")
    out = torch.empty(ids.shape, dtype=torch.float32, device="cuda")

    def checks():
        build.require_dtype(ids, torch.int32, "ids")
        for t, what in ((qb, "queries"), (vec, "vectors"), (norms, "norms")):
            build.require_dtype(t, torch.float32, what)
        return qb.shape == (ids.shape[0], vec.shape[1]) and \
            norms.shape == vec.shape[:1]

    args = (ids.data_ptr(), qb.data_ptr(), vec.data_ptr(), norms.data_ptr(),
            out.data_ptr(), ids.shape[0], ids.shape[1], vec.shape[0],
            vec.shape[1], 1, build.stream(ids))
    steps = {
        "contiguous": lambda: (ids.contiguous(), qb.contiguous()),
        "require_cuda": lambda: build.require_cuda(ids, qb, vec, norms),
        "dtype_shape_checks": checks,
        "torch_empty": lambda: torch.empty(ids.shape, dtype=torch.float32,
                                           device=ids.device),
        "build_lib": lambda: build.lib("gather_distance"),
        "build_stream": lambda: build.stream(ids),
        "data_ptrs": lambda: [build.ptr(t) for t in (ids, qb, vec, norms,
                                                     out)],
        "ctypes_launch": lambda: lib.gather_distance_launch(*args),
        "public_call": lambda: gd.gather_distance_batched_cuda(ids, qb, vec,
                                                               norms),
    }
    return time_steps(steps, reps)


def time_steps(steps, reps):
    """Mean host us of each step, repeated ``reps`` times on its own."""
    import torch

    res = {}
    for name, fn in steps.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        res[name] = (time.perf_counter_ns() - t0) / reps / 1e3
        torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_table(n, d, grid, gen):
    import torch

    if grid:
        return torch.randint(-64, 65, (n, d), generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.float32) / 16
    return torch.randn((n, d), generator=gen, device="cuda")


def hop_parity(name, plain, kern, bind, qb, static, starts, d0, grid,
               n_cap, l, mv, h, row_bytes, steps=8, timed=True):
    """A fused hop kernel against its plain version over ``steps``
    super-steps from a fresh search carry, each step fed the plain output:
    bitwise on grid data, else distances to rtol 1e-5 with at most 1% of
    lanes diverging.  Each step also holds the launcher bound once per
    search (``bind(qb, carry)``) to the public one, bit for bit, and the
    status word to the carry: never unsorted, and active exactly when
    ``lane_active`` finds an active lane in what the kernel left.  On
    Gaussian data (and ``timed``) also its times (``ms`` through the bound
    launcher, ``public_ms`` through the public one) and bound."""
    import torch

    from repro_torch.core import bitset
    from repro_torch.kernels import beam_hop as bh

    b = qb.shape[0]
    d = qb.shape[1]
    r = static[0].shape[1]
    bi = torch.full((b, l), -1, dtype=torch.int32, device="cuda")
    bi[:, 0] = starts
    bd = torch.full((b, l), float("inf"), device="cuda")
    bd[:, 0] = d0
    seen = bitset.setbits_rows(
        bitset.empty_rows(b, n_cap, "cuda"),
        starts.clamp(min=0).long()[:, None], (starts >= 0)[:, None])
    carry = (bi, bd, torch.zeros_like(bi), seen,
             torch.full((b, mv), -1, dtype=torch.int32, device="cuda"),
             torch.full((b, mv), float("inf"), device="cuda"),
             torch.zeros((b,), dtype=torch.int32, device="cuda"),
             (starts >= 0).to(torch.int32),
             torch.zeros((b,), dtype=torch.int32, device="cuda"))
    diverged = 0
    max_err = 0.0
    for step in range(steps):
        p = plain(qb, *carry, *static, h=h)
        kc = tuple(t.clone() for t in carry)
        status = torch.zeros(1, dtype=torch.int32, device="cuda")
        k_out = kern(qb, *kc, *static, h=h, status=status)
        bc = tuple(t.clone() for t in carry)
        bound = bind(qb, bc)
        bound(bc)
        torch.cuda.synchronize()
        word = int(status[0])
        bi2, bd2, be2 = k_out[:3]
        still = bool((((bi2 >= 0) & (be2 == 0) & torch.isfinite(bd2)).any(1)
                      & (k_out[8] < mv)).any())
        check(not word & bh.STATUS_UNSORTED,
              f"{name}: unsorted beam reported at step {step}")
        check(bool(word & bh.STATUS_ACTIVE) == still == bound.active(),
              f"{name}: status active bit wrong at step {step}")
        check(all(torch.equal(x, y) for x, y in zip(bc, k_out)),
              f"{name}: bound launcher differs from the public one at "
              f"step {step}")
        same_lane = torch.ones((b,), dtype=torch.bool, device="cuda")
        for x, y in zip(k_out, p):
            if x.dtype == torch.float32:
                fin = torch.isfinite(y)
                same_lane &= (torch.isfinite(x) == fin).reshape(b, -1).all(1)
                if fin.any():
                    max_err = max(max_err, float((x[fin] - y[fin]).abs()
                                                 .max()))
                ok = torch.isclose(x, y, rtol=1e-5, atol=1e-4) | ~fin
            else:
                ok = x == y
            same_lane &= ok.reshape(b, -1).all(1)
        bad = int((~same_lane).sum())
        if grid:
            check(bad == 0 and all(torch.equal(x, y)
                                   for x, y in zip(k_out, p)),
                  f"{name}: grid data not bitwise at step {step}")
        diverged = max(diverged, bad)
        carry = p
    check(diverged <= b // 100, f"{name}: {diverged} of {b} lanes diverge")
    out = {"max_abs_err": max_err, "diverged_lanes": diverged}
    if not grid and timed:
        # time one super-step from the mid-search carry of the last step
        c0 = tuple(t.clone() for t in carry)
        pc = plain(qb, *c0, *static, h=h)
        dcomp = int((pc[7] - c0[7]).sum())
        dhop = int((pc[8] - c0[8]).sum())
        bc = tuple(t.clone() for t in c0)
        bound = bind(qb, bc)

        def reset():
            for x, y in zip(bc, c0):
                x.copy_(y)
            return bc

        status = torch.zeros(1, dtype=torch.int32, device="cuda")
        ms = cuda_ms(bound, 10, setup=reset)
        public_ms = cuda_ms(lambda c: kern(qb, *c, *static, h=h,
                                           status=status), 10,
                            setup=lambda: tuple(t.clone() for t in c0))
        dms = device_ms(lambda c: kern(qb, *c, *static, h=h, status=status),
                        10, DEVICE_KERNELS[name],
                        setup=lambda: tuple(t.clone() for t in c0))
        pms = cuda_ms(lambda c: plain(qb, *c, *static, h=h), 3,
                      setup=lambda: c0)
        loop = loop_step_ms(bound, reset, kern, qb, static, h, c0, mv)
        carry_bytes = b * (l * 12 * 2 + mv * 8 + 24 + d * 4)
        by = dcomp * row_bytes + dhop * (4 * r + 8 * r + 8) + carry_bytes
        bms, bby = bound_ms(by, dcomp * 2 * d)
        out.update(ms=ms, public_ms=public_ms, device_ms=dms, plain_ms=pms,
                   library_ms=None, bound_ms=bms, bound_by=bby,
                   rows_gathered=dcomp, hops=dhop, **loop)
    return out


def loop_step_ms(bound, reset, kern, qb, static, h, c0, mv, reps=20):
    """What the batched search's loop pays per super-step, on the host's
    clock to the end of its host read (medians of ``reps``): through the
    bound launcher (the launch, then ``active()``'s read of the status
    word), and as the loop did it through the public launcher (the int32
    copy of ``beam_exp``, the launch, the bool copy back, ``lane_active``'s
    ops and their host read)."""
    import statistics

    import torch

    def bound_step(c):
        bound(c)
        return bound.active()

    status = torch.zeros(1, dtype=torch.int32, device="cuda")

    def public_step(c):
        bi, bd, be_bool = c[0], c[1], c[2] != 0
        exp = be_bool.to(torch.int32)
        out = kern(qb, bi, bd, exp, *c[3:], *static, h=h, status=status)
        be = out[2] != 0
        return bool(((((out[0] >= 0) & ~be & torch.isfinite(out[1])).any(1))
                     & (out[8] < mv)).any())

    res = {}
    for key, step, setup in (
        ("loop_step_ms", bound_step, reset),
        ("public_loop_step_ms", public_step,
         lambda: tuple(t.clone() for t in c0)),
    ):
        times = []
        for _ in range(reps):
            c = setup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(c)
            times.append((time.perf_counter() - t0) * 1e3)
        res[key] = statistics.median(times)
    return res


def quant_gather_parity(ids, qb, qtab, grid, yardstick):
    """Kernel 5 (bound launcher and public wrapper) against its plain
    version at (B, R) and (B, 1): bitwise on grid data, else to rtol 1e-5;
    the bound launcher bit for bit the public one.  On Gaussian data also
    the times: the bound call, the public wrapper and the yardstick
    (medians of 200 in turns), the device time and the bound."""
    import torch

    from repro_torch.kernels import quant_gather as qg

    b, d = qb.shape
    bound = qg.BoundQuantGather(qb, *qtab)
    out = {}
    for name, tile in (("gather_distance_batched_q", ids),
                       ("gather_distance_batched_q[K=1]",
                        ids[:, :1].contiguous())):
        a = bound(tile)
        pub = qg.gather_distance_batched_q_cuda(tile, qb, *qtab)
        p = qg.gather_distance_batched_q_plain(tile, qb, *qtab)
        torch.cuda.synchronize()
        fin = torch.isfinite(p)
        check(torch.equal(torch.isfinite(a), fin), f"{name}: inf mask")
        check(torch.equal(a, pub), f"{name}: bound launcher differs from "
              f"the public wrapper")
        err = float((a[fin] - p[fin]).abs().max()) if fin.any() else 0.0
        if grid:
            check(torch.equal(a, p), f"{name}: grid data not bitwise")
        else:
            check(torch.allclose(a[fin], p[fin], rtol=1e-5, atol=1e-4),
                  f"{name}: gaussian max err {err}")
        out[name] = {"max_abs_err": err, "shape": list(tile.shape)}
        if grid:
            continue
        nvalid = int((tile >= 0).sum())
        # gathered rows with their scale and qnorm, ids, outputs, queries
        by = nvalid * (d + 8) + tile.numel() * 8 + b * d * 4
        bms, bby = bound_ms(by, nvalid * 2 * d)
        i2 = tile.clamp(min=0).long()
        q2 = qb.reshape(b, d, 1)
        ms, public_ms, lms = interleaved_ms(
            [lambda: bound(tile),
             lambda: qg.gather_distance_batched_q_cuda(tile, qb, *qtab),
             lambda: yardstick(i2, q2)], 200)
        dms = device_ms(lambda _: bound(tile), 50,
                        DEVICE_KERNELS["gather_distance_batched_q"])
        pms = cuda_ms(lambda _: qg.gather_distance_batched_q_plain(
            tile, qb, *qtab), 20)
        out[name].update(
            ms=ms, public_ms=public_ms, device_ms=dms, plain_ms=pms,
            library_ms=lms, bound_ms=bms, bound_by=bby,
            launch_shape=list(qg.launch_shape(*tile.shape, d)),
            timing="interleaved medians, 200 each (bound, public, "
                   "yardstick)",
            library_call="torch.bmm(codes[ids].float(), q) * scale[ids]")
    return out


def kernel_phase(seed, n_cap=1_000_000, d=128, r=64, l=128, b=512, h=4,
                 q_topk=1024, k=10):
    import torch

    from repro_torch.core import bitset
    from repro_torch.core.quant import init_quant_store, quant_write_rows
    from repro_torch.kernels import beam_hop as bh
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import quant_gather as qg
    from repro_torch.kernels import topk_score as tk

    mv = l + 64
    rows = {}
    gen = torch.Generator(device="cuda")
    for data in ("grid", "gauss"):
        grid = data == "grid"
        gen.manual_seed(seed + (0 if grid else 1))
        vec = make_table(n_cap, d, grid, gen)
        norms = (vec * vec).sum(1)
        qi = torch.randint(0, n_cap, (max(b, q_topk),), generator=gen,
                           device="cuda")
        # grid queries stay on the 1/16 grid, so every sum stays exact
        noise = (torch.randint(-2, 3, (qi.shape[0], d), generator=gen,
                               device="cuda").to(torch.float32) / 16
                 if grid else make_table(qi.shape[0], d, grid, gen) / 16)
        queries = (vec[qi] + noise).contiguous()
        ids = torch.randint(0, n_cap, (b, r), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[torch.rand((b, r), generator=gen, device="cuda") < 0.1] = -1
        qb = queries[:b].contiguous()
        res = {}

        # ---- kernels 1, 2 and 5: gather + distance, f32 and int8 ----------
        store = quant_write_rows(init_quant_store(n_cap, d, "cuda"),
                                 torch.arange(n_cap, device="cuda"), vec)
        qtab = (store.codes, store.scale, store.qnorms)

        def f32_lib(i2, q2):
            return torch.bmm(vec[i2], q2)

        def int8_lib(i2, q2):
            return torch.bmm(store.codes[i2].float(), q2).squeeze(-1) \
                * store.scale[i2]

        # kernel 2 as the serial search calls it: bound once per search
        bound = {nm: gd.BoundGather(qb[0], vec, nrm)
                 for nm, nrm in (("gather_distance", norms),
                                 ("gather_distance[no norms]", None))}

        # (name, args, plain, kernel, bytes per gathered row, yardstick)
        for name, args, plain, kern, row_bytes, lib in (
            ("gather_distance_batched", (ids, qb, vec, norms),
             gd.gather_distance_batched_plain,
             gd.gather_distance_batched_cuda, 4 * d + 8,
             ("torch.bmm(vectors[ids], q)", f32_lib)),
            ("gather_distance", (ids[0], qb[0], vec, norms),
             gd.gather_distance_plain,
             lambda i, *_, metric: bound["gather_distance"](i), 4 * d + 8,
             ("torch.bmm(vectors[ids], q)", f32_lib)),
            ("gather_distance[no norms]", (ids[0], qb[0], vec, None),
             gd.gather_distance_plain,
             lambda i, *_, metric: bound["gather_distance[no norms]"](i),
             4 * d, None),
        ):
            a = kern(*args, metric="l2")
            p = plain(*args, metric="l2")
            torch.cuda.synchronize()
            fin = torch.isfinite(p)
            check(torch.equal(torch.isfinite(a), fin), f"{name}: inf mask")
            err = float((a[fin] - p[fin]).abs().max()) if fin.any() else 0.0
            if grid:
                check(torch.equal(a, p), f"{name}: grid data not bitwise")
            else:
                check(torch.allclose(a[fin], p[fin], rtol=1e-5, atol=1e-4),
                      f"{name}: gaussian max err {err}")
            res[name] = {"max_abs_err": err}
            if name in bound:
                # the single-query kernel, bound or through the public
                # wrapper, gives the batched kernel's bits for the pair
                row = gd.gather_distance_batched_cuda(
                    ids[:1], qb[:1], vec, args[3])[0]
                pub = gd.gather_distance_cuda(*args)
                check(torch.equal(a, row) and torch.equal(pub, row),
                      f"{name}: not bitwise equal to kernel 1's row")
            if not grid and lib is not None:
                nvalid = int((args[0] >= 0).sum())
                nq = args[1].numel() // d
                # gathered rows with their per-row terms, ids, outputs,
                # queries
                by = nvalid * row_bytes + args[0].numel() * 8 + nq * d * 4
                bms, bby = bound_ms(by, nvalid * 2 * d)
                i2 = args[0].reshape(-1, r).clamp(min=0).long()
                q2 = args[1].reshape(-1, d, 1)
                if name == "gather_distance_batched":
                    # the wrapper and its yardstick in turns, medians: the
                    # comparison is of host costs and swings with the host
                    ms, lms = interleaved_ms(
                        [lambda: kern(*args, metric="l2"),
                         lambda: lib[1](i2, q2)], 200)
                    res[name]["timing"] = "interleaved medians, 200 each"
                    res[name]["host_split_us"] = batched_host_split(*args)
                else:
                    ms = cuda_ms(lambda _: kern(*args, metric="l2"), 50)
                    lms = cuda_ms(lambda _: lib[1](i2, q2), 20)
                dms = device_ms(lambda _: kern(*args, metric="l2"), 50,
                                DEVICE_KERNELS[name])
                pms = cuda_ms(lambda _: plain(*args, metric="l2"), 20)
                res[name].update(ms=ms, device_ms=dms, plain_ms=pms,
                                 library_ms=lms, bound_ms=bms, bound_by=bby,
                                 library_call=lib[0])
                if name == "gather_distance":
                    res[name]["public_ms"] = cuda_ms(
                        lambda _: gd.gather_distance_cuda(*args), 50)
                    res[name]["host_split_us"] = gather_host_split(*args)

        # kernel 5 at the two shapes the quantized search gives it: a hop's
        # (B, R) tile (every hop at H = 0) and the start column (K = 1, once
        # per batched search), through the launcher bound once per search,
        # with the public wrapper and the yardstick in turns
        res.update(quant_gather_parity(ids, qb, qtab, grid, int8_lib))

        # ---- kernels 3 and 6: fused beam super-step, f32 and int8 ---------
        adj = torch.randint(0, n_cap, (n_cap, r), generator=gen,
                            device="cuda", dtype=torch.int32)
        adj[torch.rand((n_cap, r), generator=gen, device="cuda") < 0.15] = -1
        nav = torch.rand((n_cap,), generator=gen, device="cuda") < 0.98
        ret = nav & (torch.rand((n_cap,), generator=gen, device="cuda") < 0.95)
        nav_w, ret_w = bitset.pack_bits(nav), bitset.pack_bits(ret)
        start = int(torch.nonzero(ret)[0])
        lanes_valid = torch.arange(b, device="cuda") % 17 != 5  # masked lanes
        starts = torch.where(lanes_valid, start, -1).to(torch.int32)
        def bind_f32(q, c):
            return bh.BoundBeamHop(q, c, adj, vec, norms, nav_w, ret_w, h=h)

        def bind_q(q, c):
            return bh.BoundBeamHop(q, c, adj, store.codes, store.qnorms,
                                   nav_w, ret_w, h=h, scales=store.scale)

        for name, plain, kern, bind, tables, row_bytes, d0_fn in (
            ("beam_hop_fused", bh.beam_hop_fused_plain,
             bh.beam_hop_fused_cuda, bind_f32, (vec, norms), 4 * d + 4,
             lambda st: gd.gather_distance_batched_plain(st, qb, vec, norms)),
            ("beam_hop_fused_q", bh.beam_hop_fused_q_plain,
             bh.beam_hop_fused_q_cuda, bind_q, qtab, d + 8,
             lambda st: qg.gather_distance_batched_q_plain(st, qb, *qtab)),
        ):
            static = (adj, *tables, nav_w, ret_w)
            res[name] = hop_parity(name, plain, kern, bind, qb, static,
                                   starts, d0_fn(starts[:, None])[:, 0],
                                   grid, n_cap, l, mv, h, row_bytes)

        # ---- kernels 3 and 2 at the HNSW baseline's shapes ----------------
        res.update(hnsw_kernel_parity(gen, qb, vec, norms, nav, nav_w, ret_w,
                                      lanes_valid, grid, n_cap, h))

        # ---- kernel 4: brute-force top-k ----------------------------------
        qt = queries[:q_topk].contiguous()
        bias = torch.where(torch.rand((n_cap,), generator=gen,
                                      device="cuda") < 0.1,
                           float("inf"), 0.0).to(torch.float32)
        kv, ki = tk.topk_score_cuda(qt, vec, norms, bias, k=k)
        pv, pi = tk.topk_score_plain(qt, vec, norms, bias, k=k)
        torch.cuda.synchronize()
        fin = torch.isfinite(pv)
        err = float((kv[fin] - pv[fin]).abs().max())
        if grid:
            check(torch.equal(kv, pv) and torch.equal(ki, pi),
                  "topk_score: grid data not bitwise")
            bad = 0
        else:
            check(torch.allclose(kv, pv, rtol=1e-5, atol=1e-4),
                  f"topk_score: gaussian max err {err}")
            bad = int((~(ki == pi).all(1)).sum())
            check(bad <= q_topk // 100, f"topk_score: {bad} queries diverge")
        res["topk_score"] = {"max_abs_err": err, "diverged_lanes": bad}
        if not grid:
            ms = cuda_ms(lambda _: tk.topk_score_cuda(qt, vec, norms, bias,
                                                      k=k), 5)
            dms = device_ms(lambda _: tk.topk_score_cuda(qt, vec, norms,
                                                         bias, k=k), 5,
                            DEVICE_KERNELS["topk_score"])
            pms = cuda_ms(lambda _: tk.topk_score_plain(qt, vec, norms, bias,
                                                        k=k), 2)
            lms = cuda_ms(lambda _: torch.topk(torch.addmm(
                norms + bias, qt, vec.T, alpha=-2.0), k, largest=False), 3)
            by = n_cap * (d * 4 + 8) + q_topk * (d * 4 + k * 8)
            bms, bby = bound_ms(by, 2.0 * n_cap * q_topk * d)
            res["topk_score"].update(
                ms=ms, device_ms=dms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=bby,
                library_call="torch.topk(torch.addmm(...))")
        del vec, adj, queries, store, qtab
        torch.cuda.empty_cache()
        rows[data] = res
    return rows


def hnsw_kernel_parity(gen, qb, vec, norms, nav, nav_w, ret_w, lanes_valid,
                       grid, n_cap, h):
    """Kernels 3 and 2 at the shapes the HNSW baseline gives them: level 0
    (r = m0 = 96, l = ef = 128, mv = 192), entered at a row with more than
    64 fresh neighbours so that a hop stages its rows in more than one
    round, and an upper level's descent (r = m = 48, l = 1, mv = 64);
    kernel 2 bound to one query at K = 96 and K = 48 (an insert's hops).
    Bitwise on grid data, else to rtol 1e-5."""
    import torch

    from repro_torch.kernels import beam_hop as bh
    from repro_torch.kernels import gather_distance as gd

    out = {}
    for r, l, mv in ((96, 128, 192), (48, 1, 64)):
        adj = torch.randint(0, n_cap, (n_cap, r), generator=gen,
                            device="cuda", dtype=torch.int32)
        adj[torch.rand((n_cap, r), generator=gen, device="cuda") < 0.15] = -1
        fresh = ((adj >= 0) & nav[adj.clamp(min=0).long()]).sum(1)
        start = int(torch.argmax(fresh))
        starts = torch.where(lanes_valid, start, -1).to(torch.int32)
        d0 = gd.gather_distance_batched_plain(starts[:, None], qb, vec,
                                              norms)[:, 0]
        name = f"beam_hop_fused[r={r},l={l}]"
        out[name] = hop_parity(
            name, bh.beam_hop_fused_plain, bh.beam_hop_fused_cuda,
            lambda q, c: bh.BoundBeamHop(q, c, adj, vec, norms, nav_w,
                                         ret_w, h=h),
            qb, (adj, vec, norms, nav_w, ret_w), starts, d0, grid, n_cap, l,
            mv, h, 4 * vec.shape[1] + 4, timed=False)
        out[name]["first_hop_fresh"] = int(fresh[start])
        if r == 96:
            check(int(fresh[start]) > 64,
                  f"{name}: the first hop has only {int(fresh[start])} "
                  f"fresh rows")
        ids = adj[:8]
        name = f"gather_distance[K={r}]"
        errs = []
        for i in range(ids.shape[0]):
            a = gd.BoundGather(qb[i], vec, norms)(ids[i])
            p = gd.gather_distance_plain(ids[i], qb[i], vec, norms)
            torch.cuda.synchronize()
            fin = torch.isfinite(p)
            check(torch.equal(torch.isfinite(a), fin), f"{name}: inf mask")
            if grid:
                check(torch.equal(a, p), f"{name}: grid data not bitwise")
            else:
                check(torch.allclose(a[fin], p[fin], rtol=1e-5, atol=1e-4),
                      f"{name}: gaussian mismatch")
            if fin.any():
                errs.append(float((a[fin] - p[fin]).abs().max()))
        out[name] = {"max_abs_err": max(errs, default=0.0),
                     "queries": ids.shape[0]}
        del adj
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def no_deleted(ext, deleted):
    import numpy as np

    return not np.isin(ext.cpu().numpy(), np.asarray(sorted(deleted))).any()


def main_path(seed, live, n_queries=1024, window=512, boot=256):
    import numpy as np
    import torch

    import repro_torch.core.batched as batched
    from repro_torch.core import (ANNConfig, apply, delete_batch,
                                  graph_recall, init_index_state,
                                  insert_batch, make_dataset,
                                  maybe_consolidate, search_index)
    from repro_torch.kernels import ops

    cfg = ANNConfig(dim=128, n_cap=1_000_000)
    data, queries = make_dataset(live, 128, "l2", n_queries=n_queries,
                                 seed=seed)
    qt = torch.from_numpy(queries).cuda()
    out = {"cfg": {"dim": cfg.dim, "n_cap": cfg.n_cap, "r": cfg.r,
                   "l_build": cfg.l_build, "l_search": cfg.l_search,
                   "l_delete": cfg.l_delete, "k_delete": cfg.k_delete},
           "live_target": live}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state = init_index_state(cfg, max_external_id=live)
    check(state.graph.vectors.is_cuda, "state is not on the card")

    def run(batch, **kw):
        s0 = dict(batched.PHASE_SECONDS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, res = apply(state, cfg, batch, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ph = {k: batched.PHASE_SECONDS[k] - s0[k] for k in s0}
        return st, res, dt, ph

    # serial bootstrap
    ids = np.arange(boot)
    state, res, dt, _ = run(insert_batch(ids, data[ids]), sequential=True)
    check(bool(res.ok[:boot].all()), "bootstrap inserts failed")
    out["bootstrap"] = {"n": boot, "s": dt, "ms_per_insert": dt / boot * 1e3}
    log(f"bootstrap: {boot} serial inserts in {dt:.1f} s")

    # batched insert windows
    tot = {"s": 0.0, "search": 0.0, "write": 0.0, "n": 0}
    for lo in range(boot, live, window):
        ids = np.arange(lo, min(lo + window, live))
        state, res, dt, ph = run(insert_batch(ids, data[ids]))
        check(bool(res.ok[:len(ids)].all()), "batched inserts failed")
        tot["s"] += dt
        tot["search"] += ph["search"]
        tot["write"] += ph["write"]
        tot["n"] += len(ids)
        log(f"insert window {lo}: {len(ids)} in {dt:.2f} s "
            f"(search {ph['search']:.2f} s, write {ph['write']:.2f} s)")
    out["insert"] = {**tot, "per_s": tot["n"] / tot["s"],
                     "search_ms_per_insert": tot["search"] / tot["n"] * 1e3,
                     "write_ms_per_insert": tot["write"] / tot["n"] * 1e3}
    check(int(state.graph.n_active) == live, "live count after inserts")

    r1 = graph_recall(state, cfg, qt, k=10)
    out["recall_before"] = r1
    log(f"recall@10 after inserts: {r1:.4f}")

    # in-place deletes of 10%, in windows, with the sweep
    rng = np.random.default_rng(seed + 7)
    dels = rng.choice(live, size=live // 10, replace=False)
    dtot = {"s": 0.0, "search": 0.0, "write": 0.0, "n": 0}
    fired = 0
    for lo in range(0, len(dels), window):
        ids = dels[lo:lo + window]
        state, res, dt, ph = run(delete_batch(ids, 128))
        check(bool(res.ok[:len(ids)].all()), "deletes failed")
        dtot["s"] += dt
        dtot["search"] += ph["search"]
        dtot["write"] += ph["write"]
        dtot["n"] += len(ids)
        state, did = maybe_consolidate(state, cfg)
        fired += did
        log(f"delete window {lo}: {len(ids)} in {dt:.2f} s (search "
            f"{ph['search']:.2f} s, write {ph['write']:.2f} s), sweep {did}")
    forced = False
    if not fired:
        # 10% deletes stay under the 0.2 trigger: sweep explicitly
        state, did = maybe_consolidate(state, cfg, force=True)
        fired += did
        forced = True
    check(fired >= 1, "the Alg-6 sweep never ran")
    check(int(state.graph.n_pending) == 0, "quarantine left after sweep")
    out["delete"] = {**dtot, "per_s": dtot["n"] / dtot["s"],
                     "search_ms_per_delete": dtot["search"] / dtot["n"] * 1e3,
                     "write_ms_per_delete": dtot["write"] / dtot["n"] * 1e3,
                     "sweeps": fired, "sweep_forced": forced}
    ext, _, _ = search_index(state, cfg, qt, k=10)
    check(no_deleted(ext, dels), "a deleted external id was returned")
    r_mid = graph_recall(state, cfg, qt, k=10)
    out["recall_after_delete"] = r_mid

    # reinserts
    for lo in range(0, len(dels), window):
        ids = dels[lo:lo + window]
        state, res, dt, ph = run(insert_batch(ids, data[ids]))
        check(bool(res.ok[:len(ids)].all()), "reinserts failed")
    check(int(state.graph.n_active) == live, "live count after reinserts")
    r2 = graph_recall(state, cfg, qt, k=10)
    out["recall_after_churn"] = r2
    log(f"recall@10 after deletes {r_mid:.4f}, after reinserts {r2:.4f}")
    check(r2 >= 0.90, f"recall@10 after churn {r2:.4f} < 0.90")

    # timed query-only phase
    qb = 256
    search_index(state, cfg, qt[:qb], k=10)
    torch.cuda.synchronize()
    steps0 = ops.launch_counts()["beam_hop_fused"]
    t0 = time.perf_counter()
    for lo in range(0, n_queries, qb):
        ext, _, _ = search_index(state, cfg, qt[lo:lo + qb], k=10)
    torch.cuda.synchronize()
    qs = time.perf_counter() - t0
    out["qps"] = n_queries / qs
    out["query_batch"] = qb
    out["query_supersteps"] = ops.launch_counts()["beam_hop_fused"] - steps0
    out["query_ms_per_superstep"] = qs * 1e3 / out["query_supersteps"]
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = ops.launch_counts()
    log(f"inserts/s {out['insert']['per_s']:.1f}, deletes/s "
        f"{out['delete']['per_s']:.1f}, QPS {out['qps']:.1f}, peak mem "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, launches {out['launches']}")
    for name in F32_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the f32 path")
    t0 = time.perf_counter()
    out["vmap"] = vmap_path(state.graph, cfg, qt)
    out["vmap"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 3c: {out['vmap']['wall_s']:.1f} s")
    return out


def grid_valued(x):
    """``x`` moved onto the grid of k/16, |k| <= 64, where every distance
    the search computes at D = 128 is exact in float32."""
    import torch

    return torch.round(x * 16).clamp(-64, 64) / 16


def vmap_path(graph, cfg, qt, qb=256, k=10, cpu_lanes=64):
    """Phase 3c: ``search_batch_vmap`` (the reference's lockstep per-query
    engine, kernel 1 a hop) on phase 3's index, ``qb`` queries a batch,
    batch by batch in turns with ``search_batch`` at ``hop_fused = 0``
    (kernel 1 a hop) and at H = 4 (kernel 3): on the Gaussian queries the
    ids, visited lists and counters equal H = 0's; on grid-valued queries
    over the same graph with grid-valued rows every field equals H = 4's
    and, for the first ``cpu_lanes`` queries, the plain run's on a CPU
    copy.  Each vmap batch launches kernel 1 once a hop and once for the
    start, and nothing else.  QPS and launches a batch of each engine; one
    more batch of the vmap engine and of H = 0 under the profiler."""
    import torch

    from repro_torch.core import search_batch, search_batch_vmap
    from repro_torch.kernels import ops

    base = dataclasses.replace(cfg, backend="cuda")
    engines = {
        "vmap": lambda g, q: search_batch_vmap(g, base, q, k=k,
                                               l=cfg.l_search),
        "H=0": lambda g, q: search_batch(
            g, dataclasses.replace(base, hop_fused=0), q, k=k,
            l=cfg.l_search),
        "H=4": lambda g, q: search_batch(
            g, dataclasses.replace(base, hop_fused=4), q, k=k,
            l=cfg.l_search),
    }
    gv = grid_valued(graph.vectors)
    grid = graph._replace(vectors=gv, norms=(gv * gv).sum(1))
    runs = {"gauss": (graph, qt, "H=0"), "grid": (grid, grid_valued(qt),
                                                  "H=4")}
    for fn in engines.values():
        fn(graph, qt[:qb])
    torch.cuda.synchronize()
    secs = {key: dict.fromkeys(engines, 0.0) for key in runs}
    launches = {key: dict.fromkeys(ops.launch_counts(), 0) for key in engines}
    hops, peak, first_grid = [], 0, None
    for kind, (g, q, twin) in runs.items():
        for lo in range(0, q.shape[0], qb):
            outs = {}
            for key, fn in engines.items():
                if key == "vmap":
                    torch.cuda.reset_peak_memory_stats()
                before = ops.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[key] = fn(g, q[lo:lo + qb])
                torch.cuda.synchronize()
                secs[kind][key] += time.perf_counter() - t0
                if key == "vmap":
                    peak = max(peak, torch.cuda.max_memory_allocated())
                got = {name: c - before[name]
                       for name, c in ops.launch_counts().items()}
                for name, c in got.items():
                    launches[key][name] += c
                if key == "vmap":
                    n_it = int(outs[key].n_hops.max())
                    hops.append(n_it)
                    check(got["gather_distance_batched"] == n_it + 1
                          and sum(got.values()) == n_it + 1,
                          f"phase 3c: a vmap batch of {n_it} hops "
                          f"launched {got}")
            v, w = outs["vmap"], outs[twin]
            fields = EXACT_FIELDS if kind == "gauss" else v._fields
            bad = [f for f in fields
                   if not torch.equal(getattr(v, f), getattr(w, f))]
            check(not bad, f"phase 3c {kind}: vmap and {twin} differ in "
                  f"{bad}")
            if kind == "gauss":
                dists_bitwise = all(torch.equal(getattr(v, f), getattr(w, f))
                                    for f in ("topk_dists", "visited_dists"))
            if kind == "grid" and first_grid is None:
                first_grid = (q[lo:lo + cpu_lanes], v)
    # where one batch's time goes, vmap engine against H = 0
    traces = {key: profile_steps(lambda g, q, fn=engines[key]: (g, fn(g, q)),
                                 graph, qt[:qb], steps=1)
              for key in ("vmap", "H=0")}
    # the plain run on a CPU copy of the grid-valued index
    q, v = first_grid
    host = type(grid)(*[x.cpu() if x is not None else None for x in grid])
    t0 = time.perf_counter()
    plain = search_batch_vmap(host, dataclasses.replace(cfg, backend="torch"),
                              q.cpu(), k=k, l=cfg.l_search)
    cpu_s = time.perf_counter() - t0
    bad = [f for f in v._fields
           if not torch.equal(getattr(v, f)[:cpu_lanes].cpu(),
                              getattr(plain, f))]
    check(not bad, f"phase 3c: the card's vmap engine and the CPU copy's "
          f"differ in {bad}")
    del grid, gv, host
    torch.cuda.empty_cache()
    n_b = len(hops)
    out = {"query_batch": qb, "k": k, "l": cfg.l_search,
           "batches": n_b, "loop_hops": hops,
           "launches": launches["vmap"],
           "per_batch": {key: {name: c / n_b for name, c in per.items() if c}
                         for key, per in launches.items()},
           "qps": {kind: {key: qt.shape[0] / t for key, t in by.items()}
                   for kind, by in secs.items()},
           "vmap_ms_per_hop": sum(secs[kd]["vmap"] for kd in secs) * 1e3
           / sum(hops),
           "vmap_peak_mem_bytes": peak,
           "gauss_dists_bitwise_h0": dists_bitwise,
           "profiled_batches": traces,
           "cpu_lanes": cpu_lanes, "cpu_s": cpu_s}
    log(f"phase 3c, vmap engine: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the quantized path, StreamingIndex + run_runbook
# ---------------------------------------------------------------------------


def quant_path(seed, n, t_max=16, eval_every=4, qb=256, n_qps=1024):
    import numpy as np
    import torch

    from repro_torch.core import (ANNConfig, StreamingIndex, run_runbook,
                                  sliding_window_runbook)
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops

    rb = sliding_window_runbook(n=n, dim=128, t_max=t_max, seed=seed)
    cfg = ANNConfig(dim=128, n_cap=1_000_000, quantized=True)
    out = {"cfg": {"dim": cfg.dim, "n_cap": cfg.n_cap, "quantized": True,
                   "r": cfg.r, "l_build": cfg.l_build,
                   "l_search": cfg.l_search},
           "runbook": {"name": rb.name, "n": n, "t_max": t_max,
                       "eval_every": eval_every, "eval_from": rb.eval_from,
                       "max_active": rb.max_active,
                       "n_queries": len(rb.queries)}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx = StreamingIndex(cfg, mode="ip", batch_updates=True,
                         max_external_id=n)
    check(idx.state.quant is not None and idx.state.quant.codes.is_cuda,
          "the quantized state is not on the card")
    rep = run_runbook(idx, rb, k=10, eval_every=eval_every, verbose=True)
    torch.cuda.synchronize()
    out["runbook_s"] = time.perf_counter() - t0
    c = rep.counters
    out["evals"] = [dataclasses.asdict(m) for m in rep.steps]
    out["avg_recall"] = rep.avg_recall
    out["counters"] = dataclasses.asdict(c)
    out["inserts_per_s"] = c.n_inserts / c.insert_s
    out["deletes_per_s"] = c.n_deletes / c.delete_s
    check(rep.avg_recall >= 0.90,
          f"quantized path: average Recall@10 {rep.avg_recall:.4f} < 0.90")

    # QPS at B = qb: the runbook's queries, tiled to n_qps
    reps = -(-n_qps // len(rb.queries))
    qs = np.tile(rb.queries, (reps, 1))[:n_qps]
    idx.search(qs[:qb])
    torch.cuda.synchronize()
    steps0 = ops.launch_counts()["beam_hop_fused_q"]
    t1 = time.perf_counter()
    for lo in range(0, n_qps, qb):
        idx.search(qs[lo:lo + qb])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    out["qps"] = n_qps / dt
    out["query_batch"] = qb
    out["query_supersteps"] = ops.launch_counts()["beam_hop_fused_q"] - steps0
    out["query_ms_per_superstep"] = dt * 1e3 / out["query_supersteps"]

    ext, dists, slots = idx.search(rb.queries, k=10)
    out["launches"] = ops.launch_counts()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    deleted = np.concatenate([s.delete_ids for s in rb.steps])
    check(not np.isin(ext, deleted).any(),
          "quantized path: a deleted external id was returned")
    st = idx.state
    rescore = gd.gather_distance_batched_cuda(
        torch.from_numpy(slots).to("cuda", torch.int32),
        torch.from_numpy(rb.queries).cuda(), st.vectors, st.norms)
    check(torch.equal(rescore.cpu(), torch.from_numpy(dists)),
          "quantized path: returned distances are not the exact rescore")
    log(f"quantized path: avg Recall@10 {rep.avg_recall:.4f}, inserts/s "
        f"{out['inserts_per_s']:.1f}, deletes/s {out['deletes_per_s']:.1f}, "
        f"QPS {out['qps']:.1f}, peak mem "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, launches {out['launches']}")
    for name in QUANT_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the quantized path")
    out["query_by_hops"] = quant_query_by_hops(idx, qs, qb)
    return out


def quant_query_by_hops(idx, qs, qb):
    """The quantized index's query-only phase at ``hop_fused = 0`` (kernel 5
    carries every hop, through the launcher bound once per search) and at
    the default H = 4 (kernel 6), batch by batch in turns on the same
    queries: QPS and launches per query batch of each, and every returned
    id, distance, visited list and counter identical."""
    import torch

    from repro_torch.core import search_index
    from repro_torch.kernels import ops

    cfgs = {"H=0": dataclasses.replace(idx.cfg, hop_fused=0),
            "H=4": idx.cfg}
    q = torch.from_numpy(qs).cuda()
    for cfg in cfgs.values():
        search_index(idx.istate, cfg, q[:qb], k=10)
    secs = dict.fromkeys(cfgs, 0.0)
    launches = {key: dict.fromkeys(ops.launch_counts(), 0) for key in cfgs}
    n_batches = 0
    for lo in range(0, q.shape[0], qb):
        outs = {}
        for key, cfg in cfgs.items():
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[key] = search_index(idx.istate, cfg, q[lo:lo + qb], k=10)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            for name, c in ops.launch_counts().items():
                launches[key][name] += c - before[name]
        (e0, d0, r0), (e4, d4, r4) = outs["H=0"], outs["H=4"]
        bad = [f for f, x, y in zip(r0._fields, r0, r4)
               if not torch.equal(x, y)]
        check(torch.equal(e0, e4) and torch.equal(d0, d4) and not bad,
              f"quantized query path: H = 0 and H = 4 differ in {bad}")
        n_batches += 1
    out = {}
    for key in cfgs:
        out[key] = {
            "qps": q.shape[0] / secs[key], "query_batch": qb,
            "batches": n_batches,
            "per_batch": {name: c / n_batches
                          for name, c in launches[key].items() if c}}
    per0, per4 = out["H=0"]["per_batch"], out["H=4"]["per_batch"]
    check(per0.get("beam_hop_fused_q", 0) == 0
          and per0.get("gather_distance_batched_q", 0) > 1,
          f"quantized query path at H = 0: launches {out['H=0']}")
    check(per4.get("gather_distance_batched_q", 0) == 1,
          f"quantized query path at H = 4: launches {out['H=4']}")
    log(f"quantized query path by H: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the fresh and local policies and the HNSW baseline at full width
# ---------------------------------------------------------------------------


def edges_into_inactive(adj, active):
    """Edges of the adjacency that point at a slot that is not live."""
    valid = adj >= 0
    return int((valid & ~active[adj.clamp(min=0).long()]).sum())


def timed_queries(idx, queries, qb, n_qps, counter):
    """QPS of ``idx.search`` at B = ``qb`` over ``queries`` tiled to
    ``n_qps``, and the ``counter`` kernel's launches per query batch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    reps = -(-n_qps // len(queries))
    qs = np.tile(queries, (reps, 1))[:n_qps]
    idx.search(qs[:qb])
    torch.cuda.synchronize()
    c0 = ops.launch_counts()[counter]
    t0 = time.perf_counter()
    for lo in range(0, n_qps, qb):
        idx.search(qs[lo:lo + qb])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"qps": n_qps / dt, "query_batch": qb,
            "supersteps_per_batch": (ops.launch_counts()[counter] - c0)
            / (n_qps // qb)}


def policy_path(seed, mode, n, t_max=16, eval_every=4, qb=256, n_qps=1024):
    """``StreamingIndex(mode=...)`` at full width replaying a sliding
    window through ``run_runbook``: fresh (tombstones navigable, not
    returnable, Alg-4 consolidation) or local (exact in-neighbour repair,
    slots freed at once)."""
    import numpy as np
    import torch

    from repro_torch.core import (ANNConfig, StreamingIndex, run_runbook,
                                  sliding_window_runbook)
    from repro_torch.kernels import ops

    rb = sliding_window_runbook(n=n, dim=128, t_max=t_max, seed=seed)
    cfg = ANNConfig(dim=128, n_cap=1_000_000)
    out = {"mode": mode,
           "cfg": {"dim": cfg.dim, "n_cap": cfg.n_cap, "r": cfg.r,
                   "l_build": cfg.l_build, "l_search": cfg.l_search,
                   "alpha": cfg.alpha},
           "runbook": {"name": rb.name, "n": n, "t_max": t_max,
                       "eval_every": eval_every, "eval_from": rb.eval_from,
                       "max_active": rb.max_active}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx = StreamingIndex(cfg, mode=mode, batch_updates=True,
                         max_external_id=n)
    check(idx.state.vectors.is_cuda, f"{mode}: the state is not on the card")
    pending, passes, peak = [], [], [0]
    delete, consolidate = idx.delete, idx.maybe_consolidate

    def delete_and_record(ids):
        delete(ids)
        pending.append(int(idx.state.n_pending))

    def consolidate_and_record(force=False):
        # each pass that runs: its seconds and the device memory it needs
        # above what was allocated before it (the path's peak is kept)
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n_pend = int(idx.state.n_pending)
        t1 = time.perf_counter()
        did = consolidate(force=force)
        torch.cuda.synchronize()
        if did:
            passes.append({"pending": n_pend, "forced": force,
                           "s": time.perf_counter() - t1,
                           "peak_extra_bytes":
                               torch.cuda.max_memory_allocated() - base})
        return did

    idx.delete = delete_and_record
    idx.maybe_consolidate = consolidate_and_record
    rep = run_runbook(idx, rb, k=10, eval_every=eval_every, verbose=True)
    torch.cuda.synchronize()
    out["runbook_s"] = time.perf_counter() - t0
    c = rep.counters
    out["evals"] = [dataclasses.asdict(m) for m in rep.steps]
    out["avg_recall"] = rep.avg_recall
    out["counters"] = dataclasses.asdict(c)
    out["inserts_per_s"] = c.n_inserts / c.insert_s
    out["deletes_per_s"] = c.n_deletes / c.delete_s
    out["n_pending_after_each_delete"] = pending
    check(rep.avg_recall >= 0.90,
          f"{mode}: average Recall@10 {rep.avg_recall:.4f} < 0.90")
    out.update(timed_queries(idx, rb.queries, qb, n_qps, "beam_hop_fused"))
    ext, _, _ = idx.search(rb.queries, k=10)
    deleted = np.concatenate([s.delete_ids for s in rb.steps])
    check(not np.isin(ext, deleted).any(),
          f"{mode}: a deleted external id was returned")
    out["launches"] = ops.launch_counts()
    st = idx.state
    if mode == "fresh":
        check(c.n_consolidations >= 1, "fresh: Alg 4 never ran")
        # tombstone a tenth of the live set (under the trigger), query with
        # the tombstones in place, then force Alg 4
        live = np.nonzero(idx.istate.ext2slot.cpu().numpy() >= 0)[0]
        extra = np.random.default_rng(seed + 11).choice(
            live, size=len(live) // 10, replace=False)
        idx.delete(extra)
        check(int(st.n_pending) == len(extra),
              "fresh: the extra deletes were not left pending")
        ext, _, _ = idx.search(rb.queries, k=10)
        check(not np.isin(ext, extra).any(),
              "fresh: a tombstoned external id was returned")
        check(idx.maybe_consolidate(force=True),
              "fresh: the forced Alg 4 did not run")
        check(not bool(st.tombstone.any()) and int(st.n_pending) == 0,
              "fresh: tombstones left after the forced consolidation")
        out["consolidations"] = passes
    else:
        check(all(p == 0 for p in pending),
              f"local: n_pending after each delete {pending}")
    out["peak_mem_bytes"] = max(peak[0], torch.cuda.max_memory_allocated())
    dangling = edges_into_inactive(st.adj, st.active)
    out["edges_into_inactive"] = dangling
    check(dangling == 0, f"{mode}: {dangling} edges point into inactive "
                         f"slots")
    log(f"{mode} path: avg Recall@10 {rep.avg_recall:.4f}, inserts/s "
        f"{out['inserts_per_s']:.1f}, deletes/s {out['deletes_per_s']:.1f}, "
        f"QPS {out['qps']:.1f}, consolidations {c.n_consolidations}, peak "
        f"mem {out['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
        f"{out['launches']}")
    for name in F32_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the {mode} path")
    return out


def hnsw_path(seed, n, t_max=16, eval_every=4, qb=256, n_qps=1024):
    """``HNSWIndex`` at the paper's M = 48 on a 10^6-slot table replaying a
    sliding window through ``run_runbook(baseline="hnsw")``: serial inserts
    (kernel 2 on every hop), mark-deletes, replacement inserts into
    tombstoned slots, and queries through the batched engine (kernels 1
    and 3) with per-query descent starts."""
    import numpy as np
    import torch

    from repro_torch.core import (HNSWConfig, HNSWIndex, run_runbook,
                                  sliding_window_runbook)
    from repro_torch.kernels import ops

    rb = sliding_window_runbook(n=n, dim=128, t_max=t_max, seed=seed)
    cfg = HNSWConfig(dim=128, n_cap=1_000_000, m=48, ef_construction=128,
                     ef_search=128, max_level=4)
    out = {"cfg": dataclasses.asdict(cfg),
           "runbook": {"name": rb.name, "n": n, "t_max": t_max,
                       "eval_every": eval_every, "eval_from": rb.eval_from,
                       "max_active": rb.max_active}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx = HNSWIndex(cfg, max_external_id=n, seed=seed)
    check(idx.state.adj0.is_cuda, "hnsw: the state is not on the card")
    rep = run_runbook(idx, rb, k=10, eval_every=eval_every, verbose=True,
                      baseline="hnsw")
    torch.cuda.synchronize()
    out["runbook_s"] = time.perf_counter() - t0
    c = rep.counters
    out["evals"] = [dataclasses.asdict(m) for m in rep.steps]
    out["avg_recall"] = rep.avg_recall
    out["counters"] = dataclasses.asdict(c)
    # mark-deletes are booked into insert_s, as the reference books them
    out["inserts_per_s"] = c.n_inserts / c.insert_s
    out["ms_per_insert"] = c.insert_s / c.n_inserts * 1e3
    check(rep.avg_recall >= 0.90,
          f"hnsw: average Recall@10 {rep.avg_recall:.4f} < 0.90")
    out.update(timed_queries(idx, rb.queries, qb, n_qps, "beam_hop_fused"))
    ext, _, _ = idx.search(rb.queries, k=10)
    deleted = np.concatenate([s.delete_ids for s in rb.steps])
    check(not np.isin(ext, deleted).any(),
          "hnsw: a deleted external id was returned")
    st = idx.state
    popped = cfg.n_cap - int(st.free_top)
    out["slots_from_free_stack"] = popped
    out["slots_reused"] = c.n_inserts - popped
    check(popped < c.n_inserts, "hnsw: no insert reused a tombstoned slot")
    out["tombstones_left"] = int(st.tombstone.sum())
    out["levels"] = {int(v): int(k) for v, k in zip(
        *np.unique(st.level.cpu().numpy(), return_counts=True))}
    out["launches"] = ops.launch_counts()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"hnsw path: avg Recall@10 {rep.avg_recall:.4f}, inserts/s "
        f"{out['inserts_per_s']:.2f} ({out['ms_per_insert']:.1f} ms each), "
        f"QPS {out['qps']:.1f}, reused {out['slots_reused']} slots, peak mem "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
        f"{out['launches']}")
    for name in F32_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the hnsw path")
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path, end to end
# ---------------------------------------------------------------------------


def engines_agree(seed):
    import numpy as np
    import torch

    from repro_torch.configs import test_scale
    from repro_torch.core import (apply, delete_batch, init_index_state,
                                  insert_batch, maybe_consolidate,
                                  search_index)

    rng = np.random.default_rng(seed)
    data = (rng.integers(-64, 65, size=(900, 32)) / 16).astype(np.float32)
    q = torch.from_numpy(
        (rng.integers(-64, 65, size=(64, 32)) / 16).astype(np.float32)
    ).cuda()
    finals = {}
    for backend in ("cuda", "torch"):
        cfg = test_scale(dim=32, n_cap=4096, backend=backend)
        st = init_index_state(cfg, max_external_id=900)
        st, _ = apply(st, cfg, insert_batch(np.arange(64), data[:64]),
                      sequential=True)
        for lo in range(64, 800, 128):
            ids = np.arange(lo, min(lo + 128, 800))
            st, _ = apply(st, cfg, insert_batch(ids, data[ids]))
        dels = rng.choice(800, size=200, replace=False) if backend == "cuda" \
            else finals["cuda"]["dels"]
        st, _ = apply(st, cfg, delete_batch(dels[:150], 32))
        st, _ = apply(st, cfg, delete_batch(dels[150:], 32), sequential=True)
        st, did = maybe_consolidate(st, cfg)
        st, _ = apply(st, cfg, insert_batch(dels[:100], data[dels[:100]]))
        ext, dist, res = search_index(st, cfg, q, k=10)
        finals[backend] = {"state": st, "ext": ext, "dist": dist,
                           "res": res, "dels": dels, "did": did}
    a, b = finals["cuda"], finals["torch"]
    check(a["did"] and b["did"], "phase 4: the sweep did not fire")
    flat = differing_leaves(a["state"], b["state"], "state") + \
        differing_leaves(a["res"], b["res"], "search")
    bad = [p for p, ok in flat if not ok]
    check(torch.equal(a["ext"], b["ext"]) and not bad,
          f"phase 4: cuda and torch engines differ in {bad}")
    return {"fields_compared": len(flat), "identical": True}


def differing_leaves(x, y, path):
    """``[(path, equal)]`` over every tensor leaf of two nested tuples."""
    import torch

    if isinstance(x, torch.Tensor):
        return [(path, torch.equal(x, y))]
    if x is None:
        return [(path, y is None)]
    return [leaf for f, xx, yy in zip(x._fields, x, y)
            for leaf in differing_leaves(xx, yy, f"{path}.{f}")]


def qgrid(rng, n, d):
    """Grid rows with one entry at +-127/16: every int8 scale is 2^-4, so
    the quantized distances are exact in float32."""
    import numpy as np

    x = rng.integers(-64, 65, size=(n, d)) / 16
    x[np.arange(n), rng.integers(0, d, size=n)] = \
        np.where(rng.random(n) < 0.5, -1.0, 1.0) * 127 / 16
    return x.astype(np.float32)


def quant_engines_agree(seed, n_pts=600, n_cap=256):
    """A quantized ``StreamingIndex`` stream on grid data that grows from
    ``n_cap`` through two capacity buckets, with the cuda engine at H = 0
    (the int8 gather kernel carries every hop) and H = 4 (the fused int8
    kernel), and the torch engine at H = 0: three identical ends."""
    import numpy as np
    import torch

    from repro_torch.configs import test_scale
    from repro_torch.core import StreamingIndex
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 3)
    data = qgrid(rng, n_pts, 32)
    q = qgrid(rng, 64, 32)
    first = n_pts * 5 // 6
    dels = rng.choice(first, size=first // 4, replace=False)
    cut = len(dels) * 3 // 4
    runs = {}
    for backend, hops in (("cuda", 0), ("cuda", 4), ("torch", 0)):
        cfg = dataclasses.replace(test_scale(dim=32, n_cap=n_cap,
                                             backend=backend),
                                  quantized=True, hop_fused=hops)
        idx = StreamingIndex(cfg, batch_updates=True, max_external_id=n_pts)
        ops.reset_launch_counts()
        caps = [idx.cfg.n_cap]
        for lo in range(0, first, 128):
            ids = np.arange(lo, min(lo + 128, first))
            idx.insert(ids, data[ids])
            caps.append(idx.cfg.n_cap)
        idx.delete(dels[:cut])
        idx.insert(np.arange(first, n_pts), data[first:])
        idx.delete(dels[cut:])
        idx.maybe_consolidate(force=True)
        ext, dist, slots = idx.search(q, k=10)
        runs[(backend, hops)] = {
            "state": idx.istate, "ext": ext, "dist": dist, "slots": slots,
            "caps": sorted(set(caps)), "launches": ops.launch_counts()}
    base = runs[("cuda", 0)]
    check(len(base["caps"]) >= 3,
          f"phase 4: the stream grew through {base['caps']} only")
    check(base["launches"]["gather_distance_batched_q"] > 0
          and base["launches"]["beam_hop_fused_q"] == 0,
          f"phase 4: H = 0 launches {base['launches']}")
    check(runs[("cuda", 4)]["launches"]["beam_hop_fused_q"] > 0,
          "phase 4: H = 4 did not launch the fused int8 kernel")
    n_fields = 0
    for key, run in runs.items():
        flat = differing_leaves(base["state"], run["state"], "state")
        bad = [p for p, ok in flat if not ok]
        same = all(np.array_equal(base[f], run[f])
                   for f in ("ext", "dist", "slots"))
        check(same and not bad and run["caps"] == base["caps"],
              f"phase 4: quantized {key} differs from cuda H=0 in {bad}")
        n_fields = len(flat)
    return {"fields_compared": n_fields, "capacities": base["caps"],
            "runs": [f"{b}/H={h}" for b, h in runs], "identical": True}


def policy_engines_agree(seed, n_pts=240, n_del=80):
    """Grid-data streams at test size, each with backend "cuda" and
    "torch": fresh (through an Alg-4 consolidation; it and
    ``engines_agree`` carry kernel 3 in f32), local on the int8 tier at
    H = 0 and H = 4 (``StreamingIndex`` with batched updates), and HNSW
    through a delete-and-replace round; each pair must end in identical
    states and results, and the cuda run must have launched its
    kernels."""
    import numpy as np

    from repro_torch.configs import test_scale
    from repro_torch.core import HNSWConfig, HNSWIndex, StreamingIndex
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 5)
    data = qgrid(rng, n_pts, 32)
    q = qgrid(rng, 64, 32)
    first = n_pts * 5 // 6
    dels = rng.choice(first, size=n_del, replace=False)
    streams = {
        "fresh": ("fresh", False, -1, ("beam_hop_fused",)),
        "local/int8/H=0": ("local", True, 0, ("gather_distance_batched_q",)),
        "local/int8/H=4": ("local", True, 4, ("beam_hop_fused_q",)),
    }
    out = {}
    for key, (mode, quantized, hops, kernels) in streams.items():
        runs = {}
        for backend in ("cuda", "torch"):
            cfg = dataclasses.replace(
                test_scale(dim=32, n_cap=1024, backend=backend),
                quantized=quantized, hop_fused=hops)
            idx = StreamingIndex(cfg, mode=mode, batch_updates=True,
                                 max_external_id=n_pts)
            ops.reset_launch_counts()
            idx.insert(np.arange(first), data[:first])
            idx.delete(dels[:n_del * 3 // 4])
            idx.insert(np.arange(first, n_pts), data[first:])
            idx.delete(dels[n_del * 3 // 4:])
            ext, dist, slots = idx.search(q, k=10)
            runs[backend] = {"state": idx.istate, "ext": ext, "dist": dist,
                             "slots": slots, "launches": ops.launch_counts(),
                             "consolidations": idx.counters.n_consolidations}
        out[key] = compare_runs(key, runs, kernels)
        if mode == "fresh":
            check(runs["cuda"]["consolidations"] >= 1,
                  "phase 4: the fresh stream never consolidated")
    runs = {}
    for backend in ("cuda", "torch"):
        cfg = HNSWConfig(dim=32, n_cap=n_pts * 3 // 4, m=8, ef_construction=32,
                         ef_search=32, max_level=2, backend=backend)
        idx = HNSWIndex(cfg, max_external_id=n_pts, seed=seed)
        ops.reset_launch_counts()
        half = cfg.n_cap * 2 // 3
        idx.insert(np.arange(half), data[:half])
        idx.delete(np.arange(0, half, 2))
        idx.insert(np.arange(half, cfg.n_cap), data[half:cfg.n_cap])
        check(int(idx.state.tombstone.sum()) < half // 2,
              "phase 4: the hnsw stream reused no tombstoned slot")
        ext, dist, slots = idx.search(q, k=10)
        runs[backend] = {"state": idx.state, "ext": ext, "dist": dist,
                         "slots": slots, "launches": ops.launch_counts()}
    out["hnsw"] = compare_runs("hnsw", runs, ("gather_distance",
                                              "beam_hop_fused"))
    return out


# ---------------------------------------------------------------------------
# phase 6: whole-segment update streams and durability
# ---------------------------------------------------------------------------


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def segment_start(seed, live, n_new, n_queries=1024):
    """A 10^6-slot f32 handle with ``live`` points (serial to 2 l_build,
    then batched windows of 256), the data (``live + n_new`` rows) and
    1,024 queries."""
    import numpy as np
    import torch

    from repro_torch.core import (ANNConfig, apply, init_index_state,
                                  insert_batch, make_dataset)

    cfg = ANNConfig(dim=128, n_cap=1_000_000)
    data, queries = make_dataset(live + n_new, 128, "l2",
                                 n_queries=n_queries, seed=seed + 13)
    state = init_index_state(cfg, max_external_id=len(data))
    boot = 2 * cfg.l_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi, seq in [(0, boot, True)] + [
            (lo, min(lo + 256, live), False) for lo in range(boot, live, 256)]:
        ids = np.arange(lo, hi)
        state, res = apply(state, cfg, insert_batch(ids, data[ids]),
                           sequential=seq)
        check(bool(res.ok[:len(ids)].all()), "phase 6: bootstrap failed")
    torch.cuda.synchronize()
    check(int(state.graph.n_active) == live, "phase 6: bootstrap count")
    return cfg, state, data, queries, time.perf_counter() - t0


def per_op_loop(state, cfg, plan, policy):
    """The per-op path a segment plan must equal: ``apply`` then the
    policy's trigger after every real op (ip, local: the sweep at once;
    fresh: the flag, and Alg 4 at the segment boundary when one fired).
    Returns the state and, per segment, the ``ApplyResult`` rows and the
    trigger of each op."""
    from repro_torch.core import apply, consolidate_if_needed, get_policy
    from repro_torch.core.types import UpdateBatch

    pol = get_policy(policy)
    rows = []
    for seg in plan.segments:
        results, fired = [], []
        for t in range(seg.n_ops):
            op = UpdateBatch(*(f[t] for f in seg.ops))
            state, res = apply(state, cfg, op, policy=policy,
                               split=seg.split)
            results.append(res)
            if pol.device_consolidation:
                state, did = consolidate_if_needed(state, cfg,
                                                   policy=policy)
                fired.append(bool(did))
            else:
                fired.append(bool(pol.should_consolidate_device(
                    cfg, state.graph)))
            if policy == "local":
                check(int(state.graph.n_pending) == 0,
                      "phase 6a: local left a slot pending")
        if not pol.device_consolidation and any(fired):
            state = state._replace(graph=pol.consolidate(state.graph, cfg))
        rows.append((results, fired))
    return state, rows


def segments_agree(cfg, start, data, live, n_ops=16, lanes=32, max_t=8):
    """6a: 16 kind-major ops of 32 inserts and 32 deletes through
    ``run_segments(plan_segments(..., max_t=8))`` (batched updates) and,
    on a clone, through the per-op loop, for ip, fresh and local: every
    leaf and every result row identical, the pad rows applied nothing,
    the trigger fired mid-segment for ip and fresh, local owed nothing."""
    import numpy as np
    import torch

    from repro_torch.core import (clone_state, mixed_update_batch,
                                  plan_segments, run_segments)
    from repro_torch.kernels import ops

    rng = np.random.default_rng(live)
    dels = rng.permutation(live)[:n_ops * lanes]
    steps, splits = [], []
    for t in range(n_ops):
        ins = np.arange(live + t * lanes, live + (t + 1) * lanes)
        b, split = mixed_update_batch(ins, data[ins],
                                      dels[t * lanes:(t + 1) * lanes], 128)
        steps.append(b)
        splits.append(split)
    plan = plan_segments(steps, splits=splits, max_t=max_t)
    out = {"n_ops": n_ops, "lanes": lanes * 2, "split": splits[0],
           "max_t": max_t, "consolidation_threshold":
           cfg.consolidation_threshold,
           "segments": [int(s.ops.kind.shape[0]) for s in plan.segments],
           "pad_rows": sum(int(s.ops.kind.shape[0]) - s.n_ops
                           for s in plan.segments)}
    launches, finals = {}, {}
    for policy in ("ip", "fresh", "local"):
        seg_st, loop_st = clone_state(start), clone_state(start)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_st, results = run_segments(seg_st, cfg, plan, policy=policy)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        add_counts(launches, counts)
        t0 = time.perf_counter()
        loop_st, rows = per_op_loop(loop_st, cfg, plan, policy)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        bad = [p for p, same in differing_leaves(seg_st, loop_st, "state")
               if not same]
        check(not bad, f"phase 6a: {policy} segments and the per-op loop "
                       f"differ in {bad}")
        fired_at = []
        for i, (seg, res, (loop_res, fired)) in enumerate(
                zip(plan.segments, results, rows)):
            for t, r in enumerate(loop_res):
                for f in ("slot", "ok", "n_comps"):
                    check(torch.equal(getattr(res, f)[t], getattr(r, f)),
                          f"phase 6a: {policy} segment {i} row {t}: {f}")
            flag = res.consolidated if policy != "fresh" \
                else res.needs_consolidation
            other = res.needs_consolidation if policy != "fresh" \
                else res.consolidated
            check(flag[:seg.n_ops].tolist() == fired and not bool(
                other.any()), f"phase 6a: {policy} segment {i} triggers "
                              f"{flag.tolist()} vs per-op {fired}")
            check(not bool(res.ok[seg.n_ops:].any()),
                  f"phase 6a: {policy} a pad row applied an op")
            fired_at += [(i, t) for t, f in enumerate(fired) if f]
        if policy == "local":
            check(not fired_at and int(seg_st.graph.n_pending) == 0,
                  f"phase 6a: local triggered at {fired_at}")
        else:
            check(any(t < plan.segments[i].n_ops - 1 for i, t in fired_at),
                  f"phase 6a: {policy} never triggered mid-segment "
                  f"({fired_at})")
        out[policy] = {"segment_ms_per_op": seg_s / n_ops * 1e3,
                       "per_op_ms_per_op": loop_s / n_ops * 1e3,
                       "fired_at": fired_at, "launches": counts,
                       "n_active": int(seg_st.graph.n_active),
                       "identical": True}
        log(f"6a {policy}: segments {seg_s / n_ops * 1e3:.1f} ms/op, "
            f"per-op {loop_s / n_ops * 1e3:.1f} ms/op, triggers at "
            f"{fired_at}, launches {counts}")
        finals[policy] = seg_st
        del loop_st
    for name in ("gather_distance_batched", "beam_hop_fused"):
        check(launches.get(name, 0) > 0,
              f"phase 6a: kernel {name} never launched by the segments")
    return out, plan, finals["ip"], launches


def segmented_runbook_agrees(seed, n=160, t_max=16, eval_every=4):
    """6b: ``run_runbook(segmented=True)`` against the per-op
    ``run_runbook`` on ``StreamingIndex(mode="ip", batch_updates=False)``:
    the same evals, counters (seconds aside) and final state."""
    import torch

    from repro_torch.core import (ANNConfig, StreamingIndex, run_runbook,
                                  sliding_window_runbook)
    from repro_torch.kernels import ops

    rb = sliding_window_runbook(n=n, dim=128, t_max=t_max, seed=seed)
    cfg = ANNConfig(dim=128, n_cap=1_000_000)
    reps, idxs, walls, launches = {}, {}, {}, {}
    for segmented in (True, False):
        idx = StreamingIndex(cfg, mode="ip", max_external_id=n)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps[segmented] = run_runbook(idx, rb, k=10, eval_every=eval_every,
                                      segmented=segmented)
        torch.cuda.synchronize()
        walls[segmented] = time.perf_counter() - t0
        if segmented:
            launches = ops.launch_counts()
        idxs[segmented] = idx
    seg, per = reps[True], reps[False]
    evals = [[(m.step, m.n_active, m.recall) for m in r.steps]
             for r in (seg, per)]
    check(evals[0] == evals[1],
          f"phase 6b: evals differ: {evals[0]} vs {evals[1]}")
    cs, cp = dataclasses.asdict(seg.counters), dataclasses.asdict(
        per.counters)
    counts = [f for f in cs if not f.endswith("_s")]
    diff = {f: (cs[f], cp[f]) for f in counts if cs[f] != cp[f]}
    check(not diff, f"phase 6b: counters differ: {diff}")
    bad = [p for p, same in differing_leaves(idxs[True].istate,
                                             idxs[False].istate, "state")
           if not same]
    check(not bad, f"phase 6b: final states differ in {bad}")
    out = {"runbook": {"name": rb.name, "n": n, "t_max": t_max,
                       "eval_every": eval_every, "segment_t": 32},
           "evals": evals[0], "avg_recall": seg.avg_recall,
           "counters": {f: cs[f] for f in counts},
           "segment_s": cs["segment_s"],
           "per_op_insert_s": cp["insert_s"],
           "per_op_delete_s": cp["delete_s"],
           "segmented_wall_s": walls[True], "per_op_wall_s": walls[False],
           "launches": launches, "identical": True}
    log(f"6b: segment_s {cs['segment_s']:.2f} vs insert_s + delete_s "
        f"{cp['insert_s'] + cp['delete_s']:.2f}, avg Recall@10 "
        f"{seg.avg_recall:.4f}, launches {launches}")
    return out, launches


def timed_manager(directory, keep):
    """A ``CheckpointManager`` that records the seconds of each completed
    ``save`` and each ``load``."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def save(self, *a, **kw):
            t0 = time.perf_counter()
            path = super().save(*a, **kw)
            self.save_s.append(time.perf_counter() - t0)
            return path

        def load(self, *a, **kw):
            t0 = time.perf_counter()
            got = super().load(*a, **kw)
            self.load_s.append(time.perf_counter() - t0)
            return got

    mgr = Timed(directory, keep=keep)
    mgr.save_s, mgr.load_s = [], []
    return mgr


def durability_agrees(cfg, start, plan, ref_ip, queries):
    """6c: ``run_segments_supervised`` on 6a's ip plan with a failure
    before segment 1 and a kill inside the save of step 2 ends bitwise at
    6a's uninterrupted state; ``StreamingIndex.save`` / ``restore`` onto
    the card round-trips every leaf and a 1,024-query search."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import (StreamingIndex, clone_state,
                                  run_segments_supervised)
    from repro_torch.kernels import ops

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    out = {}
    try:
        mgr = timed_manager(tmp / "supervised", keep=2)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, _, info = run_segments_supervised(
            mgr, clone_state(start), cfg, plan, policy="ip",
            checkpoint_every=1, fail_at={1: 1},
            crash_in_save={2: "leaf:3"})
        torch.cuda.synchronize()
        out["supervised_s"] = time.perf_counter() - t0
        bad = [p for p, same in differing_leaves(st, ref_ip, "state")
               if not same]
        check(info["restarts"] == 2 and not bad,
              f"phase 6c: supervised run {info} differs in {bad}")
        step_dir = tmp / "supervised" / f"step_{mgr.latest():08d}"
        out.update(restarts=info["restarts"], save_s=mgr.save_s,
                   load_s=mgr.load_s,
                   checkpoint_bytes=sum(f.stat().st_size
                                        for f in step_dir.iterdir()))
        del st

        idx = StreamingIndex(cfg, mode="ip",
                             max_external_id=int(ref_ip.ext2slot.shape[0]))
        idx.istate = ref_ip
        rt = tmp / "round_trip"
        from repro_torch.checkpoint import CheckpointManager

        t0 = time.perf_counter()
        idx.save(CheckpointManager(rt, keep=2), 1)
        out["round_trip_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx2, _ = StreamingIndex.restore(CheckpointManager(rt, keep=2), cfg)
        torch.cuda.synchronize()
        out["round_trip_restore_s"] = time.perf_counter() - t0
        check(idx2.state.vectors.is_cuda, "phase 6c: restored off the card")
        bad = [p for p, same in differing_leaves(idx.istate, idx2.istate,
                                                 "state") if not same]
        check(not bad, f"phase 6c: the round trip differs in {bad}")
        a, b = idx.search(queries, k=10), idx2.search(queries, k=10)
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              "phase 6c: searches differ after the round trip")
        out["launches"] = ops.launch_counts()
        out["queries"] = len(queries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"6c: restarts {out['restarts']}, saves {out['save_s']} s, loads "
        f"{out['load_s']} s, {out['checkpoint_bytes']} bytes a checkpoint; "
        f"round trip save {out['round_trip_save_s']:.2f} s, restore "
        f"{out['round_trip_restore_s']:.2f} s")
    return out


def segments_path(seed, live=1024):
    """Phase 6: the segment path and durability at full width.  Returns
    the record and the start state (config, state, data, queries), which
    phase 7 serves."""
    t0 = time.perf_counter()
    cfg, start, data, queries, boot_s = segment_start(seed, live, 16 * 32)
    out = {"live": live, "bootstrap_s": boot_s}
    launches = {}
    out["6a"], plan, ref_ip, counts = segments_agree(cfg, start, data, live)
    add_counts(launches, counts)
    out["6a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["6c"] = durability_agrees(cfg, start, plan, ref_ip, queries)
    add_counts(launches, out["6c"]["launches"])
    out["6c_s"] = time.perf_counter() - t0
    del ref_ip
    t0 = time.perf_counter()
    out["6b"], counts = segmented_runbook_agrees(seed)
    add_counts(launches, counts)
    out["6b_s"] = time.perf_counter() - t0
    out["launches"] = launches
    for name in F32_PATH:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched on the segment path")
    return out, (cfg, start, data, queries)


# ---------------------------------------------------------------------------
# phase 7: the serving front door on the card
# ---------------------------------------------------------------------------


# the kernels the serving path launches: the batched search's start column
# and fused hops (7a-7c), the exact top-k of every recall check (7b, 7c)
SERVING_PATH = ("gather_distance_batched", "beam_hop_fused", "topk_score")


def serving_index(cfg, start, mode):
    """A ``StreamingIndex`` on the card over a clone of ``start``, set in
    as ``StreamingIndex.restore`` does (no empty handle allocated)."""
    import torch

    from repro_torch.core import StreamingIndex, clone_state

    idx = StreamingIndex(cfg, mode=mode,
                         max_external_id=int(start.ext2slot.shape[0]),
                         batch_updates=True, device="meta")
    idx.device = torch.device("cuda")
    idx.istate = clone_state(start)
    return idx


def state_bytes(state):
    import torch

    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        state = state.values()
    return 0 if state is None else sum(state_bytes(x) for x in state)


def isolation_agrees(cfg, start, data, live):
    """7a: for ip, fresh and local, 8 queries 0.01 from live points served
    from snapshot 0; the writer inserts 8 points at the query locations,
    deletes the served top-1 ids and forces the policy's consolidation;
    the same queries from snapshot 0 again: bitwise the first answers;
    after a publish: top-1 the new ids, no deleted id returned."""
    import numpy as np
    import torch

    from repro_torch.core import delete_batch, insert_batch
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingFront, StreamingEngine

    queries = data[:8] + np.float32(0.01)
    new_ids = np.arange(len(data) - 8, len(data))
    nbytes = state_bytes(start)
    out = {"state_bytes": nbytes,
           "publish_bound_ms": bound_ms(2 * nbytes, 0)[0]}
    ops.reset_launch_counts()
    for mode in ("ip", "fresh", "local"):
        torch.cuda.reset_peak_memory_stats()
        idx = serving_index(cfg, start, mode)
        front = ServingFront(StreamingEngine(idx), deadline_s=0.0,
                             max_bucket=8, k=10, publish_every=10**9)

        def serve(now):
            reqs = [front.submit_query(q, now) for q in queries]
            front.pump(now + 1.0)
            return reqs

        before = serve(0.0)
        top1 = np.unique([r.ext_ids[0] for r in before])
        check(set(top1.tolist()) <= set(range(live)),
              f"phase 7a: {mode} top-1 {top1} not live points")
        front.submit_update(insert_batch(new_ids, queries, device="cuda"),
                            1.0)
        front.submit_update(delete_batch(top1, cfg.dim, device="cuda"), 1.0)
        front.pump(2.0)
        t0 = time.perf_counter()
        did = idx.maybe_consolidate(force=True)
        torch.cuda.synchronize()
        consolidate_s = time.perf_counter() - t0
        # local frees its slots at once: nothing is left to consolidate
        check(front.metrics.n_updates == 2
              and did == (mode != "local")
              and int(idx.istate.graph.n_pending) == 0,
              f"phase 7a: {mode} updates {front.metrics.n_updates}, "
              f"forced consolidation ran: {did}, pending "
              f"{int(idx.istate.graph.n_pending)}")
        after = serve(3.0)
        same = all(r1.snapshot_seq == 0
                   and np.array_equal(r0.ext_ids, r1.ext_ids)
                   and np.array_equal(r0.dists, r1.dists)
                   for r0, r1 in zip(before, after))
        check(same, f"phase 7a: {mode} snapshot 0 answers changed under "
                    f"the writer")
        p0 = front.metrics.publish_s
        front.publish(4.0)
        publish_ms = (front.metrics.publish_s - p0) * 1e3
        final = serve(5.0)
        for i, r in enumerate(final):
            check(r.snapshot_seq == 1 and r.ext_ids[0] == new_ids[i],
                  f"phase 7a: {mode} query {i} after publish: seq "
                  f"{r.snapshot_seq}, ids {r.ext_ids}")
            check(not set(top1.tolist()) & set(r.ext_ids.tolist()),
                  f"phase 7a: {mode} served a deleted id: {r.ext_ids}")
        out[mode] = {"deleted": len(top1), "identical_under_writer": True,
                     "read_your_writes": True,
                     "update_ms": front.metrics.update_s * 1e3,
                     "consolidate_s": consolidate_s,
                     "publish_ms": publish_ms,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"7a {mode}: snapshot 0 bitwise under the writer, "
            f"read-your-writes after publish; updates "
            f"{out[mode]['update_ms']:.1f} ms, forced consolidation "
            f"{consolidate_s * 1e3:.1f} ms, publish {publish_ms:.3f} ms "
            f"(bound {out['publish_bound_ms']:.3f} ms for {nbytes} bytes "
            f"read and written), peak {out[mode]['peak_bytes']} bytes")
        del front, idx
    out["launches"] = ops.launch_counts()
    return out


def drive(front, trace, horizon):
    """Step the front door through a time-sorted ``(t, kind, payload)``
    trace, firing deadline expiries between events
    (``benchmarks/serve_bench.py::_drive``)."""
    for t, kind, payload in trace:
        while True:
            nd = front.next_event_time()
            if nd is None or nd > t:
                break
            front.pump(nd)
        if kind == "q":
            front.submit_query(payload, t)
        else:
            front.submit_update(payload, t)
        front.pump(t)
    while True:
        nd = front.next_event_time()
        if nd is None:
            break
        front.pump(max(nd, horizon))


def load_trace(seed, rate, horizon, queries, data, live, lanes, n_updates):
    """Poisson query arrivals at ``rate``/s over ``horizon`` (the dataset's
    queries in turn) and ``n_updates`` batches of ``lanes`` inserts
    (fresh ids) and deletes (the oldest live ids) in turns, spread evenly
    over the horizon (``benchmarks/serve_bench.py::_make_trace``)."""
    import numpy as np

    from repro_torch.core import delete_batch, insert_batch

    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            break
        events.append((t, "q", queries[len(events) % len(queries)]))
    nxt, oldest = live, 0
    for k in range(n_updates):
        tu = (k + 1) * horizon / (n_updates + 1)
        if k % 2 == 0:
            ids = np.arange(nxt, nxt + lanes)
            nxt += lanes
            batch = insert_batch(ids, data[ids], device="cuda")
        else:
            batch = delete_batch(np.arange(oldest, oldest + lanes), 128,
                                 device="cuda")
            oldest += lanes
        events.append((tu, "u", batch))
    events.sort(key=lambda e: e[0])
    return events, oldest


def final_recall(front, cfg, k=10):
    """Recall@k of the answers served from the final snapshot against the
    exact top-k (``topk_score``) over that snapshot's live set."""
    import numpy as np
    import torch

    from repro_torch.core import brute_force_topk

    snap = front.store.acquire()
    reqs = [r for d in front.completed for r in d.requests
            if r.snapshot_seq == snap.seq]
    q = torch.as_tensor(np.stack([r.vector for r in reqs]), device="cuda")
    true_slots, _ = brute_force_topk(snap.state.graph, cfg, q, k=k)
    truth = snap.state.slot2ext[true_slots.clamp(min=0).long()].cpu().numpy()
    front.store.release(snap)
    hits = sum(len(set(r.ext_ids.tolist()) & set(t.tolist()))
               for r, t in zip(reqs, truth))
    return hits / (k * len(reqs)), len(reqs)


def load_agrees(seed, cfg, start, data, queries, live, n_queries=2048,
                bucket=64, deadline_s=0.005, lanes=32, n_updates=8):
    """7b: open-loop load on the ip engine (``benchmarks/serve_bench.py``):
    Poisson arrivals at half the capacity of one warm full-bucket
    dispatch, ``query_only``, ``mixed`` and ``mixed_serialized``; mixed p99
    within 1.5x + 2 ms of query-only p99; Recall@10 of the final
    snapshot's answers >= 0.90 and no deleted id in them."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import ServingFront, StreamingEngine

    def make_front(serialize):
        front = ServingFront(StreamingEngine(serving_index(cfg, start, "ip")),
                             deadline_s=deadline_s, max_bucket=bucket, k=10,
                             publish_every=1, serialize_updates=serialize)
        front.warmup(update_buckets=[lanes])
        return front

    ops.reset_launch_counts()
    f0 = make_front(False)
    snap = f0.store.acquire()
    q = queries[:bucket]
    svc = []
    for _ in range(3):
        t0 = time.perf_counter()
        f0.engine.search(snap.state, q, 10, None)
        svc.append(time.perf_counter() - t0)
    f0.store.release(snap)
    del f0, snap
    capacity = bucket / min(svc)
    rate = 0.5 * capacity
    horizon = n_queries / rate
    out = {"bucket": bucket, "deadline_ms": deadline_s * 1e3,
           "update_lanes": lanes, "n_updates": n_updates,
           "full_bucket_service_ms": min(svc) * 1e3,
           "capacity_qps": capacity, "offered_qps": rate,
           "horizon_s": horizon}
    for name, n_upd, serialize in (("query_only", 0, False),
                                   ("mixed", n_updates, False),
                                   ("mixed_serialized", n_updates, True)):
        front = make_front(serialize)
        trace, n_deleted = load_trace(seed + 1, rate, horizon, queries, data,
                                      live, lanes, n_upd)
        t0 = time.perf_counter()
        drive(front, trace, horizon)
        torch.cuda.synchronize()
        s = front.metrics.stats(horizon_s=horizon)
        s["wall_s"] = time.perf_counter() - t0
        check(s["n_updates"] == n_upd and s["n_publishes"] == n_upd,
              f"phase 7b: {name} applied {s['n_updates']} updates, "
              f"published {s['n_publishes']}")
        if n_upd:
            rec, n_final = final_recall(front, cfg)
            served = {int(x) for d in front.completed for r in d.requests
                      if r.snapshot_seq == n_upd for x in r.ext_ids}
            check(not served & set(range(n_deleted)),
                  f"phase 7b: {name} served deleted ids from the final "
                  f"snapshot")
            check(rec >= 0.90, f"phase 7b: {name} Recall@10 {rec:.4f} of "
                               f"the final snapshot's answers < 0.90")
            s["final_recall"], s["final_queries"] = rec, n_final
        out[name] = s
        log(f"7b {name}: p50 {s['p50_ms']:.3f} / p95 {s['p95_ms']:.3f} / "
            f"p99 {s['p99_ms']:.3f} ms, {s['qps']:.0f} QPS achieved, "
            f"{s['updates_per_s']:.0f} update lanes/s, fill "
            f"{s['batch_fill']:.3f}, depth {s['mean_queue_depth']:.2f}, "
            f"search / update / publish {s['search_s']:.3f} / "
            f"{s['update_s']:.3f} / {s['publish_s']:.4f} s"
            + (f", final-snapshot Recall@10 {s['final_recall']:.4f} over "
               f"{s['final_queries']} queries" if n_upd else ""))
        del front
    qo, mx = out["query_only"]["p99_ms"], out["mixed"]["p99_ms"]
    out["gate_ms"] = 1.5 * qo + 2.0
    check(mx <= out["gate_ms"],
          f"phase 7b: mixed p99 {mx:.3f} ms above 1.5 x query-only p99 "
          f"{qo:.3f} + 2 = {out['gate_ms']:.3f} ms")
    log(f"7b: capacity {capacity:.0f} QPS (one {bucket}-query dispatch "
        f"{min(svc) * 1e3:.3f} ms), offered {rate:.0f} QPS over "
        f"{horizon:.4f} s; p99 query_only {qo:.3f}, mixed {mx:.3f} (gate "
        f"{out['gate_ms']:.3f}), mixed_serialized "
        f"{out['mixed_serialized']['p99_ms']:.3f} ms")
    out["launches"] = ops.launch_counts()
    return out


def launcher_agrees():
    """7c: ``repro_torch.launch.serve`` on the card at D = 128, plain and
    with a checkpoint every 4 ticks and a kill at tick 6: the same final
    state, ``active`` and final-tick ``recall@10``."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    flags = ["--dim", "128", "--rate", "16", "--lifetime", "4",
             "--ticks", "12"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    runs = {}
    ops.reset_launch_counts()
    try:
        for name, extra in (("plain", []),
                            ("kill", ["--checkpoint-dir", tmp,
                                      "--checkpoint-every", "4",
                                      "--kill-at", "6"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                idx = serve.main(flags + extra)
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            for line in text.splitlines():
                log(f"7c {name}: {line}")
            ticks = re.findall(r"^tick +(\d+) .* recall@10=([0-9.]+) "
                               r"active=(\d+)$", text, re.M)
            check(idx.device.type == "cuda" and ticks,
                  f"phase 7c: {name} ran on {idx.device}, ticks {ticks}")
            runs[name] = {"idx": idx, "wall_s": wall, "last_tick": ticks[-1],
                          "text": text,
                          "summary": text.strip().splitlines()[-1]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = runs["plain"], runs["kill"]
    check("injected kill at tick 6); restored tick 4" in b["text"],
          "phase 7c: the killed run did not restore tick 4")
    bad = [p for p, same in differing_leaves(a["idx"].istate,
                                             b["idx"].istate, "state")
           if not same]
    check(a["last_tick"] == b["last_tick"]
          and a["idx"].n_active == b["idx"].n_active and not bad,
          f"phase 7c: the replayed run ends at {b['last_tick']}, active "
          f"{b['idx'].n_active}, against {a['last_tick']}, "
          f"{a['idx'].n_active}; leaves differ: {bad}")
    return {"plain_wall_s": a["wall_s"], "kill_wall_s": b["wall_s"],
            "final_tick": list(a["last_tick"]),
            "active": a["idx"].n_active,
            "summaries": [a["summary"], b["summary"]],
            "identical": True, "launches": ops.launch_counts()}


def serving_path(seed, cfg, start, data, queries):
    """Phase 7: the serving front door over phase 6's start state."""
    live = int(start.graph.n_active)
    out, launches = {"live": live}, {}
    for key, fn in (("7a", lambda: isolation_agrees(cfg, start, data, live)),
                    ("7b", lambda: load_agrees(seed, cfg, start, data,
                                               queries, live)),
                    ("7c", launcher_agrees)):
        t0 = time.perf_counter()
        out[key] = fn()
        out[f"{key}_s"] = time.perf_counter() - t0
        add_counts(launches, out[key]["launches"])
        log(f"{key}: {out[f'{key}_s']:.1f} s, launches "
            f"{ {k: v for k, v in out[key]['launches'].items() if v} }")
    out["launches"] = launches
    for key, names in (("7a", ("gather_distance_batched", "beam_hop_fused")),
                       ("7b", SERVING_PATH), ("7c", SERVING_PATH)):
        for name in names:
            check(out[key]["launches"].get(name, 0) > 0,
                  f"phase {key}: kernel {name} never launched")
    return out


# ---------------------------------------------------------------------------
# phase 8: the sharded index on the card
# ---------------------------------------------------------------------------


def host_merge(parts, k):
    """The flat merge of per-row ``(ext ids, dists)`` answers, numpy: (row,
    k) order, a stable sort (ties to the lower flat index).  Returns ids,
    owner rows, dists."""
    import numpy as np

    ids = np.concatenate([p[0] for p in parts], axis=1)
    d = np.concatenate([p[1] for p in parts], axis=1)
    rows = np.concatenate([np.full(p[0].shape, i, np.int32)
                           for i, p in enumerate(parts)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return tuple(np.take_along_axis(x, order, axis=1) for x in (ids, rows, d))


def rows_differ(a, b):
    """Paths of the leaves that differ between two indexes' rows."""
    return [p for i, (x, y) in enumerate(zip(a.rows, b.rows))
            for p, same in differing_leaves(x, y, f"row{i}") if not same]


def sharded_build(cfg, data, mgr, dev, n_logical=4, n_boot=256):
    """8a: a ``ShardedIndex`` of ``n_logical`` rows on ``dev``, ``n_boot``
    serial inserts through ``insert`` (kernel 2), a checkpoint."""
    import numpy as np
    import torch

    from repro_torch.core import ShardedIndex

    idx = ShardedIndex(cfg, [dev], n_logical=n_logical, sequential=True)
    check(all(r.graph.vectors.device == dev for r in idx.rows),
          "phase 8a: rows are not on the card")
    ids = np.arange(n_boot)
    idx.synchronize()
    t0 = time.perf_counter()
    slots, owners = idx.insert(ids, data[ids])
    idx.synchronize()
    insert_s = time.perf_counter() - t0
    per_row = np.bincount(owners, minlength=n_logical)
    check((slots >= 0).all() and idx.n_active == n_boot,
          f"phase 8a: {idx.n_active} of {n_boot} inserted")
    t0 = time.perf_counter()
    idx.save(mgr, 0)
    save_s = time.perf_counter() - t0
    step_dir = next(p for p in Path(mgr.dir).iterdir() if p.is_dir())
    nbytes = sum(f.stat().st_size for f in step_dir.rglob("*") if f.is_file())
    out = {"n_logical": n_logical, "n_cap_per_row": cfg.n_cap,
           "serial_inserts": n_boot, "per_row": per_row.tolist(),
           "insert_s": insert_s, "ms_per_insert": insert_s / n_boot * 1e3,
           "save_s": save_s, "checkpoint_bytes": nbytes,
           "row_bytes": state_bytes(idx.rows[0])}
    log(f"8a: {n_boot} serial inserts over {n_logical} rows {per_row} in "
        f"{insert_s:.1f} s ({out['ms_per_insert']:.1f} ms each); save "
        f"{save_s:.2f} s, {nbytes} bytes")
    del idx
    torch.cuda.empty_cache()
    return out


def sharded_layouts(cfg, data, mgr, layouts, n_boot=256, n_ins=768,
                    n_del=256, lanes=64, max_t=8, seed=0):
    """8b: the checkpoint restored onto each layout (``sequential=False``)
    and fed one ``update_stream`` (``n_ins`` inserts then ``n_del``
    deletes, ``lanes`` a step): every leaf of every row bitwise equal
    across layouts."""
    import numpy as np

    from repro_torch.core import ShardedIndex, delete_batch, insert_batch

    rng = np.random.default_rng(seed + 31)
    live = n_boot + n_ins
    dels = rng.choice(live, size=n_del, replace=False)
    steps = [insert_batch(np.arange(lo, lo + lanes), data[lo:lo + lanes],
                          device="cpu")
             for lo in range(n_boot, live, lanes)]
    steps += [delete_batch(dels[lo:lo + lanes], cfg.dim, device="cpu")
              for lo in range(0, n_del, lanes)]
    out, idxs = {"steps": len(steps), "lanes": lanes, "max_t": max_t}, {}
    for name, devs in layouts.items():
        t0 = time.perf_counter()
        idx, step = ShardedIndex.restore(mgr, cfg, devs, sequential=False)
        idx.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == 0 and idx.n_active == n_boot,
              f"phase 8b: {name} restored step {step}, {idx.n_active} live")
        t0 = time.perf_counter()
        res = idx.update_stream(steps, max_t=max_t)
        idx.synchronize()
        dt = time.perf_counter() - t0
        n_ok = sum(int(r.ok.sum()) for r in res)
        check(n_ok == n_ins + n_del and idx.n_active == live - n_del,
              f"phase 8b: {name} applied {n_ok} lanes, {idx.n_active} live")
        out[name] = {
            "devices": [str(d) for d in devs], "restore_s": restore_s,
            "segments": len(res), "stream_s": dt,
            "lanes_per_s": (n_ins + n_del) / dt,
            "ms_per_row_apply": dt * 1e3 / (len(steps) * idx.n_logical),
            "consolidated_rows_ops": int(sum(r.consolidated.sum()
                                             for r in res))}
        log(f"8b {name} ({out[name]['devices']}): restore {restore_s:.2f} s; "
            f"{len(steps)} steps in {len(res)} segments, {dt:.1f} s, "
            f"{out[name]['lanes_per_s']:.1f} lanes/s, "
            f"{out[name]['ms_per_row_apply']:.1f} ms per row-apply")
        idxs[name] = idx
    names = list(idxs)
    for other in names[1:]:
        bad = rows_differ(idxs[names[0]], idxs[other])
        check(not bad, f"phase 8b: layouts {names[0]} and {other} differ in "
                       f"{bad[:8]}")
    out["identical"] = True
    return out, idxs, dels


def sharded_search(cfg, idxs, queries, dels, qb=256, k=10):
    """8c: both partitions on every layout, batches of ``qb``: the same
    ids, rows and distances; equal to a host merge of the per-row
    ``search`` answers; Recall@10 against ``topk_score`` over the union of
    the rows >= 0.90; no deleted id."""
    import numpy as np
    import torch

    from repro_torch.core import brute_force_topk, search_index

    out, answers = {"batch": qb, "queries": len(queries)}, {}
    for name, idx in idxs.items():
        for part in (None, "queries"):
            idx.search(queries[:qb], k=k, l=cfg.l_search, partition=part)
            idx.synchronize()
            t0 = time.perf_counter()
            got = [idx.search(queries[lo:lo + qb], k=k, l=cfg.l_search,
                              partition=part)
                   for lo in range(0, len(queries), qb)]
            idx.synchronize()
            dt = time.perf_counter() - t0
            key = f"{name}/{part or 'replicate'}"
            answers[key] = tuple(np.concatenate([g[i] for g in got])
                                 for i in range(3))
            out[key] = {"qps": len(queries) / dt, "s": dt,
                        "comps": sum(g[3] for g in got)}
            log(f"8c {key}: {out[key]['qps']:.0f} QPS at B = {qb}")
    keys = list(answers)
    for other in keys[1:]:
        same = all(np.array_equal(a, b) for a, b in
                   zip(answers[keys[0]], answers[other]))
        check(same, f"phase 8c: {keys[0]} and {other} answers differ")
    idx = next(iter(idxs.values()))
    qt = torch.from_numpy(queries).to(idx.devices[0])
    per_row, truth = [], []
    for row in idx.rows:
        q = qt.to(row.ext2slot.device)
        parts_a, parts_b = [], []
        for lo in range(0, len(queries), qb):
            ext, d, _ = search_index(row, cfg, q[lo:lo + qb], k=k,
                                     l=cfg.l_search)
            parts_a.append(ext.cpu().numpy())
            parts_b.append(d.cpu().numpy())
        per_row.append((np.concatenate(parts_a), np.concatenate(parts_b)))
        slots, d = brute_force_topk(row, cfg, q, k=k)
        ext = torch.where(slots >= 0,
                          row.slot2ext[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1))
        truth.append((ext.cpu().numpy(), d.cpu().numpy()))
    merged = host_merge(per_row, k)
    ref = answers[keys[0]]
    check(all(np.array_equal(a, b) for a, b in zip(merged, ref)),
          "phase 8c: the sharded answers differ from a host merge of the "
          "per-row searches")
    exact = host_merge(truth, k)[0]
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ref[0], exact))
    rec = hits / (k * len(queries))
    check(rec >= 0.90, f"phase 8c: Recall@10 {rec:.4f} < 0.90")
    check(not np.isin(ref[0], dels).any(), "phase 8c: a deleted id came back")
    out["recall"] = rec
    out["identical"] = True
    log(f"8c: partitions and layouts identical, equal to the host merge; "
        f"Recall@10 {rec:.4f} over the union of {len(idx.rows)} rows")
    return out


def sharded_routing_and_fresh(cfg, data, mgr, dev, seed, first_new,
                              fresh_cap=2048, n_fresh=512, n_fresh_del=256,
                              lanes=64):
    """8d: one update batch under replicate routing equals compact routing
    (rows and slots); a fresh index of two rows gets a delete-heavy stream:
    ``consolidate_sharded`` fires, then nothing pending, no tombstone, no
    edge into an inactive slot."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.core import ShardedIndex, delete_batch, insert_batch

    ids = np.arange(first_new, first_new + lanes)
    runs = {}
    for routing in ("compact", "replicate"):
        idx, _ = ShardedIndex.restore(mgr, cfg, [dev], routing=routing,
                                      sequential=False)
        idx.synchronize()
        t0 = time.perf_counter()
        slots, _ = idx.insert(ids, data[ids])
        idx.synchronize()
        runs[routing] = (idx, slots, time.perf_counter() - t0)
    (a, sa, ta), (b, sb, tb) = runs["compact"], runs["replicate"]
    bad = rows_differ(a, b)
    check(not bad and np.array_equal(sa, sb),
          f"phase 8d: replicate and compact routing differ in {bad[:8]}")
    out = {"routing": {"lanes": lanes, "compact_s": ta, "replicate_s": tb,
                       "identical": True}}
    log(f"8d: one {lanes}-lane batch, compact {ta:.2f} s, replicate "
        f"{tb:.2f} s, rows identical")
    del runs, a, b

    fcfg = dc.replace(cfg, n_cap=fresh_cap)
    idx = ShardedIndex(fcfg, [dev], policy="fresh", n_logical=2,
                       sequential=False)
    rng = np.random.default_rng(seed + 37)
    dels = rng.choice(n_fresh, size=n_fresh_del, replace=False)
    steps = [insert_batch(np.arange(lo, lo + lanes), data[lo:lo + lanes],
                          device="cpu") for lo in range(0, n_fresh, lanes)]
    steps += [delete_batch(dels[lo:lo + lanes], cfg.dim, device="cpu")
              for lo in range(0, n_fresh_del, lanes)]
    t0 = time.perf_counter()
    res = idx.update_stream(steps, max_t=8)
    idx.synchronize()
    dt = time.perf_counter() - t0
    fired = sorted({int(r) for s in res
                    for r in np.nonzero(s.needs_consolidation.any(1))[0]})
    check(fired, "phase 8d: the fresh stream never flagged a row")
    for i, row in enumerate(idx.rows):
        g = row.graph
        check(int(g.n_pending) == 0 and not bool(g.tombstone.any()),
              f"phase 8d: fresh row {i} left {int(g.n_pending)} pending")
        check(edges_into_inactive(g.adj, g.active) == 0,
              f"phase 8d: fresh row {i} has edges into inactive slots")
    check(idx.n_active == n_fresh - n_fresh_del,
          f"phase 8d: fresh live count {idx.n_active}")
    out["fresh"] = {"n_cap_per_row": fresh_cap, "inserts": n_fresh,
                    "deletes": n_fresh_del, "stream_s": dt,
                    "rows_consolidated": fired}
    log(f"8d: fresh stream {dt:.1f} s, rows {fired} consolidated, nothing "
        f"pending, no edge into an inactive slot")
    return out


def sharded_serving(cfg, idx, data, queries_at, new_ids, dels):
    """8e: ``ServingFront(ShardedEngine(idx))``: snapshot-0 answers bitwise
    under the writer, the new ids top-1 after a publish, no deleted id;
    publish ms against the bytes of every row read and written once."""
    import numpy as np

    from repro_torch.core import delete_batch, insert_batch
    from repro_torch.serving import ServingFront, ShardedEngine

    dev = idx.devices[0]
    nbytes = sum(state_bytes(r) for r in idx.rows)
    front = ServingFront(ShardedEngine(idx), deadline_s=0.0, max_bucket=8,
                         k=10, publish_every=10**9)

    def serve(now):
        reqs = [front.submit_query(q, now) for q in queries_at]
        front.pump(now + 1.0)
        return reqs

    before = serve(0.0)
    top1 = np.unique([r.ext_ids[0] for r in before])
    check(not np.isin(top1, dels).any(), "phase 8e: a deleted id is top-1")
    front.submit_update(insert_batch(new_ids, queries_at, device=dev), 1.0)
    front.submit_update(delete_batch(top1, cfg.dim, device=dev), 1.0)
    front.pump(2.0)
    after = serve(3.0)
    same = all(r1.snapshot_seq == 0 and np.array_equal(r0.ext_ids, r1.ext_ids)
               and np.array_equal(r0.dists, r1.dists)
               for r0, r1 in zip(before, after))
    check(front.metrics.n_updates == 2 and same,
          "phase 8e: snapshot 0 answers changed under the writer")
    p0 = front.metrics.publish_s
    front.publish(4.0)
    publish_ms = (front.metrics.publish_s - p0) * 1e3
    final = serve(5.0)
    for i, r in enumerate(final):
        check(r.snapshot_seq == 1 and r.ext_ids[0] == new_ids[i]
              and not set(top1.tolist()) & set(r.ext_ids.tolist()),
              f"phase 8e: query {i} after publish: seq {r.snapshot_seq}, "
              f"ids {r.ext_ids}")
    # a second publish reuses the freed slot's blocks: the first one also
    # pays the allocator for a new copy of every row
    p1 = front.metrics.publish_s
    front.publish(6.0)
    republish_ms = (front.metrics.publish_s - p1) * 1e3
    out = {"identical_under_writer": True, "read_your_writes": True,
           "update_ms": front.metrics.update_s * 1e3,
           "publish_ms": publish_ms, "republish_ms": republish_ms,
           "state_bytes": nbytes,
           "publish_bound_ms": bound_ms(2 * nbytes, 0)[0]}
    log(f"8e: snapshot 0 bitwise under the writer, read-your-writes; "
        f"updates {out['update_ms']:.1f} ms, publish {publish_ms:.3f} ms, "
        f"again {republish_ms:.3f} ms (bound "
        f"{out['publish_bound_ms']:.3f} ms for {nbytes} bytes)")
    return out


def sharded_launcher(device="cuda"):
    """8e: ``repro_torch.launch.serve --shards 2`` at D = 128, plain and
    killed at tick 6 with a checkpoint every 4 ticks: equal rows."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.launch import serve

    flags = ["--dim", "128", "--rate", "16", "--lifetime", "4",
             "--ticks", "8", "--shards", "2", "--device", device]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    runs = {}
    try:
        for name, extra in (("plain", []),
                            ("kill", ["--checkpoint-dir", tmp,
                                      "--checkpoint-every", "4",
                                      "--kill-at", "6"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                idx = serve.main(flags + extra)
            text = buf.getvalue()
            for line in text.splitlines():
                log(f"8e {name}: {line}")
            check(idx.devices[0].type == device and idx.n_logical == 2
                  and re.search(r"^served 8 ticks shards=2: ", text, re.M),
                  f"phase 8e: launcher {name} on {idx.devices}")
            runs[name] = (idx, time.perf_counter() - t0, text)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (a, ta, _), (b, tb, text) = runs["plain"], runs["kill"]
    check("restored sharded checkpoint at tick 4 (2 logical shards on 2 "
          "devices)" in text, "phase 8e: the killed run did not restore "
                              "tick 4")
    bad = rows_differ(a, b)
    check(not bad and a.n_active == b.n_active,
          f"phase 8e: the replayed launcher differs in {bad[:8]}")
    return {"plain_wall_s": ta, "kill_wall_s": tb, "active": a.n_active,
            "identical": True}


def sharded_path(seed, n_cap=1 << 18, n_logical=4):
    """Phase 8: ``ShardedIndex`` over ``n_logical`` rows of ``n_cap`` slots
    at D = 128 on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import ANNConfig, make_dataset
    from repro_torch.kernels import ops

    cfg = ANNConfig(dim=128, n_cap=n_cap)
    data, queries = make_dataset(1200, 128, "l2", n_queries=1024,
                                 seed=seed + 29)
    dev = torch.device("cuda", 0)
    layouts = {"S1": [dev], "S2": [dev, dev]}
    if torch.cuda.device_count() >= 2:
        layouts["S2_two_cards"] = [dev, torch.device("cuda", 1)]
    log(f"phase 8 layouts: {layouts}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    out = {"cfg": {"n_logical": n_logical, "n_cap_per_row": n_cap,
                   "dim": cfg.dim, "r": cfg.r, "l_search": cfg.l_search},
           "layouts": list(layouts)}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        mgr = timed_manager(tmp, keep=2)
        t0 = time.perf_counter()
        out["8a"] = sharded_build(cfg, data, mgr, dev, n_logical)
        out["8a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["8b"], idxs, dels = sharded_layouts(cfg, data, mgr, layouts,
                                                seed=seed)
        out["8b"]["load_s"] = list(mgr.load_s)
        out["8b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["8c"] = sharded_search(cfg, idxs, queries, dels)
        out["8c_s"] = time.perf_counter() - t0
        writer = idxs["S2"]
        del idxs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["8d"] = sharded_routing_and_fresh(cfg, data, mgr, dev, seed,
                                              first_new=1024)
        out["8d_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        live = np.setdiff1d(np.arange(1024), dels)
        out["8e"] = sharded_serving(cfg, writer, data,
                                    data[live[:8]] + np.float32(0.01),
                                    np.arange(1100, 1108), dels)
        del writer
        torch.cuda.empty_cache()
        out["8e"]["launcher"] = sharded_launcher()
        out["8e_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = ops.launch_counts()
    log(f"phase 8 launches {out['launches']}, peak "
        f"{out['peak_mem_bytes']} bytes")
    for name in F32_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the sharded path")
    return out


# ---------------------------------------------------------------------------
# phase 9: the recsys family and the two-tower retrieval path on the card
# ---------------------------------------------------------------------------

# the full-width archs, in the order phase 9 runs them (each freed before
# the next); dlrm-mlperf's 26 Criteo-1TB tables (96.1 GB padded) do not fit
# one 80 GB card, so each keeps its width and at most 2^23 rows
RECSYS_ARCHS = ("two-tower-retrieval", "dlrm-rm2", "din", "dlrm-mlperf")
MLPERF_ROW_CAP = 1 << 23
# DIN scores 10^6 retrieval candidates in slices of this many targets: one
# pass would need ~77 GB of activations; each candidate is scored alone, so
# the slices concatenated are the one pass
DIN_SLICE = 262_144
RECSYS_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")


def recsys_spec(name):
    """The registered full-width spec; ``dlrm-mlperf`` with each table
    capped at ``MLPERF_ROW_CAP`` rows."""
    from repro_torch.configs import get_arch

    spec = get_arch(name)
    if name == "dlrm-mlperf":
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, vocab_sizes=tuple(min(v, MLPERF_ROW_CAP)
                                        for v in spec.cfg.vocab_sizes)))
    return spec


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def untied(vals, rtol=2e-5):
    """(B, k) bool from (B, k + 1) sorted values: True where value j is
    not within tolerance of value j - 1 or j + 1 (its id must then match
    exactly).  The absolute floor is ``rtol`` of the row's largest
    magnitude."""
    import torch

    v = vals.double()
    atol = rtol * v.abs().amax(1, keepdim=True)
    near = (v[:, 1:] - v[:, :-1]).abs() <= atol + rtol * v[:, 1:].abs()
    k = vals.shape[1] - 1
    left = torch.zeros_like(near[:, :k])
    left[:, 1:] = near[:, :k - 1]
    return ~(left | near[:, :k])


def ids_agree(ids_a, ids_b, vals_ext):
    """Ids equal wherever ``vals_ext`` (the plain side's values with one
    extra column) shows no near-tie."""
    return bool(((ids_a.cpu() == ids_b.cpu())
                 | ~untied(vals_ext.cpu())).all())


def recsys_arch(spec, dev, seed):
    """9a: one arch at full width: ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` through ``make_step``, ms per step (CUDA events,
    warm, median of 5), every score finite, ``serve_p99`` (and two-tower's
    ``retrieval_cand``) against the same step on a CPU copy of the state
    and inputs.  Returns the record and the state (the two-tower's feeds
    the twin)."""
    import torch

    name = spec.name
    shapes = spec.shapes()
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the retrieval state holds the params (and two-tower's cand_embs)
    state = spec.init_state(shapes["retrieval_cand"], dev, gen)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "state_bytes": state_bytes(state)}
    cpu_state = None
    for sname in RECSYS_SHAPES:
        shape = shapes[sname]
        inputs = spec.make_inputs(shape, dev, gen)
        step = spec.make_step(shape)
        if name == "din" and sname == "retrieval_cand":
            def run(step=step, inputs=inputs):
                tgt = inputs["target"]
                return {"scores": torch.cat([
                    step(state, {**inputs, "target": tgt[lo:lo + DIN_SLICE]}
                         )[1]["scores"]
                    for lo in range(0, tgt.shape[0], DIN_SLICE)])}
        else:
            def run(step=step, inputs=inputs):
                return step(state, inputs)[1]
        res = run()
        fin = all(bool(torch.isfinite(v.float()).all()) for v in res.values())
        check(fin, f"phase 9a: {name} {sname} scores not finite")
        ms = interleaved_ms([run], 5)[0]
        flops = spec.model_flops(shape)
        row = {"dims": dict(shape.dims), "ms": ms, "model_flops": flops,
               "tflop_per_s": flops / ms / 1e9,
               "out_shapes": {k: list(v.shape) for k, v in res.items()}}
        if sname == "serve_p99" or (sname == "retrieval_cand"
                                    and "ids" in res):
            if cpu_state is None:
                t1 = time.perf_counter()
                cpu_state = tree_to(state, "cpu")
                out["cpu_copy_s"] = time.perf_counter() - t1
            cpu_in = tree_to(inputs, "cpu")
            ref = step(cpu_state, cpu_in)[1]
            for key, v in ref.items():
                got = res[key].cpu()
                if key == "ids":
                    from repro_torch.models import recsys as rec

                    ext = rec.two_tower_score_candidates(
                        cpu_state["params"], spec.cfg, cpu_in["user_ids"],
                        cpu_state["cand_embs"], k=v.shape[1] + 1)[0]
                    check(ids_agree(got, v, ext),
                          f"phase 9a: {name} {sname} ids differ from the "
                          f"CPU step away from ties")
                    continue
                diff = (got - v).abs()
                err = float(diff.max())
                nz = v != 0
                rel = float((diff[nz] / v[nz].abs()).max()) if nz.any() \
                    else 0.0
                # two-tower's scores are inner products of ~1e-4: the
                # absolute floor is scaled to the output where it is below
                # 1, so that a TF32-sized error shows
                atol = 1e-5 * min(1.0, float(v.abs().max()))
                check(torch.allclose(got, v, rtol=2e-5, atol=atol),
                      f"phase 9a: {name} {sname} {key} differs from the "
                      f"CPU step (max abs err {err}, max rel err {rel})")
                row.update(cpu_max_abs_err=err, cpu_max_rel_err=rel,
                           cpu_atol=atol)
            row["cpu_agrees"] = True
        out[sname] = row
        log(f"9a {name} {sname} {shape.dims}: {ms:.3f} ms a step, "
            f"{row['tflop_per_s']:.2f} TFLOP/s" +
            (", equal to the CPU step" if row.get("cpu_agrees") else ""))
        del res, inputs
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"9a {name}: state {out['state_bytes']} bytes, peak "
        f"{out['peak_mem_bytes']} bytes")
    return out, state


def gather_parity_ip(name, kern, plain, lib, tiles, grid, row_bytes, nq):
    """Kernel 1 or 2 under ``ip`` against its plain version on ``tiles[0]``
    (``kern``, ``plain`` and ``lib`` take a tile's index): bitwise on grid
    data, rtol 1e-5 on Gaussian data, where also its times.  Timed cold,
    each call on the next tile, whose rows the L2 does not hold (the tiles'
    rows are far more than its 50 MB), and the kernel also warm, on one
    tile again and again (kernel 1's 30 MB of rows then stay in the L2)."""
    import itertools

    import torch

    a, p = kern(0), plain(0)
    torch.cuda.synchronize()
    fin = torch.isfinite(p)
    check(torch.equal(torch.isfinite(a), fin), f"9b {name}: inf mask")
    err = float((a[fin] - p[fin]).abs().max()) if fin.any() else 0.0
    if grid:
        check(torch.equal(a, p), f"9b {name}: grid data not bitwise")
        return {"max_abs_err": err}
    check(torch.allclose(a[fin], p[fin], rtol=1e-5, atol=1e-4),
          f"9b {name}: gaussian max err {err}")
    d = row_bytes // 4
    nvalid = sum(int((t >= 0).sum()) for t in tiles) / len(tiles)
    by = nvalid * row_bytes + tiles[0].numel() * 8 + nq * d * 4
    bms, bby = bound_ms(by, nvalid * 2 * d)
    order = itertools.cycle(range(len(tiles)))

    def nxt():
        return next(order)

    names = DEVICE_KERNELS[name]
    return {"max_abs_err": err, "ms": cuda_ms(kern, 50, setup=nxt),
            "timing": f"cold: each call on the next of {len(tiles)} tiles",
            "device_ms": device_ms(kern, 50, names, setup=nxt),
            "device_ms_warm": device_ms(lambda _: kern(0), 50, names),
            "plain_ms": cuda_ms(plain, 20, setup=nxt),
            "library_ms": cuda_ms(lib, 20, setup=nxt),
            "library_call": "torch.bmm(vectors[ids], q)",
            "bound_ms": bms, "bound_by": bby}


def recsys_kernels_ip(seed, n, d=256, r=64, l=128, b=512, h=4):
    """9b: kernels 1, 2 and 3 at D = 256 under ``ip`` against their plain
    versions, on grid and Gaussian tables of the catalogue's size: one
    (B, K) = (512, 64) tile, one serial K = 64 gather (the launcher bound
    once per search), four H = 4 super-steps from a fresh carry, the last
    one timed from its mid-search carry (l = 128, R = 64)."""
    from functools import partial

    import torch

    from repro_torch.core import bitset
    from repro_torch.kernels import beam_hop as bh
    from repro_torch.kernels import gather_distance as gd

    gen = torch.Generator(device="cuda")
    rows = {}
    for data in ("grid", "gauss"):
        grid = data == "grid"
        gen.manual_seed(seed + (40 if grid else 41))
        vec = make_table(n, d, grid, gen)
        qi = torch.randint(0, n, (b,), generator=gen, device="cuda")
        noise = (torch.randint(-2, 3, (b, d), generator=gen, device="cuda")
                 .to(torch.float32) / 16 if grid
                 else make_table(b, d, grid, gen) / 16)
        qb = (vec[qi] + noise).contiguous()
        ids = torch.randint(0, n, (b, r), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[torch.rand((b, r), generator=gen, device="cuda") < 0.1] = -1
        # the timed tiles: ``ids`` and 15 more of its kind, from a generator
        # of their own (kernel 3's data stays as it was)
        tgen = torch.Generator(device="cuda").manual_seed(seed + 42)
        tiles = [ids] + [
            torch.where(torch.rand((b, r), generator=tgen, device="cuda")
                        < 0.1, -1, torch.randint(
                            0, n, (b, r), generator=tgen, device="cuda",
                            dtype=torch.int32))
            for _ in range(0 if grid else 15)]
        i2 = [t.clamp(min=0).long() for t in tiles]
        res = {}
        res["gather_distance_batched"] = gather_parity_ip(
            "gather_distance_batched",
            lambda j: gd.gather_distance_batched_cuda(tiles[j], qb, vec,
                                                      None, metric="ip"),
            lambda j: gd.gather_distance_batched_plain(tiles[j], qb, vec,
                                                       None, metric="ip"),
            lambda j: torch.bmm(vec[i2[j]], qb[:, :, None]),
            tiles, grid, 4 * d, b)
        # the serial gather over one row of ids, the next row of the next
        # tile each call
        rows1 = [t[i] for i in range(b) for t in tiles]
        bound = gd.BoundGather(qb[0], vec, None, metric="ip")
        res["gather_distance"] = gather_parity_ip(
            "gather_distance", lambda j: bound(rows1[j]),
            lambda j: gd.gather_distance_plain(rows1[j], qb[0], vec, None,
                                               metric="ip"),
            lambda j: torch.bmm(vec[i2[j % len(tiles)][j // len(tiles)]]
                                [None], qb[:1, :, None]),
            rows1, grid, 4 * d, 1)
        adj = torch.randint(0, n, (n, r), generator=gen, device="cuda",
                            dtype=torch.int32)
        adj[torch.rand((n, r), generator=gen, device="cuda") < 0.15] = -1
        nav = torch.rand((n,), generator=gen, device="cuda") < 0.98
        ret = nav & (torch.rand((n,), generator=gen, device="cuda") < 0.95)
        nav_w, ret_w = bitset.pack_bits(nav), bitset.pack_bits(ret)
        norms = (vec * vec).sum(1)
        start = int(torch.nonzero(ret)[0])
        lanes_valid = torch.arange(b, device="cuda") % 17 != 5
        starts = torch.where(lanes_valid, start, -1).to(torch.int32)
        d0 = gd.gather_distance_batched_plain(starts[:, None], qb, vec,
                                              norms, metric="ip")[:, 0]
        res["beam_hop_fused"] = hop_parity(
            "beam_hop_fused", partial(bh.beam_hop_fused_plain, metric="ip"),
            partial(bh.beam_hop_fused_cuda, metric="ip"),
            lambda q, c: bh.BoundBeamHop(q, c, adj, vec, norms, nav_w, ret_w,
                                         metric="ip", h=h),
            qb, (adj, vec, norms, nav_w, ret_w), starts, d0, grid, n, l,
            l + 64, h, 4 * d, steps=4)
        del vec, adj, norms
        torch.cuda.empty_cache()
        rows[data] = res
        log(f"9b {data}: kernels 1-3 at D = {d} under ip equal to their "
            f"plain versions: " + json.dumps(
                {k: v.get("device_ms", v["max_abs_err"])
                 for k, v in res.items()}))
    return rows


def path_a_parity(users, cand, served, k=10):
    """Path A's answer against the plain version on the same tensors: ids
    equal away from near-ties, distances to rtol 1e-5; its times and
    bound (2 N B D flops)."""
    import torch

    from repro_torch.kernels import topk_score as tk

    norms = (cand * cand).sum(1)
    kv, ki = served
    pv, pi = tk.topk_score_plain(users, cand, norms, None, k=k + 1,
                                 metric="ip")
    torch.cuda.synchronize()
    err = float((kv - pv[:, :k]).abs().max())
    # the tower's outputs are small (inner products ~1e-4): the absolute
    # floor is scaled to them
    scale = float(pv[:, :k].abs().max())
    check(torch.allclose(kv, pv[:, :k], rtol=1e-5, atol=1e-5 * scale),
          f"9c path A: distances differ from the plain version ({err})")
    check(ids_agree(ki, pi[:, :k], pv),
          "9c path A: ids differ from the plain version away from ties")
    b, d = users.shape
    n = cand.shape[0]
    by = n * d * 4 + b * d * 4 + b * k * 8
    bms, bby = bound_ms(by, 2.0 * n * b * d)
    ms = cuda_ms(lambda _: tk.topk_score_cuda(users, cand, norms, None, k=k,
                                              metric="ip"), 5)
    dms = device_ms(lambda _: tk.topk_score_cuda(users, cand, norms, None,
                                                 k=k, metric="ip"), 5,
                    DEVICE_KERNELS["topk_score"])
    pms = cuda_ms(lambda _: tk.topk_score_plain(users, cand, norms, None, k=k,
                                                metric="ip"), 2)
    lms = cuda_ms(lambda _: torch.topk(users @ cand.T, k), 3)
    return {"queries": b, "rows": n, "dim": d, "k": k, "max_abs_err": err,
            "ms": ms, "device_ms": dms, "plain_ms": pms, "library_ms": lms,
            "library_call": "torch.topk(users @ cand.T, k)",
            "bound_ms": bms, "bound_by": bby}


def path_b(cand, users, dev, n_boot=256, n_stream=1792, lanes=64, qb=256,
           n_cap=1 << 18, n_logical=4, k=10):
    """9c path B: ``ShardedIndex(high_recall(D, 2^18, "ip"), [dev],
    n_logical=4)`` over the first ``n_boot + n_stream`` catalogue items
    (external id = item id): ``n_boot`` serial inserts through ``insert``
    (kernel 2), the rest through ``update_stream`` in ``lanes``-lane steps
    with ``sequential=False``, every second item deleted in place, the
    user vectors queried at B = ``qb`` under both partitions.  Gates: both
    partitions equal to a host merge of the per-row searches, no deleted
    id.  Returns the record (with the launch counts read before those
    checks) and, before and after the deletes, (ids, live ids) for the
    recall oracle."""
    import numpy as np
    import torch

    from repro_torch.configs import high_recall
    from repro_torch.core import ShardedIndex, insert_batch, search_index
    from repro_torch.kernels import ops

    n_items = n_boot + n_stream
    embs = cand[:n_items].cpu().numpy()
    cfg = high_recall(cand.shape[1], n_cap, metric="ip")
    idx = ShardedIndex(cfg, [dev], n_logical=n_logical)
    out = {"n_logical": n_logical, "n_cap_per_row": n_cap,
           "dim": cfg.dim, "r": cfg.r, "l_search": cfg.l_search}
    idx.synchronize()
    t0 = time.perf_counter()
    idx.insert(np.arange(n_boot), embs[:n_boot])
    idx.synchronize()
    out["serial_insert_s"] = time.perf_counter() - t0
    out["ms_per_serial_insert"] = out["serial_insert_s"] / n_boot * 1e3
    # the stream runs the relaxed-visibility batched phases
    idx.sequential = False
    steps = [insert_batch(np.arange(lo, lo + lanes), embs[lo:lo + lanes],
                          device="cpu")
             for lo in range(n_boot, n_items, lanes)]
    t0 = time.perf_counter()
    res = idx.update_stream(steps, max_t=8)
    idx.synchronize()
    dt = time.perf_counter() - t0
    n_ok = sum(int(r.ok.sum()) for r in res)
    check(n_ok == n_stream and idx.n_active == n_items,
          f"phase 9c: the stream applied {n_ok} of {n_stream} lanes")
    out.update(stream_lanes=n_stream, stream_steps=len(steps), stream_s=dt,
               lanes_per_s=n_stream / dt)
    q = users.cpu().numpy()
    before = np.concatenate([idx.search(q[lo:lo + qb], k=k,
                                        l=cfg.l_search)[0]
                             for lo in range(0, len(q), qb)])
    drop = np.arange(0, n_items, 2)
    t0 = time.perf_counter()
    idx.delete(drop)
    idx.synchronize()
    out["delete_s"] = time.perf_counter() - t0
    out["deletes"] = len(drop)
    out["deletes_per_s"] = len(drop) / out["delete_s"]
    check(idx.n_active == n_items - len(drop),
          f"phase 9c: {idx.n_active} live after the deletes")
    answers = {}
    for part in (None, "queries"):
        idx.search(q[:qb], k=k, l=cfg.l_search, partition=part)
        idx.synchronize()
        t0 = time.perf_counter()
        got = [idx.search(q[lo:lo + qb], k=k, l=cfg.l_search, partition=part)
               for lo in range(0, len(q), qb)]
        idx.synchronize()
        dt = time.perf_counter() - t0
        key = part or "replicate"
        answers[key] = tuple(np.concatenate([g[i] for g in got])
                             for i in range(3))
        out[f"qps_{key}"] = len(q) / dt
    # the path's own launches end here: the checks below search again
    out["launches"] = ops.launch_counts()
    check(all(np.array_equal(a, b) for a, b in
              zip(answers["replicate"], answers["queries"])),
          "phase 9c: the two partitions differ")
    per_row = []
    for row in idx.rows:
        parts = [search_index(row, cfg, users[lo:lo + qb], k=k,
                              l=cfg.l_search) for lo in range(0, len(q), qb)]
        per_row.append(tuple(np.concatenate([p[i].cpu().numpy()
                                             for p in parts])
                             for i in (0, 1)))
    merged = host_merge(per_row, k)
    check(all(np.array_equal(a, b) for a, b in
              zip(merged, answers["replicate"])),
          "phase 9c: the sharded answers differ from a host merge of the "
          "per-row searches")
    ids = answers["replicate"][0]
    check(not np.isin(ids, drop).any(), "phase 9c: a deleted id came back")
    live = np.setdiff1d(np.arange(n_items), drop)
    log(f"9c path B: {n_boot} serial inserts "
        f"({out['ms_per_serial_insert']:.1f} ms each), {n_stream} streamed "
        f"({out['lanes_per_s']:.1f} lanes/s), {len(drop)} deleted in "
        f"{out['delete_s']:.1f} s; QPS {out['qps_replicate']:.0f} / "
        f"{out['qps_queries']:.0f}; partitions equal to the host merge, "
        f"no deleted id")
    del idx
    torch.cuda.empty_cache()
    return out, {"before": (before, np.arange(n_items)),
                 "after": (ids, live)}


def recall_vs_exact(ids, users, cand, live, k=10):
    """Recall@10 of path B's ids against kernel 4 over the live items
    (+inf bias on every other catalogue row)."""
    import torch

    from repro_torch.kernels import ops

    bias = torch.full((cand.shape[0],), float("inf"), device=cand.device)
    bias[torch.from_numpy(live).to(cand.device)] = 0.0
    _, exact = ops.topk_search(users, cand, k=k, metric="ip", bias=bias)
    exact = exact.cpu().numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, exact))
    return hits / (k * len(ids))


def twin_users(spec, state, seed, n_users=1024):
    """The twin's queries: the user tower over ``n_users`` user ids drawn
    from a generator seeded ``seed + 43``."""
    import torch

    from repro_torch.models import recsys as rec

    dev = state["cand_embs"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    user_ids = torch.randint(0, spec.cfg.user_vocab, (n_users,),
                             generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        return rec._mlp(state["params"]["user_tower"],
                        rec.take_rows(state["params"]["user_emb"],
                                      user_ids)).contiguous()


def recsys_path(seed, n_users=1024):
    """Phase 9: the recsys archs at full width (9a), kernels 1-3 at D = 256
    under ``ip`` (9b), and the twin of ``examples/distributed_serving.py``
    over two-tower-retrieval's item tower (9c): path A (kernel 4 over the
    whole catalogue) and path B (the sharded index), with the kernels'
    launches counted over the two paths."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    out = {"archs": {}}
    tt = RECSYS_ARCHS[0]
    t0 = time.perf_counter()
    spec = recsys_spec(tt)
    out["archs"][tt], state = recsys_arch(spec, dev, seed)
    out["archs_s"] = {tt: time.perf_counter() - t0}
    cand = state["cand_embs"]
    users = twin_users(spec, state, seed, n_users)
    del state
    torch.cuda.empty_cache()

    # the twin's two paths, with the kernels' launches counted from here to
    # the end of path B's own searches (its checks and the recall oracle
    # come after the count is read)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # path A: kernel 4 over the whole catalogue
    served = ops.topk_search(users, cand, k=10, metric="ip")
    twin, answers = path_b(cand, users, dev)
    out["launches"] = twin.pop("launches")
    for key, (ids, live) in answers.items():
        twin[f"recall_at_10_{key}"] = recall_vs_exact(ids, users, cand,
                                                      live)
    twin["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    twin["s"] = time.perf_counter() - t0
    log(f"9c: Recall@10 against kernel 4 over the live items "
        f"{twin['recall_at_10_before']:.4f} before the deletes, "
        f"{twin['recall_at_10_after']:.4f} after; launches "
        f"{out['launches']}")
    for name in F32_PATH:
        check(out["launches"][name] > 0,
              f"kernel {name} never launched on the recsys path")
    t0 = time.perf_counter()
    out["path_a"] = path_a_parity(users, cand, served)
    out["path_b"] = twin
    log(f"9c path A: kernel 4 (ip, D = {cand.shape[1]}, "
        f"{cand.shape[0]} rows, B = {n_users}) {out['path_a']['ms']:.3f} ms, "
        f"device {out['path_a']['device_ms']:.3f} ms, bound "
        f"{out['path_a']['bound_ms']:.3f} ms; equal to the plain version")
    n_cat = cand.shape[0]
    del cand, users, served
    torch.cuda.empty_cache()
    out["kernels"] = recsys_kernels_ip(seed, n_cat)
    out["kernels"]["gauss"]["topk_score"] = out["path_a"]
    out["parity_s"] = time.perf_counter() - t0
    for name in RECSYS_ARCHS[1:]:
        t0 = time.perf_counter()
        out["archs"][name], state = recsys_arch(recsys_spec(name), dev,
                                                seed)
        del state
        torch.cuda.empty_cache()
        out["archs_s"][name] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 10: training — the recsys train steps and the GCN family on the card
# ---------------------------------------------------------------------------

# the recsys archs' train_batch steps, in the order phase 10 runs them (each
# freed before the next); parameters, dense gradients and AdamW's two
# moments hold four copies of the tables, so dlrm-mlperf's tables are capped
# at 2^22 rows here (51.3 GB in all; 2^23 would need 94.2 GB)
TRAIN_ARCHS = ("two-tower-retrieval", "dlrm-rm2", "din", "dlrm-mlperf")
MLPERF_TRAIN_ROW_CAP = 1 << 22
GCN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# untouched embedding rows checked per table after the first step
UNTOUCHED_ROWS = 4096
# train steps timed per arch or shape after the first (warm, median)
TRAIN_REPS = 5
# steps traced per arch or shape after those, for the device split
PROFILE_STEPS = 3
# kernel name fragments of each group of a train step's device time; a
# kernel matching none is elementwise
KERNEL_GROUPS = (
    ("gemm", ("gemm", "cutlass", "sm90_", "ampere_", "cublas")),
    ("sort_index", ("sort", "radix", "index", "scatter", "gather",
                    "embedding", "unique", "cumsum", "scan")),
    ("reduce", ("reduce", "softmax", "logsumexp", "norm")))


def train_spec(name):
    """The registered full-width spec; ``dlrm-mlperf`` with each table
    capped at ``MLPERF_TRAIN_ROW_CAP`` rows."""
    from repro_torch.configs import get_arch

    spec = get_arch(name)
    if name == "dlrm-mlperf":
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, vocab_sizes=tuple(min(v, MLPERF_TRAIN_ROW_CAP)
                                        for v in spec.cfg.vocab_sizes)))
    return spec


def embedding_lookups(spec, params, inputs):
    """(table, ids it reads) for every embedding table of a recsys step."""
    import torch

    if spec.family != "recsys":
        return []
    if "tables" in params:
        return [(params["tables"][f"t{i}"], inputs["sparse"][:, i])
                for i in range(len(params["tables"]))]
    if "items" in params:
        return [(params["items"], torch.cat([inputs["hist"].reshape(-1),
                                             inputs["target"]]))]
    return [(params["user_emb"], inputs["user_ids"]),
            (params["item_emb"], inputs["item_ids"])]


def untouched_rows(lookups, gen):
    """Per table, up to ``UNTOUCHED_ROWS`` rows no id reads (drawn from
    ``gen``) and a copy of them."""
    import torch

    out = []
    for table, ids in lookups:
        free = torch.ones(table.shape[0], dtype=torch.bool,
                          device=table.device)
        free[ids.long()] = False
        rows = torch.nonzero(free).squeeze(1)
        pick = torch.randperm(rows.shape[0], generator=gen,
                              device=rows.device)[:UNTOUCHED_ROWS]
        rows = rows[pick]
        out.append((table, rows, table[rows].clone()))
    return out


def check_untouched(where, picked):
    """After the first AdamW step (m = v = 0 before it) a row with a zero
    gradient is ``p - lr * (wd * p)``, bitwise."""
    from repro_torch.training import AdamWConfig

    cfg = AdamWConfig()
    n = 0
    for table, rows, before in picked:
        want = before - (before * cfg.weight_decay) * cfg.lr
        check(bool((table[rows] == want).all()),
              f"phase 10: {where} untouched embedding rows are not "
              f"p - lr * (wd * p)")
        n += rows.shape[0]
    return n


def train_states_close(where, got, got_out, want, want_out):
    """The card's train step against the same step on the CPU, within
    ``repro_torch.training.tolerance.train_step_errors`` (the tolerance the
    CPU tests hold the port to against the reference).  Returns the largest
    error of each part."""
    from repro_torch.training.tolerance import train_step_errors

    worst, bad = train_step_errors(got, float(got_out["loss"]), want,
                                   float(want_out["loss"]))
    check(not bad, f"phase 10: {where} differs from the CPU's beyond the "
          f"train-step tolerance: {bad[:4]}")
    return worst


def reduced_on_cpu(spec, shape_name, dev, seed, steps=2):
    """The reduced spec's train step on the card against a CPU copy of the
    same state and inputs, ``steps`` steps."""
    import torch

    from repro_torch.training.optimizer import tree_map

    red = spec.reduced()
    shape = red.shapes()[shape_name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = red.init_state(shape, dev, gen)
    inputs = red.make_inputs(shape, dev, gen)
    # copies: the step updates its state in place
    cpu_state = tree_map(lambda x: x.cpu().clone(), state)
    cpu_in = tree_map(lambda x: x.cpu().clone(), inputs)
    step = red.make_step(shape)
    for i in range(steps):
        state, out = step(state, inputs)
        cpu_state, cpu_out = step(cpu_state, cpu_in)
        worst = train_states_close(f"{red.name} {shape_name} step {i}",
                                   state, out, cpu_state, cpu_out)
    return worst


def sampled_ids_real(spec, shape, inputs, dev, seed):
    """Every ``hop1`` id a CSR neighbour of its seed (or the seed) and every
    ``hop2`` id one of its ``hop1`` parent's, in the graph ``make_csr``
    draws from a generator seeded as ``make_inputs``'s was."""
    import torch

    offsets, cols = spec.make_csr(
        shape, dev, torch.Generator(device=dev).manual_seed(seed))
    n = shape.dims["n_nodes"]
    deg = (offsets[1:] - offsets[:-1]).long()
    keys = (torch.repeat_interleave(torch.arange(n, device=dev), deg) * n
            + cols.long())
    keys = torch.sort(keys).values
    del offsets, cols, deg
    n_pairs = 0
    for child, parent in ((inputs["hop1"], inputs["seeds"]),
                          (inputs["hop2"], inputs["hop1"])):
        par = parent.long().repeat_interleave(child.shape[0]
                                              // parent.shape[0])
        want = par * n + child.long()
        pos = torch.searchsorted(keys, want).clamp_(max=keys.shape[0] - 1)
        ok = (keys[pos] == want) | (child.long() == par)
        check(bool(ok.all()), f"phase 10: {int((~ok).sum())} sampled ids "
              f"are not CSR neighbours of their parents")
        n_pairs += child.shape[0]
    return n_pairs


def kernel_group(name):
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise"


def busy_ms(events):
    """The union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile_steps(step, state, inputs, steps=PROFILE_STEPS):
    """``steps`` more steps under ``torch.profiler``: the device time
    per step by kernel group (``KERNEL_GROUPS``) and of the largest
    kernels, the host wall time per step around the same steps, and the
    device's idle share (1 - busy / wall, the kernels' intervals merged).
    A trace that holds no device record (the card's at times holds only the
    host's side) gives None for the device's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, inputs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, groups = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3 / steps
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        groups[kernel_group(e.name)] = groups.get(kernel_group(e.name),
                                                  0.0) + ms
    busy = busy_ms(kernels) / steps if kernels else None
    return {"steps": steps, "wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "kernels_per_step": len(kernels) / steps,
            "groups_ms_per_step": groups or None,
            "top_kernels_ms_per_step": sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]}


def train_run(spec, shape, dev, seed):
    """One train cell at full width: the first step (cold), then
    ``TRAIN_REPS`` more on the same batch timed by CUDA events (warm,
    median); the loss finite and lower after them; peak memory."""
    import statistics

    import numpy as np
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = spec.init_state(shape, dev, gen)
    # the inputs from a generator of their own, so that the minibatch's
    # graph can be drawn again from the same seed
    inputs = spec.make_inputs(shape, dev, torch.Generator(
        device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    out = {"dims": dict(shape.dims), "setup_s": time.perf_counter() - t0,
           "state_bytes": state_bytes(state)}
    if shape.kind == "minibatch":
        out["sampled_pairs_checked"] = sampled_ids_real(spec, shape, inputs,
                                                        dev, seed + 1)
    picked = untouched_rows(embedding_lookups(spec, state["params"], inputs),
                            torch.Generator(device=dev).manual_seed(seed))
    step = spec.make_step(shape)
    t0 = time.perf_counter()
    state, res = step(state, inputs)
    losses = [float(res["loss"])]
    out["first_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["untouched_rows_checked"] = check_untouched(
        f"{spec.name} {shape.name}", picked)
    del picked
    times = []
    for _ in range(TRAIN_REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, res = step(state, inputs)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        losses.append(float(res["loss"]))
    ms = statistics.median(times)
    flops = spec.model_flops(shape)
    out.update(ms=ms, ms_all=times, losses=losses, model_flops=flops,
               tflop_per_s=flops / ms / 1e9,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    check(all(np.isfinite(losses)), f"phase 10: {spec.name} {shape.name} "
          f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"phase 10: {spec.name} {shape.name} "
          f"loss did not fall over {TRAIN_REPS} steps: {losses}")
    out["device"] = profile_steps(step, state, inputs)
    log(f"10 {spec.name} {shape.name} {shape.dims}: {ms:.3f} ms a step, "
        f"{out['tflop_per_s']:.2f} TFLOP/s, peak {out['peak_mem_bytes']} "
        f"bytes, loss {losses[0]:.5f} -> {losses[-1]:.5f}; device "
        f"{out['device']['groups_ms_per_step']} ms a step, idle share "
        f"{out['device']['idle_share']}")
    del state, inputs, res
    return out


def optimizer_on_card(dev, seed):
    """10c: ``adamw_update`` (float32 and bfloat16 moments, the clip
    binding) and ``compressed_psum`` over four per-device gradients, on the
    card against the CPU; ms of one update of 22.4 M parameters."""
    import torch

    from repro_torch.training import (AdamWConfig, adamw_init,
                                      adamw_update, compressed_psum)
    from repro_torch.training.optimizer import tree_leaves, tree_map

    gen = torch.Generator().manual_seed(seed)

    def tree():
        return {"emb": torch.randn((1 << 14, 1024), generator=gen),
                "mlp": [torch.randn((1 << 20,), generator=gen),
                        torch.randn((333, 77), generator=gen)]}

    params, grads = tree(), tree()
    out = {}
    for mdt in ("float32", "bfloat16"):
        cfg = AdamWConfig(moment_dtype=mdt)
        runs = []
        for where in ("cpu", dev):
            p = tree_map(lambda x: x.to(where).clone(), params)
            o = adamw_init(p, cfg)
            for _ in range(3):
                p, o = adamw_update(
                    tree_map(lambda x: x.to(where).clone(), grads), o, p,
                    cfg)
            runs.append(tree_leaves([p, o["m"], o["v"]]))
        worst = 0.0
        for a, b in zip(*runs):
            b = b.cpu()
            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-5
            a, b = a.float(), b.float()
            err = (a - b).abs()
            check(bool((err <= 1e-6 * float(a.abs().max())
                        + rtol * a.abs()).all()),
                  f"phase 10c: adamw_update ({mdt} moments) on the card "
                  f"differs from the CPU (max abs err {float(err.max())})")
            worst = max(worst, float(err.max()))
        p = tree_map(lambda x: x.to(dev).clone(), params)
        o = adamw_init(p, cfg)
        g = tree_map(lambda x: x.to(dev).clone(), grads)
        ms = cuda_ms(lambda _: adamw_update(g, o, p, cfg), 5)
        out[mdt] = {"max_abs_err": worst, "update_ms": ms}
        del p, o, g
    g = [torch.randn((1 << 22,), generator=gen) for _ in range(4)]
    r = [torch.randn((1 << 22,), generator=gen) * 1e-3 for _ in range(4)]
    a_tot, a_res = compressed_psum(g, r)
    gd, rd = [x.to(dev) for x in g], [x.to(dev) for x in r]
    b_tot, b_res = compressed_psum(gd, rd)
    same = torch.equal(a_tot, b_tot.cpu()) and all(
        torch.equal(x, y.cpu()) for x, y in zip(a_res, b_res))
    check(same, "phase 10c: compressed_psum on the card differs from the CPU")
    out["compressed_psum"] = {"devices": 4, "elements": 1 << 22,
                              "bitwise": True,
                              "ms": cuda_ms(lambda _: compressed_psum(gd, rd),
                                            5)}
    log(f"10c adamw_update on the card equals the CPU: {out}")
    return out


def train_path(seed):
    """Phase 10: the four recsys train steps at full width (10a), the GCN's
    four shapes at full width (10b), the optimiser on the card against the
    CPU (10c); every reduced train step against its CPU copy.  No kernel of
    ``csrc`` lies on this path: the launches are counted to show none ran."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    out = {"archs": {}, "gcn": {}, "cpu_agrees": {}}
    ops.reset_launch_counts()
    for name in TRAIN_ARCHS:
        t0 = time.perf_counter()
        spec = train_spec(name)
        out["archs"][name] = train_run(spec, spec.shapes()["train_batch"],
                                       dev, seed)
        out["archs"][name]["s"] = time.perf_counter() - t0
    gcn = get_arch("gcn-cora")
    for name in GCN_SHAPES:
        t0 = time.perf_counter()
        out["gcn"][name] = train_run(gcn, gcn.shapes()[name], dev, seed)
        out["gcn"][name]["s"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    check(not any(out["launches"].values()),
          f"phase 10: a csrc kernel launched on the train path: "
          f"{out['launches']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name in TRAIN_ARCHS:
        out["cpu_agrees"][name] = reduced_on_cpu(get_arch(name),
                                                 "train_batch", dev, seed)
    for name in GCN_SHAPES:
        out["cpu_agrees"][f"gcn-cora {name}"] = reduced_on_cpu(
            gcn, name, dev, seed)
    out["cpu_agrees_s"] = time.perf_counter() - t0
    log(f"10: every reduced train step equals its CPU copy: "
        f"{out['cpu_agrees']}")
    out["optimizer"] = optimizer_on_card(dev, seed)
    return out


# ---------------------------------------------------------------------------
# phase 11: the LM family on the card
# ---------------------------------------------------------------------------

LM_ARCHS = ("olmo-1b", "qwen2.5-32b", "qwen2-72b", "qwen3-moe-30b-a3b",
            "qwen3-moe-235b-a22b")
# the serving cells, at the published widths and S = 32,768: (layers kept,
# prefill batch, decode batch).  olmo-1b keeps its 16 layers (2.35 GB of
# bfloat16 params; the decode cache is 34.4 GB at B = 8); the other four
# hold 61-470 GB of bfloat16 params whole and keep their embeddings and
# the first layers only.  The batches are cut from 32 / 128: a prefill's
# chunked attention reads every (2,048 x 2,048) tile pair below the
# diagonal, ~4 ms each at olmo-1b's 16 heads and B = 2
LM_SERVE = {
    "olmo-1b": (16, 2, 8),
    "qwen2.5-32b": (2, 1, 8),
    "qwen2-72b": (1, 1, 8),
    "qwen3-moe-30b-a3b": (2, 1, 8),
    "qwen3-moe-235b-a22b": (1, 1, 8),
}
# the train cells at train_4k's widths (S = 4,096): (layers kept, batch);
# olmo-1b whole with remat (18.8 GB of params, gradients and moments; at
# B = 8 a step took 5.0 s and peaked at 71.8 GB), qwen3-moe-30b-a3b with 2
# of its 48 layers (22.4 GB of float32 params and moments, 29.9 GB with the
# gradient accumulator; 4 layers ran out of the card's memory and 3
# peaked at 71.7 GB of its 79.2 GiB) and its accum_steps = 8
# (microbatches of one sequence)
LM_TRAIN = {"olmo-1b": (16, 4), "qwen3-moe-30b-a3b": (2, 8)}
# warm steps timed per serving cell after the first (median): a prefill
# (~9 s for olmo-1b), a decode
LM_PREFILL_REPS, LM_DECODE_REPS = 1, 3
# the decode-vs-forward check: prefill of the first LM_CHECK_AT tokens,
# decode of the next, against forward's row LM_CHECK_AT over S = 32,768
# tokens; the reference's chunked attention needs a multiple of its 2,048
# chunk, which S - 1 is not, so the prefill stops one chunk short
LM_CHECK_AT = 30720


def lm_spec(name, layers, **dims):
    """The registered spec with ``layers`` layers and ``dims`` replaced."""
    from repro_torch.configs import get_arch

    spec = get_arch(name)
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, n_layers=layers), **dims)


def lm_timed(step, state, inputs, reps):
    """The first step (host clock around it and a sync), then ``reps``
    more timed by CUDA events.  Returns (first ms, the reps' ms, state,
    the last output)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = step(state, inputs)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, out = step(state, inputs)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return first, times, state, out


def lm_rates(spec, shape, first, times, tokens):
    import statistics

    import torch

    ms = statistics.median(times) if times else first
    flops = spec.model_flops(shape)
    return {"dims": dict(shape.dims), "first_ms": first, "ms": ms,
            "ms_all": times, "tokens_per_s": tokens / ms * 1e3,
            "model_flops": flops, "tflop_per_s": flops / ms / 1e9,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def lm_finite(where, *tensors):
    import torch

    check(all(bool(torch.isfinite(t).all()) for t in tensors),
          f"phase 11: {where}: a value is not finite")


def lm_serve_cell(name, dev, seed):
    """11a: one arch's prefill_32k and decode_32k at its published widths
    (``LM_SERVE``'s cuts): ms a step, tokens/s, TFLOP/s of
    ``model_flops``, peak memory, every logit (and cache entry) finite.
    The decode cache holds random entries and lengths near S, so each
    step reads the whole cache; returns the cell's record, and for
    olmo-1b its params for the decode-vs-forward check."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    layers, pb, db = LM_SERVE[name]
    spec = lm_spec(name, layers, prefill_batch=pb, decode_batch=db)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"layers": layers,
           "layers_published": get_arch(name).cfg.n_layers}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shape = spec.shapes()["prefill_32k"]
    state = spec.init_state(shape, dev, gen)
    inputs = spec.make_inputs(shape, dev, gen)
    out["param_bytes"] = state_bytes(state["params"])
    first, times, state, res = lm_timed(spec.make_step(shape), state,
                                        inputs, LM_PREFILL_REPS)
    lm_finite(f"{name} prefill", res["logits"], res["cache"]["k"],
              res["cache"]["v"])
    out["prefill"] = lm_rates(spec, shape, first, times, pb * shape.dims[
        "seq"])
    out["prefill"]["cache_bytes"] = state_bytes(res["cache"])
    del res, inputs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shape = spec.shapes()["decode_32k"]
    s = shape.dims["seq"]
    cache = tf.init_cache(spec.cfg, db, s, device=dev)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    cache["len"] = (s - 8 - torch.arange(db, device=dev)).to(torch.int32)
    state = {"params": state["params"], "cache": cache}
    inputs = spec.make_inputs(shape, dev, gen)
    first, times, state, res = lm_timed(spec.make_step(shape), state,
                                        inputs, LM_DECODE_REPS)
    out["decode"] = lm_rates(spec, shape, first, times, db)
    out["decode"]["cache_bytes"] = state_bytes(state["cache"])
    with torch.no_grad():
        logits, _ = tf.decode_step(state["params"], spec.cfg, state["cache"],
                                   inputs["tokens"])
    lm_finite(f"{name} decode", logits)
    check(res["next_token"].dtype == torch.int32
          and bool(((res["next_token"] >= 0)
                    & (res["next_token"] < spec.cfg.vocab)).all()),
          f"phase 11: {name} decode: next_token out of the vocabulary")
    params = state["params"]
    del state, cache, inputs, res, logits
    log(f"11a {name} ({layers} of {out['layers_published']} layers): "
        f"prefill B={pb} {out['prefill']['ms']:.1f} ms "
        f"({out['prefill']['tokens_per_s']:.0f} tokens/s, "
        f"{out['prefill']['tflop_per_s']:.1f} TFLOP/s, peak "
        f"{out['prefill']['peak_mem_bytes']}); decode B={db} "
        f"{out['decode']['ms']:.2f} ms ({out['decode']['tokens_per_s']:.1f}"
        f" tokens/s, peak {out['decode']['peak_mem_bytes']})")
    return out, (spec, params) if name == "olmo-1b" else None


def lm_decode_consistency(spec, params, dev, seed):
    """11a: olmo-1b whole at S = 32,768, B = 1: ``prefill`` of the first
    ``LM_CHECK_AT`` tokens (chunked attention), its cache copied into a
    32,768-slot cache, ``decode_step`` of the next token, against
    ``forward``'s row ``LM_CHECK_AT`` over all 32,768 tokens (chunked):
    within ``LOGITS[bfloat16]``, the tolerance the CPU tests pin at small
    size (``tests/test_torch_lm.py``)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.training.tolerance import logits_errors

    cfg, s, p = spec.cfg, spec.prefill_seq, LM_CHECK_AT
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=dev,
                         dtype=torch.int32)
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _ = tf.forward(params, cfg, toks)
        want = full[:, p].clone()
        del full
        _, cache = tf.prefill(params, cfg, toks[:, :p])
        grown = tf.init_cache(cfg, 1, s, device=dev)
        for f in ("k", "v"):
            grown[f][:, :, :p] = cache[f]
        grown["len"] = cache["len"]
        del cache
        got, _ = tf.decode_step(params, cfg, grown, toks[:, p])
        del grown
    torch.cuda.synchronize()
    worst, share, ok = logits_errors(got, want, torch.bfloat16)
    check(ok, f"phase 11: olmo-1b decode after a {p}-token prefill differs "
          f"from forward's row {p} beyond LOGITS[bfloat16]: worst "
          f"{worst} of the largest logit")
    out = {"prefill_tokens": p, "seq": s, "batch": 1,
           "max_abs_err_share": worst, "s": time.perf_counter() - t0}
    log(f"11a olmo-1b prefill({p}) + decode equals forward({s})[:, {p}]: "
        f"{out}")
    return out


def lm_train_cell(name, dev, seed):
    """11b: one arch's train_4k at its widths (``LM_TRAIN``'s cuts): the
    first step, then ``TRAIN_REPS`` more on the same batch timed by CUDA
    events; the loss finite and lower after them; ms, TFLOP/s, peak."""
    import statistics

    import numpy as np
    import torch

    layers, b = LM_TRAIN[name]
    spec = lm_spec(name, layers, train_batch=b)
    shape = spec.shapes()["train_4k"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = spec.init_state(shape, dev, gen)
    inputs = spec.make_inputs(shape, dev, gen)
    out = {"layers": layers, "dims": dict(shape.dims),
           "accum_steps": spec.accum_steps, "remat": spec.cfg.remat,
           "remat_block": spec.cfg.remat_block,
           "state_bytes": state_bytes(state)}
    first, times, state, res = lm_timed(spec.make_step(shape), state,
                                        inputs, 0)
    losses = [float(res["loss"])]
    step = spec.make_step(shape)
    for _ in range(TRAIN_REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, res = step(state, inputs)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        losses.append(float(res["loss"]))
    ms = statistics.median(times)
    flops = spec.model_flops(shape)
    out.update(first_step_ms=first, ms=ms, ms_all=times, losses=losses,
               model_flops=flops, tflop_per_s=flops / ms / 1e9,
               tokens_per_s=b * shape.dims["seq"] / ms * 1e3,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    check(all(np.isfinite(losses)), f"phase 11: {name} train loss not "
          f"finite: {losses}")
    check(losses[-1] < losses[0], f"phase 11: {name} train loss did not "
          f"fall over {TRAIN_REPS} steps: {losses}")
    del state, inputs, res
    log(f"11b {name} train ({layers} layers, B={b}, accum "
        f"{spec.accum_steps}): {ms:.1f} ms a step, "
        f"{out['tflop_per_s']:.1f} TFLOP/s, peak {out['peak_mem_bytes']}, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return out


def lm_reduced_on_cpu(dev, seed):
    """11c: every reduced arch's prefill, decode and train step on the card
    against the same step on a CPU copy: logits and caches within
    ``LOGITS[bfloat16]`` (an MoE arch's row share), ``next_token`` equal
    wherever the top-2 logit gap exceeds that tolerance, train states
    within ``step_tolerance``.  Returns the largest error of each."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.tolerance import (LOGITS, logits_errors,
                                                step_tolerance,
                                                train_step_errors)

    out = {}
    for name in LM_ARCHS:
        red = get_arch(name).reduced()
        moe = red.cfg.moe is not None
        for shape in (x for x in red.shapes().values() if not x.skip):
            where = f"{red.name} {shape.name}"
            gen = torch.Generator(device=dev).manual_seed(seed)
            state = red.init_state(shape, dev, gen)
            inputs = red.make_inputs(shape, dev, gen)
            if shape.kind == "decode":
                c = state["cache"]
                c["k"].normal_(generator=gen)
                c["v"].normal_(generator=gen)
                c["len"] = torch.randint(1, c["k"].shape[2] - 1,
                                         c["len"].shape, generator=gen,
                                         device=dev, dtype=torch.int32)
            cpu_state = tree_map(lambda x: x.cpu().clone(), state)
            cpu_in = tree_map(lambda x: x.cpu().clone(), inputs)
            if shape.kind == "decode":
                with torch.no_grad():
                    logits = [tf.decode_step(
                        tree_map(torch.clone, st["params"]), red.cfg,
                        tree_map(torch.clone, st["cache"]), x["tokens"])[0]
                        for st, x in ((state, inputs), (cpu_state, cpu_in))]
            step = red.make_step(shape)
            got_state, got = step(state, inputs)
            want_state, want = step(cpu_state, cpu_in)
            if shape.kind == "train":
                worst, bad = train_step_errors(
                    got_state, float(got["loss"]), want_state,
                    float(want["loss"]), red._opt_cfg(),
                    step_tolerance(torch.bfloat16, moe, red.moment_dtype))
                check(not bad, f"phase 11: {where} differs from the CPU's "
                      f"beyond the bfloat16 step tolerance: {bad[:4]}")
                out[where] = worst
                continue
            if shape.kind == "prefill":
                pairs = {"logits": (got["logits"], want["logits"])}
                cache, cpu_cache = got["cache"], want["cache"]
            else:
                pairs = {"logits": tuple(logits)}
                cache, cpu_cache = got_state["cache"], want_state["cache"]
                top2 = torch.topk(logits[1].float(), 2, dim=-1).values
                sure = (top2[:, 0] - top2[:, 1]) > LOGITS[torch.bfloat16][
                    0] * float(logits[1].abs().max())
                check(torch.equal(got["next_token"].cpu()[sure],
                                  want["next_token"][sure]),
                      f"phase 11: {where} next_token differs from the CPU's "
                      f"where the top-2 gap exceeds the tolerance")
            pairs.update({f: (cache[f], cpu_cache[f]) for f in ("k", "v")})
            check(torch.equal(cache["len"].cpu(), cpu_cache["len"]),
                  f"phase 11: {where} cache len differs from the CPU's")
            out[where] = {}
            for key, (a, b) in pairs.items():
                share_worst, share, ok = logits_errors(a, b, torch.bfloat16,
                                                       moe)
                check(ok, f"phase 11: {where} {key} differs from the CPU's "
                      f"beyond LOGITS[bfloat16]: worst {share_worst}, rows "
                      f"within {share}")
                out[where][key] = share_worst
    log(f"11c every reduced LM step equals its CPU copy: {out}")
    return out


def lm_launcher(dev):
    """11d: ``repro_torch.launch.train --steps 30`` on the card, plain and
    ``--supervise --fail-at 12`` (checkpoints every 10 steps in a
    ``tempfile.mkdtemp()`` directory it removes): the same final
    parameters and moments, bitwise."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as lt
    from repro_torch.training.optimizer import tree_leaves

    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        plain = lt.main(["--steps", "30", "--device", str(dev)])
        sup = lt.main(["--steps", "30", "--supervise", "--fail-at", "12",
                       "--ckpt-dir", d, "--device", str(dev)])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    a, b = tree_leaves(plain), tree_leaves(sup)
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    check(same, "phase 11: the launcher's supervised replay ends at other "
          "parameters than the plain run")
    return {"steps": 30, "fail_at": 12, "bitwise": True, "leaves": len(a),
            "s": time.perf_counter() - t0}


def lm_path(seed):
    """Phase 11: the five LM archs' serving cells at their published widths
    (11a, with the decode-vs-forward check on olmo-1b whole), two train
    cells (11b), every reduced step against its CPU copy (11c), the
    launcher's supervised replay (11d).  No kernel of ``csrc`` lies on
    this path: the launches are counted to show none ran."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    out = {"serve": {}, "train": {}, "s": {}}
    ops.reset_launch_counts()
    for name in LM_ARCHS:
        t0 = time.perf_counter()
        out["serve"][name], olmo = lm_serve_cell(name, dev, seed)
        out["s"][f"serve {name}"] = time.perf_counter() - t0
        if olmo is not None:
            out["decode_vs_forward"] = lm_decode_consistency(*olmo, dev,
                                                             seed)
        del olmo
    for name in LM_TRAIN:
        t0 = time.perf_counter()
        out["train"][name] = lm_train_cell(name, dev, seed)
        out["s"][f"train {name}"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["cpu_agrees"] = lm_reduced_on_cpu(dev, seed)
    out["s"]["cpu_agrees"] = time.perf_counter() - t0
    out["launcher"] = lm_launcher(dev)
    out["launches"] = ops.launch_counts()
    check(not any(out["launches"].values()),
          f"phase 11: a csrc kernel launched on the LM path: "
          f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the mesh, the sharding rules and the dry run
# ---------------------------------------------------------------------------

# the cells stepped under the card's 1x1 mesh: (arch, shape, layers kept,
# spec fields replaced, axis sizes the step is built for); olmo-1b's train
# cell at phase 11b's cut (16 layers, B = 4) and its decode cell at phase
# 11a's (16 layers, B = 8: a 34.4 GB cache, which the mesh step gets a
# copy of beside the plain step's, the bfloat16 params shared),
# two-tower's retrieval over 10^6 candidates with the two-phase top-k over
# ``axes.all_size`` blocks: the step built for a (2, 2) mesh's axes (4
# blocks; the card's mesh has one device, so every leaf is whole), and
# held to the one top-k too; the recsys train cells at phase 10a's full
# width (B = 65,536; dlrm-rm2's 26 GB of tables and moments twice, one
# state for each step, and one step's activations fit the card)
MESH_CELLS = (
    ("olmo-1b", "train_4k", 16, {"train_batch": 4}, None),
    ("two-tower-retrieval", "retrieval_cand", None,
     {"two_phase_topk": True}, {"dp_size": 2, "model_size": 2}),
    ("dlrm-rm2", "serve_p99", None, {}, None),
    ("two-tower-retrieval", "train_batch", None, {}, None),
    ("dlrm-rm2", "train_batch", None, {}, None),
    ("olmo-1b", "decode_32k", 16, {"decode_batch": 8}, None),
)
MESH_REPS = 2
# the full-size cells of the dry run on the fake 16x16 mesh (host-side),
# with their per-device argument bytes in the PyTorch 2.13 sweep's records
# (PERF.md section 5): these depend on the specs only, so every PyTorch
# must count the same
MESH_DRY_CELLS = {
    ("two-tower-retrieval", "retrieval_cand"): 19359748,
    ("two-tower-retrieval", "train_batch"): 46106628,
    ("olmo-1b", "decode_32k"): 2156677184,
    ("olmo-1b", "train_4k"): 55685124,
    ("dlrm-rm2", "train_batch"): 144199952,
    ("gcn-cora", "ogb_products"): 5827560,
}


def host_available_bytes():
    """MemAvailable of the host, from /proc/meminfo (None elsewhere)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def mesh_spec(name, layers, fields):
    from repro_torch.configs import get_arch

    spec = get_arch(name)
    if layers is not None:
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, n_layers=layers))
    return dataclasses.replace(spec, **fields)


def local_tree(tree):
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.optimizer import tree_map

    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)


def timed_step(step, state, inputs, reps):
    """``reps`` steps timed by CUDA events (a train step updates its state
    in place, so each runs on the last one's state): (median ms, all ms,
    state)."""
    import statistics

    import torch

    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, inputs)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), times, state


def mesh_cell(cell, mesh, dev, seed):
    """12a: one cell's step with its state and inputs placed by
    ``state_shardings`` / ``input_shardings`` on the card's 1x1 mesh,
    against the same step on plain tensors from the same seed: every
    leaf of the first step's state and outputs bitwise equal; then ms a
    step of each (CUDA events, median of ``MESH_REPS``, warm).  For the
    train cell also the state's and inputs' bytes on the card and one more
    plain step under ``FlopCounterMode``, which 12c's dry run must
    predict."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import axes_of
    from repro_torch.launch import mesh as lm
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.optimizer import tree_leaves, tree_map

    name, shape_name, layers, fields, sizes = cell
    spec = mesh_spec(name, layers, fields)
    shape = spec.shapes()[shape_name]
    axes = axes_of(mesh)
    if sizes:
        # the step built for a larger mesh's axes; the leaves are placed
        # on the card's mesh
        axes = dataclasses.replace(axes, **sizes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    state = spec.init_state(shape, dev, gen)
    inputs = spec.make_inputs(shape, dev, gen)
    train = shape.kind == "train"
    # a train step updates its state in place, a decode step its cache:
    # the mesh gets a copy of what is written
    m_state = state
    if train:
        m_state = tree_map(torch.clone, state)
    elif shape.kind == "decode":
        # phase 11a's cache: random entries and lengths near S, so each
        # step reads the whole cache
        c, s = state["cache"], shape.dims["seq"]
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        c["len"] = (s - 8 - torch.arange(c["len"].shape[0], device=dev)
                    ).to(torch.int32)
        m_state = {"params": state["params"],
                   "cache": tree_map(torch.clone, c)}
    m_state = lm.place(m_state, spec.state_shardings(shape, axes), mesh)
    m_inputs = lm.place(inputs, spec.input_shardings(shape, axes), mesh)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "dims": dict(shape.dims),
           "layers": layers, "fields": fields}
    plain_step = spec.make_step(shape)
    mesh_step = spec.make_step(shape, axes)
    p_state, p_out = plain_step(state, inputs)
    m_state, m_out = mesh_step(m_state, m_inputs)
    torch.cuda.synchronize()
    check(all(is_dtensor(x) for x in tree_leaves(m_state)),
          f"phase 12a: {name} {shape_name}: the mesh step's state is not "
          f"DTensors")
    a = tree_leaves((p_state, p_out))
    b = tree_leaves(local_tree((m_state, m_out)))
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    check(same, f"phase 12a: {name} {shape_name}: the mesh step differs "
          f"from the plain step")
    out.update(bitwise=True, leaves=len(a), all_size=axes.all_size)
    if shape.kind == "retrieval" and axes.all_size > 1:
        # the two-phase top-k against the one top-k of the step built
        # without axes: the same scores, and the same ids wherever a
        # score is not tied within its row
        _, one = spec.make_step(shape)(state, inputs)
        got = local_tree(m_out)
        s1, i1 = one["scores"], one["ids"]
        tied = torch.zeros_like(s1, dtype=torch.bool)
        eq = s1[:, 1:] == s1[:, :-1]
        tied[:, 1:] |= eq
        tied[:, :-1] |= eq
        check(torch.equal(got["scores"], s1) and torch.equal(
            got["ids"][~tied], i1[~tied]),
              f"phase 12a: {name} {shape_name}: the two-phase top-k over "
              f"{axes.all_size} blocks differs from the one top-k")
        out.update(blocks=axes.all_size, equal_to_one_topk=True,
                   tied_scores=int(tied.sum()))
        del one, got
    del p_out, m_out, a, b
    torch.cuda.reset_peak_memory_stats()
    out["plain_ms"], out["plain_ms_all"], p_state = timed_step(
        plain_step, p_state, inputs, MESH_REPS)
    out["plain_peak_bytes"] = torch.cuda.max_memory_allocated()
    if train:
        # the plain state goes before the mesh steps (two train states
        # and a step's activations do not fit together)
        out["card_bytes"] = state_bytes(p_state) + state_bytes(inputs)
        with FlopCounterMode(display=False) as fc:
            plain_step(p_state, inputs)
        state = p_state = None
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["mesh_ms"], out["mesh_ms_all"], m_state = timed_step(
        mesh_step, m_state, m_inputs, MESH_REPS)
    out["mesh_peak_bytes"] = torch.cuda.max_memory_allocated()
    if train:
        out["flop_counter_flops"] = fc.get_total_flops()
    log(f"12a {name} {shape_name} on the 1x1 mesh: bitwise equal to the "
        f"plain step ({out['leaves']} leaves); {out['mesh_ms']:.2f} ms a "
        f"step on the mesh, {out['plain_ms']:.2f} plain; peak "
        f"{out['mesh_peak_bytes']} / {out['plain_peak_bytes']} bytes")
    del state, p_state, inputs, m_state, m_inputs
    torch.cuda.empty_cache()
    return out


def mesh_supervised(mesh, dev, seed, n_steps=6, fail_at=4):
    """12b: ``Supervisor.run(shardings=...)`` over olmo-1b's reduced train
    step on the card's 1x1 mesh, a failure injected at step ``fail_at``
    and checkpoints every 2 steps (in a ``tempfile.mkdtemp()`` directory
    it removes): the state restored after the failure is DTensors on the
    specs' placements, and the run ends bitwise at the uninterrupted
    run's state."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import axes_of, get_arch
    from repro_torch.configs.base import placements
    from repro_torch.ft import Supervisor
    from repro_torch.launch import mesh as lm
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.optimizer import tree_leaves, tree_map

    spec = get_arch("olmo-1b").reduced()
    shape = spec.shapes()["train_4k"]
    axes = axes_of(mesh)
    specs = spec.state_shardings(shape, axes)
    step = spec.make_step(shape, axes)
    init = spec.init_state(shape, dev,
                           torch.Generator(device=dev).manual_seed(seed))

    def batch(i):
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        return lm.place(spec.make_inputs(shape, dev, gen),
                        spec.input_shardings(shape, axes), mesh)

    def placed():
        return lm.place(tree_map(torch.clone, init), specs, mesh)

    seen = []

    def step_fn(st, i):
        seen.append(st)
        return step(st, batch(i))[0]

    plain = placed()
    for i in range(n_steps):
        plain = step(plain, batch(i))[0]
    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        sup = Supervisor(CheckpointManager(d), checkpoint_every=2)
        final, info = sup.run(placed(), step_fn, n_steps,
                              shardings=lm.shardify(mesh, specs),
                              fail_at={fail_at: 1})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(info == {"restarts": 1, "final_step": n_steps},
          f"phase 12b: the supervisor reports {info}")
    # step_fn's calls: steps 0 .. fail_at - 1, then the restored state
    restored = seen[fail_at]
    on_placements = all(
        is_dtensor(x) and tuple(x.placements) == placements(sp, mesh)
        for x, sp in zip(tree_leaves(restored), tree_leaves(specs)))
    check(on_placements, "phase 12b: the restored state is not DTensors on "
          "the specs' placements")
    a, b = tree_leaves(local_tree(plain)), tree_leaves(local_tree(final))
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    check(same, "phase 12b: the supervised run ends at other parameters "
          "than the uninterrupted run")
    out = {"steps": n_steps, "fail_at": fail_at, "restarts": 1,
           "bitwise": True, "restored_on_placements": True,
           "leaves": len(a), "s": time.perf_counter() - t0}
    log(f"12b supervised restore onto the 1x1 mesh: {out}")
    return out


def spec_argument_bytes(spec, shape, mesh_sizes):
    """Per-device bytes of a cell's state and inputs from its specs alone:
    each leaf's ``shard_shape`` on a mesh of ``mesh_sizes``."""
    import math

    from repro_torch.configs import axes_of
    from repro_torch.configs.base import shard_shape
    from repro_torch.training.optimizer import tree_leaves

    axes = axes_of(mesh_sizes)
    total = 0
    for tree, specs in (
            (spec.abstract_state(shape), spec.state_shardings(shape, axes)),
            (spec.abstract_inputs(shape),
             spec.input_shardings(shape, axes))):
        for x, sp in zip(tree_leaves(tree), tree_leaves(specs)):
            total += math.prod(shard_shape(x.shape, sp, mesh_sizes)) * \
                x.element_size()
    return total


def mesh_dry_run(card):
    """12c, host-side: ``dryrun.run_cell`` for each cell of
    ``MESH_DRY_CELLS`` at full size on the fake 16x16 mesh (``ok``, its
    per-device argument bytes equal to the specs' shard shapes and to the
    PyTorch 2.13 sweep's record), and for 12a's olmo-1b train cell at its
    cut on a fake 1x1 mesh, whose per-device argument bytes and FLOPs must
    equal what the card counted in 12a, exactly."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell

    keep = ("status", "mesh", "n_devices", "step_s", "memory",
            "collectives", "roofline")
    out = {"full": {}}
    sizes = {"data": 16, "model": 16}
    for (name, shape_name), want in MESH_DRY_CELLS.items():
        spec = get_arch(name)
        shape = spec.shapes()[shape_name]
        full = run_cell(spec, shape, multi_pod=False)
        check(full["status"] == "ok", f"phase 12c: the dry run of {name} "
              f"{shape_name} on 16x16: {full.get('error')}")
        args = full["memory"]["argument_bytes"]
        from_specs = spec_argument_bytes(spec, shape, sizes)
        check(args == from_specs == want, f"phase 12c: {name} "
              f"{shape_name} on 16x16 counts {args} argument bytes a "
              f"device; its specs give {from_specs}, the 2.13 record "
              f"{want}")
        out["full"][f"{name} {shape_name}"] = {
            k: full[k] for k in keep}
        log(f"12c dry run: {name} {shape_name} on 16x16 ok in "
            f"{full['step_s']} s host, {args} argument bytes a device (the "
            f"2.13 record's), peak {full['memory']['peak_bytes_per_device']}"
            f", {full['roofline']['flops_per_device']} FLOPs, dominant "
            f"{full['roofline']['dominant']}")
    arch, shape_name, layers, fields, _ = MESH_CELLS[0]
    cut = mesh_spec(arch, layers, fields)
    small = run_cell(cut, cut.shapes()[shape_name], mesh_shape=(1, 1),
                     axis_names=("data", "model"))
    check(small["status"] == "ok", f"phase 12c: the dry run of {arch} "
          f"{shape_name} on 1x1: {small.get('error')}")
    args = small["memory"]["argument_bytes"]
    flops = small["roofline"]["flops_per_device"]
    check(args == card["card_bytes"], f"phase 12c: predicted argument "
          f"bytes {args}, the card's {card['card_bytes']}")
    check(flops == card["flop_counter_flops"],
          f"phase 12c: predicted {flops} FLOPs, the card's "
          f"{card['flop_counter_flops']}")
    out.update({"cut_1x1": {"cell": f"{arch} {shape_name} ({layers} "
                                    f"layers)", **{k: small[k] for k in keep}},
                "argument_bytes_equal": True, "flops_equal": True})
    log(f"12c dry run: the 1x1 cut predicts the card's {args} argument "
        f"bytes and {flops} FLOPs")
    return out


class SplitRanks:
    """12d, host-side: every ``SPLIT`` case of ``tests/torch_mesh_worker``
    stepped on a real (2, 2) mesh of four gloo ranks (``launch.mesh.spawn``
    starts them, in a thread, so that 12a-c run meanwhile; cases and
    results pass through a ``tempfile.mkdtemp()`` directory it removes);
    ``finish`` holds each gathered (state, outputs) within its tolerance
    of the same step on plain tensors
    (``torch_mesh_worker.split_against_plain``)."""

    def __init__(self, seed):
        import tempfile
        import threading

        import torch

        from repro_torch.launch import mesh as lm

        sys.path.insert(0, str(ROOT / "tests"))
        import torch_mesh_worker as worker

        self.worker, self.seed = worker, seed
        # the test helpers run one thread a process
        self.threads = torch.get_num_threads()
        self.dir = Path(tempfile.mkdtemp())
        self.t0 = time.perf_counter()
        self.errors = []
        torch.save(worker.split_cases(seed), self.dir / "cases.pt")

        def ranks():
            try:
                lm.spawn(worker.run, 4, args=(str(self.dir / "cases.pt"),
                                              str(self.dir / "got.pt")))
            except Exception as e:  # noqa: BLE001 — reported by finish
                self.errors.append(e)
            self.ranks_s = time.perf_counter() - self.t0

        self.thread = threading.Thread(target=ranks)
        self.thread.start()

    def finish(self):
        import shutil

        import torch

        worker = self.worker
        try:
            self.thread.join()
            check(not self.errors, f"phase 12d: a gloo rank failed: "
                  f"{str(self.errors[:1])[:600]}")
            got = torch.load(self.dir / "got.pt", weights_only=False)
            for case in worker.SPLIT:
                try:
                    worker.split_against_plain(got, cases=(case,),
                                               seed=self.seed)
                except AssertionError as e:
                    check(False, f"phase 12d: {case} on the (2, 2) gloo "
                          f"mesh differs from the plain step: "
                          f"{str(e)[:400]}")
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
            torch.set_num_threads(self.threads)
        out = {"cases": list(worker.SPLIT), "ranks": 4, "mesh": [2, 2],
               "within_tolerance": True, "ranks_s": self.ranks_s,
               "s": time.perf_counter() - self.t0}
        log(f"12d {len(worker.SPLIT)} split-mesh cases on four gloo ranks "
            f"within tolerance of their plain steps ({self.ranks_s:.1f} s "
            f"the ranks, {out['s']:.1f} s in all)")
        return out


def mesh_path(seed):
    """Phase 12: the cells of ``MESH_CELLS`` under a one-rank NCCL group
    and a 1x1 ("data", "model") mesh on the card, against their plain
    steps (12a); a supervised restore onto the mesh (12b); the dry run on
    the host (12c); the split-mesh cases on four gloo ranks on the host
    (12d, beside 12a-c).  No kernel of ``csrc`` lies on this path:
    the launches are counted to show none ran."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm

    dev = torch.device("cuda", 0)
    # the earlier phases' cached blocks go back before NCCL allocates
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    out = {"cells": {}, "s": {}, "card_free_bytes_at_start": free,
           "host_available_bytes_at_start": host_available_bytes()}
    log(f"phase 12: {free} of {total} card bytes free, "
        f"{out['host_available_bytes_at_start']} host bytes available")
    ops.reset_launch_counts()
    # 12d's host ranks from here on, beside 12a-c (four processes of one
    # thread each on the host's cores; no card)
    split = SplitRanks(seed + 7)
    with lm.process_group(1, device=dev):
        mesh = lm.make_mesh((1, 1), ("data", "model"), device_type="cuda")
        for cell in MESH_CELLS:
            t0 = time.perf_counter()
            key = f"{cell[0]} {cell[1]}"
            out["cells"][key] = mesh_cell(cell, mesh, dev, seed)
            out["s"][key] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["supervised"] = mesh_supervised(mesh, dev, seed)
        out["s"]["supervised"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dry_run"] = mesh_dry_run(out["cells"]["olmo-1b train_4k"])
    out["s"]["dry_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["split"] = split.finish()
    out["s"]["split_after_dry_run"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    check(not any(out["launches"].values()),
          f"phase 12: a csrc kernel launched on the mesh path: "
          f"{out['launches']}")
    return out


def compare_runs(key, runs, kernels):
    """The cuda and torch runs of one stream: every state leaf and result
    identical, and ``kernels`` launched by the cuda run."""
    import numpy as np

    a, b = runs["cuda"], runs["torch"]
    flat = differing_leaves(a["state"], b["state"], "state")
    bad = [p for p, ok in flat if not ok]
    same = all(np.array_equal(a[f], b[f]) for f in ("ext", "dist", "slots"))
    check(same and not bad, f"phase 4: {key} cuda and torch differ in {bad}")
    for name in kernels:
        check(a["launches"][name] > 0,
              f"phase 4: {key} never launched {name}")
    return {"fields_compared": len(flat), "identical": True,
            "cuda_launches": {k: v for k, v in a["launches"].items() if v}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--live", type=int, default=1024,
                    help="points linked into the f32 path's 10^6-slot table")
    ap.add_argument("--runbook-n", type=int, default=512,
                    help="points of the quantized path's sliding window "
                         "(at most half of them live)")
    ap.add_argument("--policy-n", type=int, default=512,
                    help="points of the fresh and local paths' sliding "
                         "window")
    ap.add_argument("--hnsw-n", type=int, default=192,
                    help="points of the HNSW path's sliding window")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build, ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    smoke_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products sum in float32, as the reference's (phase 11)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    record = {"seed": args.seed}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    record["device"] = {"kind": kind, "count": count, "nvidia_smi": smi}
    log(f"device: {kind} x{count}; {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    record["build_s"] = time.perf_counter() - t0
    record["build_per_source_s"] = dict(build.BUILD_SECONDS)
    log(f"build: {record['build_s']:.1f} s {build.BUILD_SECONDS}")
    log(build.ptxas_report())
    spills = build.ptxas_spills()
    record["ptxas_spill_bytes"] = spills
    for nm in NO_SPILL:
        fns = [f for f in spills if nm in f]
        check(fns and not any(spills[f] for f in fns),
              f"ptxas reports spills (or no entry) for {nm}: "
              f"{ {f: spills[f] for f in fns} }")

    t0 = time.perf_counter()
    record["kernels"] = kernel_phase(args.seed)
    log(f"kernel parity: {time.perf_counter() - t0:.1f} s")
    log(json.dumps(record["kernels"]))
    t0 = time.perf_counter()
    record["main"] = main_path(args.seed, args.live)
    record["main"]["wall_s"] = time.perf_counter() - t0
    record["vmap"] = record["main"]["vmap"]
    t0 = time.perf_counter()
    record["quant"] = quant_path(args.seed, args.runbook_n)
    record["quant"]["wall_s"] = time.perf_counter() - t0
    t4 = time.perf_counter()
    record["engines_sub_s"] = {}
    for key, fn in (("engines", engines_agree),
                    ("quant_engines", quant_engines_agree),
                    ("policy_engines", policy_engines_agree)):
        t0 = time.perf_counter()
        record[key] = fn(args.seed)
        record["engines_sub_s"][key] = time.perf_counter() - t0
        log(f"phase 4 {key}, cuda vs torch "
            f"({record['engines_sub_s'][key]:.1f} s): {record[key]}")
    record["engines_s"] = time.perf_counter() - t4
    for mode in ("fresh", "local"):
        t0 = time.perf_counter()
        record[mode] = policy_path(args.seed, mode, args.policy_n)
        record[mode]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["hnsw"] = hnsw_path(args.seed, args.hnsw_n)
    record["hnsw"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["segments"], start = segments_path(args.seed)
    record["segments"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 6: {record['segments']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    record["serving"] = serving_path(args.seed, *start)
    record["serving"]["wall_s"] = time.perf_counter() - t0
    del start
    log(f"phase 7: {record['serving']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    record["sharded"] = sharded_path(args.seed)
    record["sharded"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 8: {record['sharded']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    record["recsys"] = recsys_path(args.seed)
    record["recsys"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 9: {record['recsys']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    record["train"] = train_path(args.seed)
    record["train"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 10: {record['train']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    record["lm"] = lm_path(args.seed)
    record["lm"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 11: {record['lm']['wall_s']:.1f} s {record['lm']['s']}")
    t0 = time.perf_counter()
    record["mesh"] = mesh_path(args.seed)
    record["mesh"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 12: {record['mesh']['wall_s']:.1f} s {record['mesh']['s']}")
    record["total_s"] = time.perf_counter() - smoke_t0
    log(f"smoke: {record['total_s']:.1f} s")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    gauss, grid = record["kernels"]["gauss"], record["kernels"]["grid"]
    ip = record["recsys"]["kernels"]["gauss"]
    rows = []
    for name in TPU_SITES:
        g = gauss.get(name, {})
        # each kernel's launches on the path it was ported for: the f32
        # path (phase 3) for kernels 1-4, the quantized path (3b) for 5-6
        path = "main" if name in F32_PATH else "quant"
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_SITES[name], "tpu_def": TPU_DEFS[name],
            "launches": record[path]["launches"].get(name, 0),
            "launches_by_path": {p: record[p]["launches"].get(name, 0)
                                 for p in ("main", "vmap", "quant", "fresh",
                                           "local", "hnsw", "segments",
                                           "serving", "sharded", "recsys",
                                           "train", "lm", "mesh")},
            "max_abs_err": g.get("max_abs_err"),
            "grid_bitwise": name in grid,
            "ms": g.get("ms"), "public_ms": g.get("public_ms"),
            "device_ms": g.get("device_ms"),
            "plain_ms": g.get("plain_ms"), "bound_ms": g.get("bound_ms"),
            "bound_by": g.get("bound_by"), "library_ms": g.get("library_ms"),
            # readings of this kernel's device_ms (here, in ip_d256 or in
            # the path records) timed by spun CUDA events, not the profiler
            # (the two beam hops share one kernel name, so one count)
            "device_ms_by_events": DEVICE_MS_BY_EVENTS.count(
                DEVICE_KERNELS[name]),
            # the same kernel at the recsys path's D = 256 under ip
            "ip_d256": {key: ip[name].get(key) for key in
                        ("max_abs_err", "ms", "device_ms", "device_ms_warm",
                         "plain_ms", "bound_ms", "bound_by", "library_ms")}
            if name in ip else None,
        })
    print(json.dumps({"kernels": rows}))
    print(", ".join(smi))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
