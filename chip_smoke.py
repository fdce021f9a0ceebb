#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, any failure exits non-zero:

  1. device and build: the card's name, count and power limit; build the
     hand-written kernels (``src/repro_torch/csrc``) with nvcc;
  2. kernel parity at the main path's shapes (n_cap = 10^6, D = 128, R = 64,
     l = 128, mv = 192, H = 4): every kernel against its plain PyTorch
     version, bitwise on grid-valued data (entries k/16, where every sum is
     exact in float32) and to rtol 1e-5 on Gaussian data; CUDA-event times
     of the kernel, the plain version, a one-call PyTorch yardstick where
     one exists, and the bound from the bytes / flops the inputs need;
  3. the main path end to end: ``ANNConfig(dim=128, n_cap=1_000_000)`` on
     the card, a serial bootstrap, batched insert windows, Recall@10, in-place
     deletes with the Alg-6 sweep, reinserts, Recall@10 again, a timed
     query-only phase — with every kernel's launches counted;
  4. the same short grid-data stream at test size with backend "cuda" and
     backend "torch", which must end in identical states and results.

Prints the kernels line, the card's name and power limit, and last the
``{"ok": true, "device": ...}`` line; the full record goes to
``chiprun_out/chip_smoke.json``.  Usage: ``python3 chip_smoke.py [--seed S]
[--live N]``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
TPU_SITES = {
    "gather_distance_batched": "src/repro/kernels/gather_distance.py:144",
    "gather_distance": "src/repro/kernels/gather_distance.py:66",
    "beam_hop_fused": "src/repro/kernels/beam_hop.py:245",
    "topk_score": "src/repro/kernels/topk_score.py:86",
}
SOURCES = {
    "gather_distance_batched": "src/repro_torch/csrc/gather_distance.cu",
    "gather_distance": "src/repro_torch/csrc/gather_distance.cu",
    "beam_hop_fused": "src/repro_torch/csrc/beam_hop.cu",
    "topk_score": "src/repro_torch/csrc/topk_score.cu",
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def bound(bytes_, flops):
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_table(n, d, grid, gen):
    import torch

    if grid:
        return torch.randint(-64, 65, (n, d), generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.float32) / 16
    return torch.randn((n, d), generator=gen, device="cuda")


def kernel_phase(seed, n_cap=1_000_000, d=128, r=64, l=128, b=512, h=4,
                 q_topk=1024, k=10):
    import torch

    from repro_torch.core import bitset
    from repro_torch.kernels import beam_hop as bh
    from repro_torch.kernels import gather_distance as gd
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

        # ---- kernels 1 and 2: gather + distance ---------------------------
        for name, args, plain, kern in (
            ("gather_distance_batched", (ids, qb, vec, norms),
             gd.gather_distance_batched_plain,
             gd.gather_distance_batched_cuda),
            ("gather_distance", (ids[0], qb[0], vec, norms),
             gd.gather_distance_plain, gd.gather_distance_cuda),
            ("gather_distance[no norms]", (ids[0], qb[0], vec, None),
             gd.gather_distance_plain, gd.gather_distance_cuda),
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
            if not grid and name != "gather_distance[no norms]":
                nvalid = int((args[0] >= 0).sum())
                nq = args[1].numel() // d
                by = nvalid * (4 * d + 8) + args[0].numel() * 8 + nq * d * 4
                bms, bby = bound(by, nvalid * 2 * d)
                ms = cuda_ms(lambda _: kern(*args, metric="l2"), 50)
                pms = cuda_ms(lambda _: plain(*args, metric="l2"), 20)
                i2 = args[0].reshape(-1, r).clamp(min=0).long()
                q2 = args[1].reshape(-1, d, 1)
                lms = cuda_ms(lambda _: torch.bmm(vec[i2], q2), 20)
                res[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                 bound_ms=bms, bound_by=bby,
                                 library_call="torch.bmm(vectors[ids], q)")

        # ---- kernel 3: fused beam super-step ------------------------------
        adj = torch.randint(0, n_cap, (n_cap, r), generator=gen,
                            device="cuda", dtype=torch.int32)
        adj[torch.rand((n_cap, r), generator=gen, device="cuda") < 0.15] = -1
        nav = torch.rand((n_cap,), generator=gen, device="cuda") < 0.98
        ret = nav & (torch.rand((n_cap,), generator=gen, device="cuda") < 0.95)
        nav_w, ret_w = bitset.pack_bits(nav), bitset.pack_bits(ret)
        start = int(torch.nonzero(ret)[0])
        lanes_valid = torch.arange(b, device="cuda") % 17 != 5  # masked lanes
        starts = torch.where(lanes_valid, start, -1).to(torch.int32)
        bi = torch.full((b, l), -1, dtype=torch.int32, device="cuda")
        bi[:, 0] = starts
        bd = torch.full((b, l), float("inf"), device="cuda")
        d0 = gd.gather_distance_batched_plain(starts[:, None], qb, vec, norms)
        bd[:, 0] = d0[:, 0]
        seen = bitset.setbits_rows(
            bitset.empty_rows(b, n_cap, "cuda"),
            starts.clamp(min=0).long()[:, None], (starts >= 0)[:, None])
        carry = (bi, bd, torch.zeros_like(bi), seen,
                 torch.full((b, mv), -1, dtype=torch.int32, device="cuda"),
                 torch.full((b, mv), float("inf"), device="cuda"),
                 torch.zeros((b,), dtype=torch.int32, device="cuda"),
                 (starts >= 0).to(torch.int32),
                 torch.zeros((b,), dtype=torch.int32, device="cuda"))
        static = (adj, vec, norms, nav_w, ret_w)
        diverged = 0
        max_err = 0.0
        for step in range(8):
            p = bh.beam_hop_fused_plain(qb, *carry, *static, h=h)
            kc = tuple(t.clone() for t in carry)
            k_out = bh.beam_hop_fused_cuda(qb, *kc, *static, h=h)
            torch.cuda.synchronize()
            same_lane = torch.ones((b,), dtype=torch.bool, device="cuda")
            for j, (x, y) in enumerate(zip(k_out, p)):
                if x.dtype == torch.float32:
                    fin = torch.isfinite(y)
                    same_lane &= (torch.isfinite(x) == fin).reshape(b, -1)\
                        .all(1)
                    if fin.any():
                        e = (x[fin] - y[fin]).abs().max()
                        max_err = max(max_err, float(e))
                    ok = torch.isclose(x, y, rtol=1e-5, atol=1e-4) | ~fin
                else:
                    ok = x == y
                same_lane &= ok.reshape(b, -1).all(1)
            bad = int((~same_lane).sum())
            if grid:
                check(bad == 0 and all(torch.equal(x, y)
                                       for x, y in zip(k_out, p)),
                      f"beam_hop_fused: grid data not bitwise at step {step}")
            diverged = max(diverged, bad)
            carry = p
        check(diverged <= b // 100,
              f"beam_hop_fused: {diverged} of {b} lanes diverge")
        res["beam_hop_fused"] = {"max_abs_err": max_err,
                                 "diverged_lanes": diverged}
        if not grid:
            # time one super-step from the mid-search carry of step 4
            c0 = tuple(t.clone() for t in carry)
            pc = bh.beam_hop_fused_plain(qb, *c0, *static, h=h)
            dcomp = int((pc[7] - c0[7]).sum())
            dhop = int((pc[8] - c0[8]).sum())
            ms = cuda_ms(lambda c: bh.beam_hop_fused_cuda(qb, *c, *static,
                                                          h=h), 10,
                         setup=lambda: tuple(t.clone() for t in c0))
            pms = cuda_ms(lambda c: bh.beam_hop_fused_plain(qb, *c, *static,
                                                            h=h), 3,
                          setup=lambda: c0)
            carry_bytes = b * (l * 12 * 2 + mv * 8 + 24 + d * 4)
            by = (dcomp * (4 * d + 4) + dhop * (4 * r + 8 * r + 8)
                  + carry_bytes)
            bms, bby = bound(by, dcomp * 2 * d)
            res["beam_hop_fused"].update(ms=ms, plain_ms=pms, library_ms=None,
                                         bound_ms=bms, bound_by=bby,
                                         rows_gathered=dcomp, hops=dhop)

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
            pms = cuda_ms(lambda _: tk.topk_score_plain(qt, vec, norms, bias,
                                                        k=k), 2)
            lms = cuda_ms(lambda _: torch.topk(torch.addmm(
                norms + bias, qt, vec.T, alpha=-2.0), k, largest=False), 3)
            by = n_cap * (d * 4 + 8) + q_topk * (d * 4 + k * 8)
            bms, bby = bound(by, 2.0 * n_cap * q_topk * d)
            res["topk_score"].update(
                ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=bby, library_call="torch.topk(torch.addmm(...))")
        del vec, adj, queries
        torch.cuda.empty_cache()
        rows[data] = res
    return rows


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
    t0 = time.perf_counter()
    for lo in range(0, n_queries, qb):
        ext, _, _ = search_index(state, cfg, qt[lo:lo + qb], k=10)
    torch.cuda.synchronize()
    qs = time.perf_counter() - t0
    out["qps"] = n_queries / qs
    out["query_batch"] = qb
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = ops.launch_counts()
    log(f"inserts/s {out['insert']['per_s']:.1f}, deletes/s "
        f"{out['delete']['per_s']:.1f}, QPS {out['qps']:.1f}, peak mem "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, launches {out['launches']}")
    for name, n in out["launches"].items():
        check(n > 0, f"kernel {name} never launched on the main path")
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
    flat = []

    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            flat.append((path, torch.equal(x, y)))
        elif x is not None:
            for f, xx, yy in zip(x._fields, x, y):
                walk(xx, yy, f"{path}.{f}")

    walk(a["state"], b["state"], "state")
    walk(a["res"], b["res"], "search")
    bad = [p for p, ok in flat if not ok]
    check(torch.equal(a["ext"], b["ext"]) and not bad,
          f"phase 4: cuda and torch engines differ in {bad}")
    return {"fields_compared": len(flat), "identical": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--live", type=int, default=8192,
                    help="points linked into the 10^6-slot table")
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    t0 = time.perf_counter()
    record["kernels"] = kernel_phase(args.seed)
    log(f"kernel parity: {time.perf_counter() - t0:.1f} s")
    log(json.dumps(record["kernels"]))
    t0 = time.perf_counter()
    record["main"] = main_path(args.seed, args.live)
    record["main"]["wall_s"] = time.perf_counter() - t0
    record["engines"] = engines_agree(args.seed)
    log(f"cuda vs torch engines: {record['engines']}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    gauss, grid = record["kernels"]["gauss"], record["kernels"]["grid"]
    launches = record["main"]["launches"]
    rows = []
    for name in TPU_SITES:
        g = gauss.get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_SITES[name], "launches": launches.get(name, 0),
            "max_abs_err": g.get("max_abs_err"),
            "grid_bitwise": name in grid,
            "ms": g.get("ms"), "kernel_ms": g.get("ms"),
            "plain_ms": g.get("plain_ms"), "bound_ms": g.get("bound_ms"),
            "bound_by": g.get("bound_by"), "library_ms": g.get("library_ms"),
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
