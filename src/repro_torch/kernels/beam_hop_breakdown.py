"""Where the time of a fused beam-hop super-step goes, on the card.

Builds ``csrc/beam_hop.cu`` with ``-DBEAM_HOP_PHASES`` (``csrc/
hop_phases.cuh``: thread 0 of each block reads ``clock64`` at the phase
boundaries of every hop that does work) and splits a hop into its phases:

  * ``pop``: finding the frontier's first minimum and recording the visit;
  * ``expand``: the popped vertex's adjacency row and the freshness tests of
    its neighbours (navigable, not yet seen);
  * ``fetch_dots``: the fresh neighbours' rows and their distances;
  * ``merge``: merging the new entries into the beam.

With ``--baseline DIR`` it also builds an earlier ``beam_hop.cu`` from DIR
(for example the parent commit's ``src/repro_torch/csrc``, unpacked with
``git archive``).  A source that carries the marks is built as it is; the
kernel before the sorted-beam redesign, which has none, gets them inserted
before its phase comments, so both builds are split at the same boundaries
(this gives the "before" split of PERF.md).

Both run one H = 4 super-step at the main path's shapes (n_cap = 10^6, D =
128, R = 64, l = 128, mv = 192, B = 512; Gaussian data, a random graph with
15% empty adjacency slots, every 17th lane masked, made from ``--seed``),
f32 rows (kernel 3) and int8 codes (kernel 6), from the same mid-search
carry (eight plain super-steps from the start).  Per build and kernel it
prints the super-step's ms (CUDA events, mean of ``reps`` launches, each
from a fresh copy of the carry), the cycles of each phase summed over
blocks and hops, each phase's share of them, that share of the ms, and the
hops and rows the super-step did.  The counters cost a few clock reads per
hop, so the instrumented ms is a little above the regular build's.

The diagnostic builds are loaded only here.  Prints one JSON object with
the card's name and power limit.  Usage: ``PYTHONPATH=src python -m
repro_torch.kernels.beam_hop_breakdown [--baseline DIR] [--seed S]``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import build

PHASES = ("pop", "expand", "fetch_dots", "merge")
# (mark, the line of an unmarked source it goes before); HOP_DECL goes after
# the line that starts the hop state
_ANCHORS = (
    ("HOP_START();", "// ---- active test"),
    ("HOP_MARK(0);", "// ---- expand"),
    ("HOP_MARK(1);", "// ---- write phase"),
    ("HOP_MARK(2);", "// ---- stable merge"),
    ("HOP_END();", "cur = nxt;"),
    ("HOP_FLUSH();", "for (int i = tid; i < l; i += NT) {\n    beam_ids[lb + i]"),
)


def instrument(text: str) -> str:
    """``text`` with the phase marks of ``hop_phases.cuh``: unchanged when
    it carries them already, else inserted before its phase comments."""
    if "HOP_START()" in text:
        return text
    text = text.replace('#include "common.cuh"',
                        '#include "common.cuh"\n#include "hop_phases.cuh"', 1)
    text = text.replace("int cur = 0;", "int cur = 0;\n  HOP_DECL", 1)
    for mark, anchor in _ANCHORS:
        at = text.find(anchor)
        if at < 0:
            raise ValueError(f"no phase anchor {anchor!r} in the source")
        line = text.rfind("\n", 0, at) + 1
        indent = text[line:at]
        text = text[:line] + indent + mark + "\n" + text[line:]
    return text


def _variant(src: Path, tag: str):
    """The phase build of one ``beam_hop.cu``; (library, whether its entry
    points take the status words)."""
    text = src.read_text()
    has_status = "int* status" in text
    out = build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    marked = out / f"beam_hop_phases_{tag}.cu"
    marked.write_text(instrument(text))
    p, i = ctypes.c_void_p, ctypes.c_int
    n_status = 2 if has_status else 0
    sigs = [("beam_hop_launch", [p] * (15 + n_status) + [i] * 9 + [p]),
            ("beam_hop_q_launch", [p] * (16 + n_status) + [i] * 9 + [p])]
    lib = build.build_variant("beam_hop", ["BEAM_HOP_PHASES"],
                              source=marked, includes=(src.parent,),
                              signatures=sigs)
    lib.beam_hop_phases.argtypes = [p]
    lib.beam_hop_phases.restype = i
    return lib, has_status


def _inputs(seed, n_cap, d, r, l, b, h, warm_steps):
    """Tables, masks and a mid-search carry per kernel, as chip_smoke.py's
    kernel phase makes them on Gaussian data."""
    from ..core import bitset
    from ..core.quant import init_quant_store, quant_write_rows
    from . import beam_hop as bh
    from . import gather_distance as gd
    from . import quant_gather as qg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vec = torch.randn((n_cap, d), generator=gen, device="cuda")
    norms = (vec * vec).sum(1)
    qi = torch.randint(0, n_cap, (b,), generator=gen, device="cuda")
    qb = (vec[qi] + torch.randn((b, d), generator=gen, device="cuda") / 16
          ).contiguous()
    store = quant_write_rows(init_quant_store(n_cap, d, "cuda"),
                             torch.arange(n_cap, device="cuda"), vec)
    adj = torch.randint(0, n_cap, (n_cap, r), generator=gen, device="cuda",
                        dtype=torch.int32)
    adj[torch.rand((n_cap, r), generator=gen, device="cuda") < 0.15] = -1
    nav = torch.rand((n_cap,), generator=gen, device="cuda") < 0.98
    ret = nav & (torch.rand((n_cap,), generator=gen, device="cuda") < 0.95)
    nav_w, ret_w = bitset.pack_bits(nav), bitset.pack_bits(ret)
    start = int(torch.nonzero(ret)[0])
    starts = torch.where(torch.arange(b, device="cuda") % 17 != 5, start,
                         -1).to(torch.int32)
    mv = l + 64
    out = {}
    for name, tables, plain, d0 in (
        ("beam_hop_fused", (vec, norms), bh.beam_hop_fused_plain,
         gd.gather_distance_batched_plain(starts[:, None], qb, vec, norms)),
        ("beam_hop_fused_q", (store.codes, store.scale, store.qnorms),
         bh.beam_hop_fused_q_plain,
         qg.gather_distance_batched_q_plain(starts[:, None], qb, store.codes,
                                            store.scale, store.qnorms)),
    ):
        bi = torch.full((b, l), -1, dtype=torch.int32, device="cuda")
        bi[:, 0] = starts
        bd = torch.full((b, l), float("inf"), device="cuda")
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
        static = (adj, *tables, nav_w, ret_w)
        for _ in range(warm_steps):
            carry = plain(qb, *carry, *static, h=h)
        out[name] = (qb, tuple(t.contiguous() for t in carry), static)
    return out, (b, l, r, mv, n_cap, nav_w.shape[0], d, h)


def _split(lib, has_status, name, qb, carry, static, dims, reps):
    fn = lib.beam_hop_launch if name == "beam_hop_fused" \
        else lib.beam_hop_q_launch
    status = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sums = (ctypes.c_ulonglong * 6)()

    def launch(c):
        ptrs = [t.data_ptr() for t in (qb, *c, *static)]
        if has_status:
            ptrs += [status.data_ptr(), None]
        build.check(fn(*ptrs, *dims, 1, stream), name)

    c = tuple(t.clone() for t in carry)
    launch(c)                                    # warm-up, and the work done
    torch.cuda.synchronize()
    rows = int((c[7] - carry[7]).sum())
    hops = int((c[8] - carry[8]).sum())
    build.check(lib.beam_hop_phases(sums), "beam_hop_phases")  # zero them
    total = 0.0
    for _ in range(reps):
        c = tuple(t.clone() for t in carry)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch(c)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    build.check(lib.beam_hop_phases(sums), "beam_hop_phases")
    ms = total / reps
    cycles = [sums[k] / reps for k in range(4)]
    share = [x / sum(cycles) for x in cycles]
    return {"ms": ms, "cycles": dict(zip(PHASES, cycles)),
            "share": dict(zip(PHASES, share)),
            "phase_ms": {p: s * ms for p, s in zip(PHASES, share)},
            "hops_counted": sums[4] / reps, "blocks": sums[5] / reps,
            "hops": hops, "rows_gathered": rows}


def breakdown(seed=0, baseline=None, n_cap=1_000_000, d=128, r=64, l=128,
              b=512, h=4, warm_steps=8, reps=10):
    cases, dims = _inputs(seed, n_cap, d, r, l, b, h, warm_steps)
    builds = {"current": build.CSRC / "beam_hop.cu"}
    if baseline is not None:
        builds["baseline"] = Path(baseline) / "beam_hop.cu"
    out = {"shape": {"n_cap": n_cap, "D": d, "R": r, "l": l, "B": b,
                     "H": h, "warm_steps": warm_steps, "reps": reps},
           "builds": {}}
    for tag, src in builds.items():
        lib, has_status = _variant(src, tag)
        out["builds"][tag] = {"source": str(src), **{
            name: _split(lib, has_status, name, *case, dims, reps)
            for name, case in cases.items()}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="a directory holding an earlier beam_hop.cu (and "
                         "the headers it includes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("beam_hop_breakdown: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    out = breakdown(args.seed, args.baseline)
    out["device"] = smi
    print(json.dumps(out))


if __name__ == "__main__":
    main()
