"""Share of the HBM roofline the query batches' hop work reaches in the
traced stretch: the least time of the bytes the work needs
(``bench/roofline.py::query_batch_bytes``, from the batches' ``n_comps`` and
``n_hops``) at the card's published bandwidth, over the device's busy time
inside the query batches' spans."""
from bench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.span_busy_s.get("bench.query", 0.0)
    recs = [r for r in ctx.queries if r["phase"] == "traced"
            and r["comps"] is not None]
    if busy <= 0 or not recs:
        return None
    c = ctx.config
    nbytes = sum(roofline.query_batch_bytes(
        comps=r["comps"], hops=r["hops"], n_queries=r["n"], dim=c["dim"],
        r=c["r"], l=ctx.traffic["l"], metric=c["metric"],
        quantized=c["quantized"]) for r in recs)
    return roofline.roofline_pct(nbytes, busy, ctx.device_name)
