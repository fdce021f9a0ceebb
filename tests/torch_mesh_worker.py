"""One rank of a real four-rank mesh, and the split-mesh cases it steps:
the worker of ``tests/test_torch_mesh.py``'s split-mesh cases and of
``chip_smoke.py`` phase 12d.  JAX-free: the card's machine imports it too.

``SPLIT``: case -> (arch, shape name, spec fields, cfg fields), reduced
cells whose leaves divide a (2, 2) ("data", "model") mesh.  The LM's
attention sharding by its heads at tp 2: "kv" (2 KV heads), "q" (1 KV
head, 4 query heads), "hd" (1 KV head, 3 query heads: head_dim split).
The recsys train cells take ``scale`` 2^-10 (a batch of 64, which the
"data" axis splits); dlrm-rm2's two largest tables become 65,536 and 4,096
rows, so that the first is split over rows (a table of 65,536 rows or
more is, ``DLRMSpec._table_specs``) and its gradient meets a split index.
The GCN's whole-graph cells have leaves that do not divide (2, 2)
(``test_torch_dryrun``'s error records), so it trains on molecules.

``run(rank, world, cases_path, out_path)`` runs inside
``launch.mesh.spawn``'s group of ``world`` gloo ranks: it builds the (2, 2)
mesh, and for each case in ``cases_path`` (a ``torch.save``'d dict: case
-> (arch, shape name, spec fields, cfg fields, state, inputs)) places the
state and inputs by the spec's ``state_shardings`` / ``input_shardings``,
runs ``make_step(shape, axes_of(mesh))`` and gathers every output leaf
whole.  Rank 0 saves the gathered (state, outputs) per case to
``out_path``.
"""
import dataclasses

import numpy as np
import torch

SPLIT = {
    "olmo-1b:train_4k": ("olmo-1b", "train_4k", {}, {}),
    "olmo-1b:decode_32k": ("olmo-1b", "decode_32k", {}, {}),
    "olmo-1b:train_4k:q": ("olmo-1b", "train_4k", {}, {"n_kv_heads": 1}),
    "olmo-1b:train_4k:hd": ("olmo-1b", "train_4k", {},
                            {"n_heads": 3, "n_kv_heads": 1}),
    "dlrm-rm2:serve_p99": ("dlrm-rm2", "serve_p99", {}, {}),
    "dlrm-rm2:train_batch": (
        "dlrm-rm2", "train_batch", {"scale": 2.0 ** -10},
        {"vocab_sizes": (1000,) * 24 + (65536, 4096)}),
    "two-tower-retrieval:retrieval_cand": (
        "two-tower-retrieval", "retrieval_cand", {"two_phase_topk": True},
        {}),
    "two-tower-retrieval:train_batch": (
        "two-tower-retrieval", "train_batch", {"scale": 2.0 ** -10}, {}),
    "gcn-cora:molecule": ("gcn-cora", "molecule", {}, {}),
}
SPLIT_AXES = dict(dp=("data",), fsdp="data", model="model", dp_size=2,
                  model_size=2)
SEED = 7


def spec_of(arch, spec_kw, cfg_kw):
    from repro_torch.configs import all_archs

    t = all_archs()[arch].reduced()
    if cfg_kw:
        t = dataclasses.replace(t, cfg=dataclasses.replace(t.cfg, **cfg_kw))
    return dataclasses.replace(t, **spec_kw)


def np_case(t, shape, seed):
    """The port's seeded state and inputs as numpy trees (a decode cache
    filled with random values and lengths; bfloat16 moments kept), and the
    state's dtypes."""
    from repro_torch import convert
    from repro_torch.training.optimizer import tree_map

    gen = torch.Generator().manual_seed(seed)
    state = t.init_state(shape, "cpu", gen)
    inputs = t.make_inputs(shape, "cpu", gen)
    dtypes = tree_map(lambda x: x.dtype, state)
    state, inputs = (convert.params_to_numpy(state),
                     convert.params_to_numpy(inputs))
    if shape.kind == "decode":
        rng = np.random.default_rng(seed)
        c = state["cache"]
        for f in ("k", "v"):
            c[f] = rng.normal(size=c[f].shape).astype(np.float32)
        c["len"] = rng.integers(1, c["k"].shape[2] - 1,
                                size=c["len"].shape).astype(np.int32)
    return state, dtypes, inputs


def to_port(tree, dtypes=None):
    from repro_torch.training.optimizer import tree_map

    if dtypes is None:
        return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)
    return tree_map(lambda x, d: torch.from_numpy(np.array(x)).to(d), tree,
                    dtypes)


def split_cases(seed=SEED):
    """``run``'s cases: every ``SPLIT`` case with its seeded state and
    inputs as tensors."""
    cases = {}
    for case, (arch, shape_name, spec_kw, cfg_kw) in SPLIT.items():
        t = spec_of(arch, spec_kw, cfg_kw)
        state, dtypes, inputs = np_case(t, t.shapes()[shape_name], seed)
        cases[case] = (arch, shape_name, spec_kw, cfg_kw,
                       to_port(state, dtypes), to_port(inputs))
    return cases


def run(rank, world, cases_path, out_path):
    from repro_torch.configs import axes_of
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.optimizer import tree_map

    torch.set_num_threads(1)
    mesh = tmesh.make_mesh((2, world // 2), ("data", "model"))
    axes = axes_of(mesh)
    cases = torch.load(cases_path, weights_only=False)
    got = {}
    for case, (arch, shape_name, spec_kw, cfg_kw, state,
               inputs) in cases.items():
        t = spec_of(arch, spec_kw, cfg_kw)
        shape = t.shapes()[shape_name]
        m_state = tmesh.place(state, t.state_shardings(shape, axes), mesh)
        m_inputs = tmesh.place(inputs, t.input_shardings(shape, axes), mesh)
        out = t.make_step(shape, axes)(m_state, m_inputs)
        got[case] = tree_map(
            lambda x: x.full_tensor() if is_dtensor(x) else x, out)
    if rank == 0:
        torch.save(got, out_path)


def assert_step_close(case, t, shape, state, dtypes, inputs, got, want):
    """``got`` = the port's (state, outputs) within the tolerance of
    ``want`` = the reference's or another port step's, by the cell's kind:
    a train step by ``train_step_errors``, prefill logits and caches and
    decode caches by ``LOGITS``, a decode's next token on the rows whose
    top two logits (of the plain decode from ``state``) stand apart, and
    recsys outputs by ``RTOL`` / ``ATOL`` (ids exactly)."""
    from torch_parity import (ATOL, RTOL, assert_logits_close,
                              assert_train_step_close)

    from repro_torch.models import transformer as tt
    from repro_torch.training.tolerance import LOGITS, step_tolerance

    (pstate, pout), (jstate, jout) = got, want
    moe = getattr(getattr(t, "cfg", None), "moe", None) is not None
    if shape.kind == "train":
        tol = (step_tolerance(torch.bfloat16, moe, t.moment_dtype)
               if t.family == "lm" else None)
        assert_train_step_close(pstate, pout, jstate, jout, where=case,
                                tol=tol)
    elif shape.kind == "prefill":
        for key, g, w in (
                ("logits", pout["logits"], jout["logits"]),
                ("k", pout["cache"]["k"], jout["cache"]["k"]),
                ("v", pout["cache"]["v"], jout["cache"]["v"])):
            assert_logits_close(g, w, torch.bfloat16, moe, f"{case} {key}")
    elif shape.kind == "decode":
        fresh = to_port(state, dtypes)
        logits, _ = tt.decode_step(fresh["params"], t.cfg, fresh["cache"],
                                   to_port(inputs)["tokens"])
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > LOGITS[torch.bfloat16][0] * \
            float(logits.abs().max())
        w = torch.from_numpy(np.array(jout["next_token"]))
        assert torch.equal(pout["next_token"][sure], w[sure]), case
        for f in ("k", "v"):
            assert_logits_close(pstate["cache"][f], jstate["cache"][f],
                                torch.bfloat16, moe, f"{case} {f}")
    else:
        assert sorted(pout) == sorted(jout)
        for key in jout:
            g, w = np.asarray(pout[key]), np.asarray(jout[key])
            assert g.dtype == w.dtype and np.isfinite(g).all()
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{case} {key}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=case)


def split_against_plain(got, cases=None, seed=SEED):
    """Each ``SPLIT`` case of ``cases`` (default: all) gathered in ``got``
    against the same step on plain tensors from the same seeded case: the
    leaves' dtypes and shapes equal, the values within
    ``assert_step_close``'s tolerance (which raises ``AssertionError``)."""
    from repro_torch.configs.base import MeshAxes
    from repro_torch.training.optimizer import tree_leaves

    for case in cases or SPLIT:
        arch, shape_name, spec_kw, cfg_kw = SPLIT[case]
        t = spec_of(arch, spec_kw, cfg_kw)
        shape = t.shapes()[shape_name]
        state, dtypes, inputs = np_case(t, shape, seed)
        plain = t.make_step(shape, MeshAxes(**SPLIT_AXES))(
            to_port(state, dtypes), to_port(inputs))
        for a, b in zip(tree_leaves(got[case]), tree_leaves(plain)):
            assert a.dtype == b.dtype and a.shape == b.shape, case
        assert_step_close(case, t, shape, state, dtypes, inputs,
                          got[case], plain)


def group_probe(rank, world, out_dir):
    """Inside ``launch.mesh.spawn``'s group: the group's size and this
    rank, the (2, 2) mesh's shape and names and this rank's coordinates,
    an all-reduce of the ranks over the group, and whether a second group
    could be made inside it (it must raise), written to
    ``out_dir/rank<rank>.pt``."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    mesh = tmesh.make_mesh((2, world // 2), ("data", "model"))
    total = torch.tensor([float(rank)])
    dist.all_reduce(total)
    try:
        with tmesh.process_group(1, device="cpu"):
            nested = True
    except RuntimeError:
        nested = False
    torch.save({"world": dist.get_world_size(), "rank": dist.get_rank(),
                "mesh_shape": tuple(mesh.shape),
                "names": tuple(mesh.mesh_dim_names),
                "coords": tuple(mesh.get_coordinate()),
                "sum": float(total), "nested": nested},
               os.path.join(out_dir, f"rank{rank}.pt"))


def fail_on_rank_one(rank, world):
    """Inside ``launch.mesh.spawn``'s group: rank 1 raises, the others
    wait at a barrier that rank 1 never reaches."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("planted failure on rank 1")
    dist.barrier()
