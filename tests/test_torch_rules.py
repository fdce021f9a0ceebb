"""Rules of the port: it (with its ``examples/*_torch.py`` twins and
``scripts/*_torch.py``) imports neither JAX nor the JAX package, it
imports without JAX installed, ``auto`` resolves by the state's device,
the ``cuda`` engine refuses CPU tensors (the int8 tier's kernels and the
bound launchers of the serial and the batched search too), the quantized
batched search takes its int8 distances from the launcher bound once per
search, the int8 gather's launch shape serves every id once, and the
quantized state has the reference's leaves."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tbackend
from repro_torch.core.search_batched import resolved_hop_fused
from repro_torch.core.types import ANNConfig, init_state
from repro_torch.kernels import (beam_hop, gather_distance, quant_gather,
                                 topk_score)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + \
    sorted((ROOT / "scripts").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.core, repro_torch.convert; "
            "import repro_torch.kernels.ops; "
            "import repro_torch.training, repro_torch.configs; "
            "import repro_torch.models.gnn, repro_torch.models.layers; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_auto_resolves_by_device():
    cfg = ANNConfig(dim=8, n_cap=40)
    state = init_state(cfg, "cpu")
    assert tbackend.resolve_backend(cfg, state.vectors.device).name == "torch"
    assert tbackend.get_backend("auto", torch.device("cuda")).name == "cuda"
    assert resolved_hop_fused(cfg, "cpu") == 0
    assert resolved_hop_fused(cfg, "cuda") == 4
    assert tbackend.available_backends() == ("cuda", "ref", "torch")
    with pytest.raises(ValueError):
        ANNConfig(dim=8, n_cap=40, backend="jnp")
    with pytest.raises(KeyError):
        tbackend.get_backend("pallas")


def test_cuda_engine_refuses_cpu_tensors():
    cfg = ANNConfig(dim=8, n_cap=40, r=4, backend="cuda")
    state = init_state(cfg, "cpu")
    eng = tbackend.resolve_backend(cfg, "cpu")
    ids = torch.zeros((2, 3), dtype=torch.int32)
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        eng.dists_to_ids_batched(state, cfg, q, ids)
    with pytest.raises(ValueError):
        eng.dists_to_ids(state, cfg, q[0], ids[0])
    with pytest.raises(ValueError):
        eng.brute_force_topk(state, cfg, q, k=2)
    with pytest.raises(ValueError):
        gather_distance.gather_distance_batched_cuda(ids, q, state.vectors)
    with pytest.raises(ValueError):
        topk_score.topk_score_cuda(q, state.vectors, state.norms, k=2)
    carry = (ids, q[:, :3].contiguous(), ids, torch.zeros((2, 2),
             dtype=torch.int32), ids, q[:, :3].contiguous(),
             ids[:, 0].contiguous(), ids[:, 0].contiguous(),
             ids[:, 0].contiguous())
    with pytest.raises(ValueError):
        beam_hop.beam_hop_fused_cuda(q, *carry, state.adj, state.vectors,
                                     state.norms, ids[0, :2], ids[0, :2])


def _bind_case(case):
    """Arguments of ``BoundGather`` that it must refuse, and what it raises
    (the error type and a pattern of its message)."""
    q = torch.zeros(8)
    vec = torch.zeros((40, 8))
    norms = torch.zeros(40)
    if case == "cpu_tensors":
        return (q, vec, norms), ValueError, "one CUDA device"
    if case == "mixed_devices":
        return (q, vec.to("meta"), norms), ValueError, "cpu.*meta"
    if case == "non_contiguous_table":
        return (q, torch.zeros((8, 40)).T, norms), ValueError, "contiguous"
    if case == "table_dtype":
        return (q, vec.double(), norms), TypeError, "vectors must be"
    if case == "norms_dtype":
        return (q, vec, norms.half()), TypeError, "norms must be"
    if case == "query_width":
        return (torch.zeros(9), vec, norms), ValueError, "does not match"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["cpu_tensors", "mixed_devices",
                                  "non_contiguous_table", "table_dtype",
                                  "norms_dtype", "query_width"])
def test_bound_gather_refuses_at_binding(case, monkeypatch):
    """The serial search's bound single-query launcher runs its checks when
    it is bound and raises; it never takes the plain version instead."""
    def no_plain(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(gather_distance, "gather_distance_plain", no_plain)
    monkeypatch.setattr(gather_distance, "gather_distance_batched_plain",
                        no_plain)
    args, err, pattern = _bind_case(case)
    before = dict(gather_distance.LAUNCHES)
    with pytest.raises(err, match=pattern):
        gather_distance.BoundGather(*args)
    assert gather_distance.LAUNCHES == before
    if case == "cpu_tensors":
        # the cuda engine binds the same launcher for greedy_search
        cfg = ANNConfig(dim=8, n_cap=40, r=4, backend="cuda")
        state = init_state(cfg, "cpu")
        eng = tbackend.resolve_backend(cfg, "cpu")
        with pytest.raises(ValueError, match=pattern):
            eng.bind_dists_to_ids(state, cfg, args[0])


def _hop_bind_case(case):
    """Arguments of ``BoundBeamHop`` that it must refuse, and what it raises
    (the error type and a pattern of its message)."""
    b, l, r, d, n_cap, mv = 2, 8, 4, 8, 40, 12
    w = (n_cap + 31) // 32

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    q = torch.zeros((b, d))
    carry = [i32(b, l), torch.zeros((b, l)), i32(b, l), i32(b, w),
             i32(b, mv), torch.zeros((b, mv)), i32(b), i32(b), i32(b)]
    adj, rows, norms = i32(n_cap, r), torch.zeros((n_cap, d)), \
        torch.zeros(n_cap)
    kw = {}
    err, pattern = ValueError, "inconsistent"
    if case == "cpu_tensors":
        pattern = "one CUDA device"
    elif case == "mixed_devices":
        adj, pattern = adj.to("meta"), "cpu.*meta"
    elif case == "non_contiguous_adj":
        adj, pattern = i32(r, n_cap).T, "contiguous"
    elif case == "beam_ids_dtype":
        carry[0], err, pattern = carry[0].long(), TypeError, "beam_ids must"
    elif case == "beam_dists_dtype":
        carry[1], err, pattern = carry[1].double(), TypeError, \
            "beam_dists must"
    elif case == "beam_exp_bool":
        carry[2], err, pattern = carry[2].bool(), TypeError, "beam_exp must"
    elif case == "rows_dtype":
        rows, err, pattern = rows.half(), TypeError, "rows must"
    elif case == "codes_not_int8":
        kw["scales"] = torch.zeros(n_cap)
        err, pattern = TypeError, "rows must"
    elif case == "norms_dtype":
        norms, err, pattern = norms.half(), TypeError, "norms must"
    elif case == "seen_width":
        carry[3] = i32(b, w - 1)
    elif case == "query_width":
        q = torch.zeros((b, d + 1))
    elif case == "visited_width":
        carry[5] = torch.zeros((b, mv + 1))
    elif case == "counter_shape":
        carry[7] = i32(b + 1)
    elif case == "beam_over_256":
        l = 257
        carry[:3] = [i32(b, l), torch.zeros((b, l)), i32(b, l)]
        pattern = "l <= 256"
    elif case == "degree_over_128":
        adj, pattern = i32(n_cap, 129), "r <= 128"
    elif case == "dim_over_8192":
        q, rows, pattern = torch.zeros((b, 8193)), \
            torch.zeros((n_cap, 8193)), "dim <= 8192"
    elif case == "misaligned_codes":
        rows = torch.zeros(n_cap * d + 1, dtype=torch.int8)[1:].view(n_cap, d)
        kw["scales"] = torch.zeros(n_cap)
        pattern = "4-byte aligned"
    else:
        raise AssertionError(case)
    return (q, tuple(carry), adj, rows, norms, i32(w), i32(w)), kw, err, \
        pattern


HOP_BIND_CASES = ["cpu_tensors", "mixed_devices", "non_contiguous_adj",
                  "beam_ids_dtype", "beam_dists_dtype", "beam_exp_bool",
                  "rows_dtype", "codes_not_int8", "norms_dtype",
                  "seen_width", "query_width", "visited_width",
                  "counter_shape", "beam_over_256", "degree_over_128",
                  "dim_over_8192", "misaligned_codes"]


@pytest.mark.parametrize("case", HOP_BIND_CASES)
def test_bound_beam_hop_refuses_at_binding(case, monkeypatch):
    """The batched search's bound super-step launcher runs its checks when
    it is bound and raises; it never takes the plain version instead, and
    the public launcher refuses the same arguments."""
    def no_plain(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(beam_hop, "beam_hop_fused_plain", no_plain)
    monkeypatch.setattr(beam_hop, "beam_hop_fused_q_plain", no_plain)
    args, kw, err, pattern = _hop_bind_case(case)
    before = dict(beam_hop.LAUNCHES)
    with pytest.raises(err, match=pattern):
        beam_hop.BoundBeamHop(*args, **kw)
    q, carry, adj, rows, norms, nav, ret = args
    with pytest.raises(err, match=pattern):
        if "scales" in kw:
            beam_hop.beam_hop_fused_q_cuda(q, *carry, adj, rows,
                                           kw["scales"], norms, nav, ret)
        else:
            beam_hop.beam_hop_fused_cuda(q, *carry, adj, rows, norms, nav,
                                         ret)
    assert beam_hop.LAUNCHES == before
    if case == "cpu_tensors":
        # the cuda engine binds the same launcher for batched_greedy_search
        for quantized in (False, True):
            cfg = ANNConfig(dim=8, n_cap=40, r=4, quantized=quantized,
                            backend="cuda")
            state = init_state(cfg, "cpu")
            eng = tbackend.resolve_backend(cfg, "cpu")
            with pytest.raises(ValueError, match=pattern):
                eng.bind_beam_superstep(state, cfg, q, carry, h=4,
                                        quantized=quantized)


def _q_bind_case(case):
    """Arguments of ``BoundQuantGather`` that it must refuse, and what it
    raises (the error type and a pattern of its message)."""
    q = torch.zeros((2, 8))
    codes = torch.zeros((40, 8), dtype=torch.int8)
    scales, qnorms = torch.zeros(40), torch.zeros(40)
    err, pattern = ValueError, "inconsistent shapes"
    if case == "cpu_tensors":
        pattern = "one CUDA device"
    elif case == "mixed_devices":
        scales, pattern = scales.to("meta"), "cpu.*meta"
    elif case == "non_contiguous_table":
        codes = torch.zeros((8, 40), dtype=torch.int8).T
        pattern = "contiguous"
    elif case == "codes_dtype":
        codes, err, pattern = codes.float(), TypeError, "codes must be"
    elif case == "queries_dtype":
        q, err, pattern = q.double(), TypeError, "queries must be"
    elif case == "scales_dtype":
        scales, err, pattern = scales.half(), TypeError, "scales must be"
    elif case == "qnorms_dtype":
        qnorms, err, pattern = qnorms.long(), TypeError, "qnorms must be"
    elif case == "query_width":
        q = torch.zeros((2, 9))
    elif case == "scales_length":
        scales = torch.zeros(39)
    elif case == "misaligned_codes":
        codes = torch.zeros(40 * 8 + 1, dtype=torch.int8)[1:].view(40, 8)
        pattern = "4-byte aligned"
    else:
        raise AssertionError(case)
    return (q, codes, scales, qnorms), err, pattern


@pytest.mark.parametrize("case", ["cpu_tensors", "mixed_devices",
                                  "non_contiguous_table", "codes_dtype",
                                  "queries_dtype", "scales_dtype",
                                  "qnorms_dtype", "query_width",
                                  "scales_length", "misaligned_codes"])
def test_bound_quant_gather_refuses_at_binding(case, monkeypatch):
    """The batched search's bound int8 gather launcher runs its checks when
    it is bound and raises; it never takes the plain version instead, and
    the public launcher refuses the same tables."""
    def no_plain(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(quant_gather, "gather_distance_batched_q_plain",
                        no_plain)
    args, err, pattern = _q_bind_case(case)
    before = dict(quant_gather.LAUNCHES)
    with pytest.raises(err, match=pattern):
        quant_gather.BoundQuantGather(*args)
    ids = torch.zeros((args[0].shape[0], 3), dtype=torch.int32)
    with pytest.raises(err, match=pattern):
        quant_gather.gather_distance_batched_q_cuda(ids, *args)
    assert quant_gather.LAUNCHES == before
    if case == "cpu_tensors":
        # the cuda engine binds the same launcher for batched_greedy_search
        cfg = ANNConfig(dim=8, n_cap=40, r=4, quantized=True,
                        backend="cuda")
        state = init_state(cfg, "cpu")
        eng = tbackend.resolve_backend(cfg, "cpu")
        with pytest.raises(ValueError, match=pattern):
            eng.bind_dists_to_ids_batched_q(state, cfg, args[0])


@pytest.mark.parametrize("hops", [0, 4])
def test_cuda_engine_quantized_search_binds_int8_gather(hops, monkeypatch):
    """The cuda engine's quantized batched search binds the int8 gather once
    (``bind_dists_to_ids_batched_q``) and takes from the bound launcher the
    start distance and, at H = 0, every hop's tile; the unbound
    ``dists_to_ids_batched_q`` is never called.  The kernels are stood in
    for by the torch engine's math on the CPU, and the search returns the
    torch engine's result."""
    import dataclasses

    from torch_parity import assert_search_equal, qgrid_data, small_kw

    from repro_torch.core import api as tapi
    from repro_torch.core.search_batched import batched_greedy_search
    from repro_torch.core.types import init_index_state

    torch_eng = tbackend.get_backend("torch")
    binds, calls = [], []

    def bind(self, state, cfg, queries):
        binds.append(queries.shape)

        def call(ids):
            assert ids.dtype == torch.int32 and ids.is_contiguous()
            calls.append(tuple(ids.shape))
            return torch_eng.dists_to_ids_batched_q(state, cfg, queries, ids)
        return call

    def unbound(*a, **kw):
        raise AssertionError("the unbound int8 gather was called")

    monkeypatch.setattr(tbackend.CudaBackend, "bind_dists_to_ids_batched_q",
                        bind)
    monkeypatch.setattr(tbackend.CudaBackend, "dists_to_ids_batched_q",
                        unbound)
    monkeypatch.setattr(tbackend.CudaBackend, "dists_to_ids_batched",
                        tbackend.TorchBackend.dists_to_ids_batched)
    # H = 4: the fused super-step stood in for by the torch engine's
    monkeypatch.setattr(
        tbackend.CudaBackend, "bind_beam_superstep",
        lambda self, *a, **kw: torch_eng.bind_beam_superstep(*a, **kw))

    cfg = ANNConfig(**small_kw("l2", dim=16, n_cap=200), quantized=True)
    data = qgrid_data(140, 16, 3)
    st = init_index_state(cfg, 140, device="cpu")
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20), data[:20],
                                                  device="cpu"),
                       sequential=True)
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20, 140),
                                                  data[20:], device="cpu"))
    qs = torch.from_numpy(qgrid_data(9, 16, 4))
    res_t = batched_greedy_search(
        st.graph, dataclasses.replace(cfg, hop_fused=hops), qs, k=5, l=24)
    res_c = batched_greedy_search(
        st.graph, dataclasses.replace(cfg, backend="cuda", hop_fused=hops),
        qs, k=5, l=24)
    assert_search_equal(res_t, res_c)
    assert binds == [(9, 16)]
    n_hops = int(res_c.n_hops.max())
    assert calls == [(9, 1)] + ([(9, cfg.r)] * n_hops if hops == 0 else [])
    assert n_hops > 1


def _owned(b, k, d):
    """How often the kernel's partition of a (b, k) id tile under
    ``launch_shape(b, k, d)`` serves each id: block i holds queries
    i * qpb ..., wpq warps each; warp w serves query w // wpq and its ids
    from (w % wpq) * rows in steps of wpq * rows, rows at a time
    (``csrc/quant_gather.cu``, ``quant_gather_block_kernel``)."""
    rows, wpq, qpb = quant_gather.launch_shape(b, k, d)
    count = np.zeros((b, k), np.int64)
    for blk in range(-(-b // qpb)):
        for w in range(wpq * qpb):
            qi = blk * qpb + w // wpq
            if qi >= b:
                continue
            for j0 in range((w % wpq) * rows, k, wpq * rows):
                for j in range(j0, min(j0 + rows, k)):
                    count[qi, j] += 1
    return count, (rows, wpq, qpb)


@pytest.mark.parametrize("b,d,qpb_k1", [(1, 128, 1), (9, 130, 8),
                                         (512, 128, 8), (13, 2048, 5)])
def test_quant_gather_launch_shape_covers_each_id_once(b, d, qpb_k1):
    """For every K from 1 to 130 the launch shape serves each id of the
    tile exactly once, in blocks of at most ``MAX_WARPS`` warps whose
    staged queries fit ``STAGE_BYTES``; at K = 1 a warp takes one row and
    a block packs as many queries as those allow (``qpb_k1``).  The
    constants are the kernel source's."""
    import re

    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "quant_gather.cu").read_text()
    for name, value in (("kRows", quant_gather.ROWS_PER_WARP),
                        ("kMaxWarps", quant_gather.MAX_WARPS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src)[1] == \
            str(value)
    for k in range(1, 131):
        count, (rows, wpq, qpb) = _owned(b, k, d)
        assert (count == 1).all(), (b, k, d)
        assert rows in (1, quant_gather.ROWS_PER_WARP)
        assert wpq * qpb <= quant_gather.MAX_WARPS
        assert qpb * 16 * -(-d // 4) <= quant_gather.STAGE_BYTES
    assert _owned(b, 1, d)[1] == (1, 1, qpb_k1)


@pytest.mark.parametrize("name", ["beam_superstep", "beam_superstep_q"])
def test_cuda_engine_superstep_is_bound_only(name):
    """The cuda engine's super-step is the fused kernel bound once per
    search: its unbound super-step raises and names the binding, and never
    runs the eager hop body instead."""
    cfg = ANNConfig(dim=8, n_cap=40, r=4, quantized=name.endswith("_q"),
                    backend="cuda")
    eng = tbackend.resolve_backend(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="bind_beam_superstep"):
        getattr(eng, name)(init_state(cfg, "cpu"), cfg,
                           torch.zeros((1, 8)), None, h=4, l=8,
                           max_visits=12)


def test_wrappers_take_plain_version_on_cpu_only():
    ids = torch.tensor([[0, -1]], dtype=torch.int32)
    vec = torch.ones((3, 4))
    before = dict(gather_distance.LAUNCHES)
    out = gather_distance.gather_distance_batched(ids, torch.ones((1, 4)),
                                                  vec)
    assert out[0, 0].item() == 0.0 and np.isinf(out[0, 1].item())
    assert gather_distance.LAUNCHES == before  # the plain path counts nothing
    with pytest.raises(ValueError):
        gather_distance.gather_distance_batched(ids, torch.ones((1, 4)),
                                                vec.to("meta"))


def test_quantized_tier_refuses():
    """The int8 tier's CUDA launchers refuse CPU tensors and a code table
    that is not int8; nothing falls back to the plain versions."""
    cfg = ANNConfig(dim=8, n_cap=40, r=4, quantized=True, backend="cuda")
    state = init_state(cfg, "cpu")
    quant = state.quant
    eng = tbackend.resolve_backend(cfg, "cpu")
    ids = torch.zeros((2, 3), dtype=torch.int32)
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        eng.dists_to_ids_batched_q(state, cfg, q, ids)
    with pytest.raises(ValueError):
        quant_gather.gather_distance_batched_q_cuda(
            ids, q, quant.codes, quant.scale, quant.qnorms)
    carry = (ids, q[:, :3].contiguous(), ids, torch.zeros((2, 2),
             dtype=torch.int32), ids, q[:, :3].contiguous(),
             ids[:, 0].contiguous(), ids[:, 0].contiguous(),
             ids[:, 0].contiguous())
    with pytest.raises(ValueError):
        beam_hop.beam_hop_fused_q_cuda(q, *carry, state.adj, quant.codes,
                                       quant.scale, quant.qnorms, ids[0, :2],
                                       ids[0, :2])
    before = dict(quant_gather.LAUNCHES)
    out = quant_gather.gather_distance_batched_q(ids, q, quant.codes,
                                                 quant.scale, quant.qnorms)
    assert out.shape == (2, 3) and quant_gather.LAUNCHES == before
    with pytest.raises(ValueError):
        quant_gather.gather_distance_batched_q(
            ids, q, quant.codes.to("meta"), quant.scale, quant.qnorms)


def test_quantized_init_state_has_reference_leaves():
    """The quantized ``init_state`` builds the reference's ``quant`` leaf:
    the same shapes, dtypes and initial values."""
    from repro.core.types import ANNConfig as JCfg
    from repro.core.types import init_state as j_init_state

    kw = dict(dim=20, n_cap=70, r=6, quantized=True)
    jq = j_init_state(JCfg(**kw)).quant
    tq = init_state(ANNConfig(**kw), "cpu").quant
    assert tq._fields == jq._fields
    for f in tq._fields:
        a, b = np.asarray(getattr(jq, f)), getattr(tq, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert init_state(ANNConfig(dim=20, n_cap=70), "cpu").quant is None


def test_front_doors_resolve_the_references_names():
    """Every name of ``repro.core.__all__`` resolves in ``repro_torch.core``
    (``from repro_torch.core import X``), and every parameter of each
    callable there that a caller can pass by keyword is accepted by the
    port's counterpart, but for the JAX-only knobs of ``JAX_ONLY``."""
    import inspect

    import repro.core as ref_core
    import repro_torch.core as port_core

    missing = [name for name in ref_core.__all__
               if not hasattr(port_core, name)]
    assert not missing
    refused = []
    for name in ref_core.__all__:
        ref, port = getattr(ref_core, name), getattr(port_core, name)
        if not callable(ref):
            continue
        try:
            ref_params = inspect.signature(ref).parameters.values()
        except ValueError:          # a builtin type (an exception class)
            continue
        params = inspect.signature(port).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            continue
        refused += [f"{name}({p.name}=)" for p in ref_params
                    if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                    and p.name not in params and p.name not in JAX_ONLY]
    assert not refused


# Keywords of the reference's front doors that are knobs of JAX itself, and
# what the port has in their place.
JAX_ONLY = {
    "interpret": "Pallas's interpret mode; a port kernel takes its plain "
                 "version on CPU tensors",
    "tile_k": "a Pallas block size; the CUDA kernels pick theirs",
    "tile_n": "a Pallas block size; the CUDA kernels pick theirs",
    "unroll": "a lax.scan knob; the port's loops are Python loops",
    "key": "a jax.random key; the port takes a torch.Generator",
    "mesh": "a jax.sharding.Mesh; the port takes a device list",
    "axis": "a mesh axis name; the port takes a device list",
}


def test_kernel_distance_fn_drives_greedy_search():
    """``kernels.ops.make_kernel_distance_fn`` injected into
    ``greedy_search`` gives the engine's own answer, as the reference's
    does (``tests/test_kernels.py``)."""
    from repro_torch.core import StreamingIndex, greedy_search
    from repro_torch.kernels.ops import make_kernel_distance_fn

    rng = np.random.default_rng(0)
    data = (rng.integers(-64, 65, size=(200, 16)) / 16).astype(np.float32)
    cfg = ANNConfig(dim=16, n_cap=256, r=8, l_build=16, l_search=16)
    idx = StreamingIndex(cfg, device="cpu")
    idx.insert(np.arange(120), data[:120])
    q = torch.from_numpy(data[150])
    a = greedy_search(idx.state, cfg, q, k=5, l=16)
    b = greedy_search(idx.state, cfg, q, k=5, l=16,
                      distance_fn=make_kernel_distance_fn())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
