"""Rules of the port: it imports neither JAX nor the JAX package, it imports
without JAX installed, ``auto`` resolves by the state's device, the ``cuda``
engine refuses CPU tensors (the int8 tier's kernels and the bound launchers
of the serial and the batched search too), and the quantized state has the
reference's leaves."""
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
    [ROOT / "chip_smoke.py"]


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
