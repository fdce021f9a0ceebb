"""Rules of the port: it imports neither JAX nor the JAX package, it imports
without JAX installed, ``auto`` resolves by the state's device, the ``cuda``
engine refuses CPU tensors (the int8 tier's kernels and the serial
search's bound launcher too), and the quantized state has the reference's
leaves."""
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
