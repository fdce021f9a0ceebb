"""Rules of the port: it imports neither JAX nor the JAX package, it imports
without JAX installed, ``auto`` resolves by the state's device, the ``cuda``
engine refuses CPU tensors, and the unported int8 tier refuses loudly."""
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
from repro_torch.kernels import beam_hop, gather_distance, topk_score

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
    with pytest.raises(NotImplementedError):
        init_state(ANNConfig(dim=8, n_cap=40, quantized=True), "cpu")
