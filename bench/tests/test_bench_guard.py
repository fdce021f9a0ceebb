"""No module the benchmark imports has ``jax`` (or its kin) or ``repro``
as its top-level name; ``repro_torch`` passes."""
from __future__ import annotations

import subprocess
import sys

import pytest

from bench_tiny import ROOT

from bench import guard


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.api", "repro_torch", "repro_torch.core",
             "reproduce", "jaxtyping", "bench.harness"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.api"]


def test_check_raises_naming_what_it_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    with pytest.raises(ImportError, match="repro.fake"):
        guard.check("test")


def test_the_harness_and_the_program_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.harness, bench.control, bench.judge, bench.tracing\n"
        "import repro_torch, repro_torch.core.index, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.core.batched\n"
        "from bench import guard; guard.check('import'); print('ok')\n"
    ) % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
