"""The port's training launcher (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU.

Both launchers train the reduced spec on ``TokenStream`` batches.  With the
port's initial parameters replaced by the reference's ``init_params`` (the
packages draw from different generators), the printed losses of the two
agree to the bfloat16 loss tolerance (``BF16_STEP``, over 12 steps of
bfloat16 compute).  The port's supervised run with an injected failure
ends at the plain run's parameters and moments bitwise, as does a run with
the two flags that change nothing (``--devices``, ``--compress-grads``).
"""
import re

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)

from repro_torch import convert
from repro_torch.launch import train as ttrain
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.tolerance import BF16_STEP

LOSS = re.compile(r"^step\s+(\d+) loss ([0-9.]+)$", re.M)


def _losses(text):
    return {int(s): float(v) for s, v in LOSS.findall(text)}


def _run(argv):
    return ttrain.main(argv + ["--device", "cpu"])


def test_printed_losses_match_reference(capsys, monkeypatch):
    import jax

    from repro.configs import all_archs as j_all
    from repro.launch import train as jtrain
    from repro.models import transformer as jt

    jtrain.main(["--steps", "12", "--seed", "3"])
    want = capsys.readouterr().out
    jcfg = j_all()["olmo-1b"].reduced().cfg
    params = jax.tree.map(np.asarray,
                          jt.init_params(jax.random.PRNGKey(3), jcfg))
    monkeypatch.setattr(
        "repro_torch.models.transformer.init_params",
        lambda gen, cfg, device=None: convert.params_from_numpy(params,
                                                                device))
    _run(["--steps", "12", "--seed", "3"])
    got = capsys.readouterr().out
    w, g = _losses(want), _losses(got)
    assert sorted(w) == sorted(g) == [0, 10]
    for step in w:
        # printed to 4 decimals: half a unit of the last place beside the
        # bfloat16 step's loss tolerance
        assert abs(g[step] - w[step]) <= 5e-5 + BF16_STEP.loss_atol + \
            BF16_STEP.loss_rtol * w[step], (step, g[step], w[step])
    last = got.strip().splitlines()[-1]
    assert re.match(r"trained 12 steps of olmo-1b in [0-9.]+s \(final loss "
                    r"[0-9.]+, first [0-9.]+\)$", last), last


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_fail_at_replays_bitwise(arch, tmp_path, capsys):
    plain = _run(["--arch", arch, "--steps", "30"])
    sup = _run(["--arch", arch, "--steps", "30", "--supervise",
                "--fail-at", "12", "--fail-at", "4",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: restarts=2" in out
    assert "restarting from scratch" in out and \
        "restarting from 10" in out
    assert _same(plain, sup)
    assert int(sup["opt"]["step"]) == 30


def test_inert_flags_and_non_lm_arch():
    plain = _run(["--steps", "3"])
    flagged = _run(["--steps", "3", "--devices", "4", "--compress-grads",
                    "--reduced"])
    assert _same(plain, flagged)
    with pytest.raises(SystemExit):
        _run(["--arch", "din"])


def test_example_twin_runs(tmp_path, monkeypatch, capsys):
    import importlib.util
    from pathlib import Path

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state = mod.main(["--steps", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: restarts=1" in out and int(state["opt"]["step"]) == 6
    assert (tmp_path / "repro_torch_train_lm_ckpt").is_dir()
