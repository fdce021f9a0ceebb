"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``repro.launch.serve``), on the CPU.

The same flags give the reference's ``recall@10=`` and ``active=`` at
ticks 0 and 10 and its summary ``q=``; a run killed at tick 5 restores its
checkpoint, replays, and ends bitwise at the uninterrupted run's state;
``--shards`` exits non-zero naming ROADMAP slice 14.  The card case
(``python -m pytest --noconftest -m requires_cuda
tests/test_torch_launch_serve.py``) runs the launcher on its default
device; JAX is imported inside the CPU tests only.
"""
import re

import pytest

from torch_parity import assert_port_equal, cuda_device  # noqa: F401

from repro_torch.launch import serve

FLAGS = ["--ticks", "12", "--rate", "16", "--queries", "8", "--dim", "16"]


def _ticks(out: str) -> dict:
    """``{tick: (recall@10, active)}`` from the launcher's tick lines."""
    return {int(m[0]): (m[1], int(m[2])) for m in re.findall(
        r"^tick +(\d+) .* recall@10=([0-9.]+) active=(\d+)$", out, re.M)}


def _served(out: str) -> int:
    return int(re.search(r"^served 12 ticks .*?: q=(\d+) ", out, re.M)[1])


@pytest.fixture(scope="module")
def plain_run():
    """The uninterrupted CPU run: its stdout and final index."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        idx = serve.main(FLAGS + ["--device", "cpu"])
    return buf.getvalue(), idx


def test_launcher_matches_reference(plain_run, capsys):
    from repro.launch import serve as ref_serve

    out, idx = plain_run
    ref_serve.main(FLAGS)
    ref = capsys.readouterr().out
    ticks = _ticks(out)
    assert sorted(ticks) == [0, 10]
    assert ticks == _ticks(ref)
    assert _served(out) == _served(ref) == 96
    assert str(idx.device) == "cpu" and idx.n_active == ticks[10][1] + 16


def test_launcher_crash_replay_recovers(plain_run, tmp_path, capsys):
    _, plain = plain_run
    idx = serve.main(FLAGS + ["--device", "cpu", "--checkpoint-dir",
                              str(tmp_path), "--kill-at", "5"])
    out = capsys.readouterr().out
    assert "crash (injected kill at tick 5); restored tick 0" in out
    assert idx.n_active == plain.n_active
    assert_port_equal(idx.istate, plain.istate, "state")


def test_launcher_refuses_shards(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(FLAGS + ["--device", "cpu", "--shards", "2"])
    assert e.value.code != 0
    assert "slice 14" in capsys.readouterr().err


@pytest.mark.requires_cuda
def test_launcher_on_card(cuda_device, capsys):
    idx = serve.main(FLAGS)
    out = capsys.readouterr().out
    assert idx.device.type == "cuda" and idx.state.vectors.is_cuda
    ticks = _ticks(out)
    assert sorted(ticks) == [0, 10] and _served(out) == 96
    assert idx.n_active == ticks[10][1] + 16
