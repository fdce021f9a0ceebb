"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``repro.launch.serve``), on the CPU.

The same flags give the reference's ``recall@10=`` and ``active=`` at
ticks 0 and 10 and its summary ``q=``; a run killed at tick 5 restores its
checkpoint, replays, and ends bitwise at the uninterrupted run's state;
``--shards 2`` serves a two-row ``ShardedIndex`` whose rows and answers
equal the reference's sharded engine fed the same ticks, and its crash
replay ends with equal rows; a negative ``--shards`` exits non-zero.  The
card case
(``python -m pytest --noconftest -m requires_cuda
tests/test_torch_launch_serve.py``) runs the launcher on its default
device; JAX is imported inside the CPU tests only.
"""
import re

import numpy as np
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
    """A negative ``--shards`` exits non-zero before anything is built."""
    with pytest.raises(SystemExit) as e:
        serve.main(FLAGS + ["--device", "cpu", "--shards", "-2"])
    assert e.value.code != 0
    assert "--shards -2" in capsys.readouterr().err


def test_launcher_shards(capsys, tmp_path):
    """``--shards 2`` on the CPU: the reference launcher's sharded path
    (tick lines without recall, ``shards=2`` summary, every update through
    ``ShardedEngine``), rows equal to the reference's ``ShardedEngine`` fed
    the same ticks (on a 1-device mesh with ``n_logical=2``: the layout
    changes no answer) and the same search answers; the run killed at tick
    5 restores its sharded checkpoint and ends with equal rows."""
    import jax

    from repro.configs.ann import test_scale as j_test_scale
    from repro.core import delete_batch, insert_batch
    from repro.core.distributed import ShardedIndex as JShard
    from repro.data import VectorStream
    from repro.serving import ShardedEngine as JEngine
    from torch_parity import ATOL, RTOL, assert_index_equal

    idx = serve.main(FLAGS + ["--device", "cpu", "--shards", "2"])
    out = capsys.readouterr().out
    assert re.findall(r"^tick +(\d+) served ", out, re.M) == ["0", "10"]
    assert "recall@10" not in out
    assert re.search(r"^served 12 ticks shards=2: q=96 ", out, re.M)
    assert idx.n_logical == 2 and idx.n_shards == 2
    assert all(str(r.graph.vectors.device) == "cpu" for r in idx.rows)

    rate, dim = 16, 16
    stream = VectorStream(dim=dim, rate=rate, lifetime=30)
    ref = JShard(j_test_scale(dim, rate * 34), jax.make_mesh((1,), ("shard",)),
                 n_logical=2, max_external_id=rate * 13)
    eng = JEngine(ref)
    for t in range(12):
        ins_ids, vecs, del_ids = stream.step_at(t)
        eng.apply_update(insert_batch(ins_ids, vecs))
        if len(del_ids):
            eng.apply_update(delete_batch(del_ids, dim))
    # Gaussian stream data: ids, graph and counters exactly, floats to
    # the parity tolerance
    assert_index_equal(ref.states, idx.states, exact=False,
                       where="--shards 2")
    q = stream.queries_at(11, 8)
    got, want = idx.search(q, k=10, l=32), ref.search(q, k=10, l=32)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=RTOL,
                               atol=ATOL)

    killed = serve.main(FLAGS + ["--device", "cpu", "--shards", "2",
                                 "--checkpoint-dir", str(tmp_path),
                                 "--kill-at", "5"])
    out = capsys.readouterr().out
    assert ("restored sharded checkpoint at tick 0 (2 logical shards on 2 "
            "devices)") in out
    assert "crash (injected kill at tick 5); restored tick 0" in out
    for a, b in zip(idx.rows, killed.rows):
        assert_port_equal(a, b, "sharded replay")


@pytest.mark.requires_cuda
def test_launcher_on_card(cuda_device, capsys):
    idx = serve.main(FLAGS)
    out = capsys.readouterr().out
    assert idx.device.type == "cuda" and idx.state.vectors.is_cuda
    ticks = _ticks(out)
    assert sorted(ticks) == [0, 10] and _served(out) == 96
    assert idx.n_active == ticks[10][1] + 16
