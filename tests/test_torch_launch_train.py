"""The port's training launcher (``repro_torch.launch.train``) and the 100M
example on the CPU, held to the reference launcher's loop contract (its
printed records, exit code 17 at ``--simulate-failure-at``, "resumed from
step N", the checkpoint steps it leaves). The reference's own launcher
does not run in this environment (its mesh fails at the embedding
gather), so nothing here compares against it; no JAX is imported.

A run that fails and is resumed must end on the parameters and optimizer
state of an uninterrupted run, bit for bit: the data stream is a pure
function of (seed, step), and so are the GNN int path's stochastic
rounding draws.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.rules.timers import TimerSync  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.examples import train_lm_100m  # noqa: E402
from repro_torch.launch import train  # noqa: E402

LM = ["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--steps", "12",
      "--batch", "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "2"]
GNN = ["--arch", "qgtc-gcn", "--smoke", "--device", "cpu", "--int-path",
       "--scale", "0.01", "--steps", "8", "--log-every", "1",
       "--ckpt-every", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(out: str) -> list[dict]:
    return [json.loads(line[len("[train] "):]) for line in out.splitlines()
            if line.startswith("[train] {")]


def _final(d) -> list:
    """The leaves of the latest checkpoint under ``d``, in order (restored
    into a flat list with the manifest's leaf count)."""
    m = json.loads((d / f"step_{ckpt.latest_step(d):010d}" /
                    "manifest.json").read_text())
    return ckpt.restore(d, [None] * m["n_leaves"])[0]


def _fail_then_resume(argv, tmp_path, fail_at, capsys):
    """An uninterrupted run, and one that fails after ``fail_at`` and is
    run again: (records of the rerun, its output, the two final trees)."""
    full = tmp_path / "full"
    train.main(argv + ["--ckpt-dir", str(full)])
    capsys.readouterr()
    cut = tmp_path / "cut"
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--ckpt-dir", str(cut),
                           "--simulate-failure-at", str(fail_at)])
    assert exc.value.code == 17
    out = capsys.readouterr().out
    assert f"[train] SIMULATED FAILURE at step {fail_at}" in out
    train.main(argv + ["--ckpt-dir", str(cut)])
    out = capsys.readouterr().out
    return _records(out), out, _final(full), _final(cut), cut


def test_lm_failure_and_resume_reach_the_same_parameters(tmp_path, capsys):
    recs, out, full, cut, d = _fail_then_resume(LM, tmp_path, 6, capsys)
    assert "[train] resumed from step 4" in out
    assert [r["step"] for r in recs] == [4, 6, 8, 10, 11]
    assert all(set(r) == {"step", "loss", "wall_s", "straggler"}
               for r in recs)
    assert ckpt.list_steps(d) == [4, 8, 12] and ckpt.latest_step(d) == 12
    assert out.rstrip().splitlines()[-1].startswith("[train] done: p50=")
    assert len(full) == len(cut)
    for a, b in zip(full, cut):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert full[0].dtype == torch.bfloat16  # the smoke config trains in bf16


def test_gnn_int_path_stochastic_failure_and_resume(tmp_path, capsys):
    argv = GNN + ["--stochastic", "--grad-bits", "8"]
    recs, out, full, cut, d = _fail_then_resume(argv, tmp_path, 4, capsys)
    assert "[train] resumed from step 3" in out
    assert [r["step"] for r in recs] == [3, 4, 5, 6, 7]
    assert all(set(r) == {"step", "loss", "acc", "wall_s", "straggler"}
               for r in recs)
    assert ckpt.list_steps(d) == [3, 6, 8]
    assert "[train] done: test_acc=" in out
    for a, b in zip(full, cut):
        assert torch.equal(a, b)


def test_gnn_grad_compression_and_fake_path(capsys):
    res = train.main(GNN + ["--grad-compress-bits", "8"])
    fake = train.main([a for a in GNN if a != "--int-path"])
    for r in (res, fake):
        assert len(r["history"]) == 8 and r["device"] == "cpu"
        assert all(0.0 < h["loss"] < 10 for h in r["history"])
        assert 0.0 <= r["test_acc"] <= 1.0


def test_lm_grad_compression_and_microbatches(capsys):
    base = ["--arch", "codeqwen1.5-7b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1"]
    for extra in (["--grad-compress-bits", "8"], ["--n-micro", "2"]):
        res = train.main(base + extra)
        assert [h["step"] for h in res["history"]] == [0, 1, 2]
        assert res["final_loss"] > 0


def test_model_parallel_is_refused(capsys):
    """One process cannot form a mesh with a model axis of 2: the launcher
    raises before it makes a process group, as the reference's
    ``jax.make_mesh`` does (the 2-rank runs are in
    ``tests/test_torch_dist_train.py``)."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="cannot form a mesh"):
        train.main(LM + ["--model-parallel", "2"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as exc:
        train.main(LM + ["--model-parallel", "0"])
    assert exc.value.code == 2


def test_train_lm_100m_smoke_ends_in_ok(tmp_path, capsys):
    res = train_lm_100m.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert 25e6 < res["params"] < 30e6 and len(res["losses"]) == 3


def test_the_launchers_walls_are_linted():
    """bench-timer-sync covers the launcher and the example: their step
    walls feed the straggler watchdog."""
    rule = TimerSync()
    for path in ("src/repro_torch/launch/train.py",
                 "src/repro_torch/examples/train_lm_100m.py"):
        assert rule.applies_to(path)
    assert not rule.applies_to("src/repro_torch/launch/steps.py")
