"""The port's serving entry points on the CPU at tiny sizes: the ``--gnn``
launcher (``repro_torch.launch.serve``), the train-then-serve example
(``repro_torch.examples.train_cluster_gcn``) and the serve_throughput arms
whose checks hold at any speed (bit-identical logits, hit rates, zero
lost, finite retry hints). No JAX: these hold the port to itself.
"""
import contextlib
import io
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import serve_throughput  # noqa: E402
from repro_torch.examples import train_cluster_gcn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return fn(*a, **kw), out.getvalue()


def test_gnn_launcher_serves_every_request():
    summary, text = _quiet(serve.main, [
        "--gnn", "ogbn-arxiv", "--device", "cpu", "--scale", "0.004",
        "--parts", "4", "--rounds", "2", "--replicas", "2",
        "--inject-failure", "kill@1"])
    assert summary["requests"] == summary["requests_admitted"] == 8
    assert summary["requests_shed"] == 0 and summary["replica_faults"] == 1
    assert summary["replicas_live"] == 1 and summary["device"] == "cpu"
    assert 0 < summary["n_compiles"] <= 3
    assert summary["chaos_fired"][0]["kind"] == "kill"
    assert "[serve-gnn] round 1:" in text and "mesh plan" in text


@pytest.mark.parametrize("argv, match", [
    (["--arch", "rwkv6-1.6b", "--device", "cpu"], "not ported"),
    (["--device", "cpu"], "--gnn"),
    (["--gnn", "ogbn-arxiv", "--feat-bits", "9"], "feat-bits")])
def test_gnn_launcher_rejects(argv, match, capsys):
    with pytest.raises(SystemExit):
        serve.main(argv)
    assert match in capsys.readouterr().err


def test_train_then_serve_example():
    result, text = _quiet(train_cluster_gcn.main, [
        "--device", "cpu", "--steps", "3", "--scale", "0.005", "--parts", "8"])
    assert text.rstrip().endswith("OK")
    assert [r["step"] for r in result["history"]][-1] == 2
    assert all(math.isfinite(r["loss"]) for r in result["history"])
    assert 0.0 <= result["int_acc"] <= 1.0
    assert result["serve"]["batches"] == 2 and result["serve"]["requests"] == 2


@pytest.mark.parametrize("arm", ["sgt_arm", "shuffled_arm", "failover_arm"])
def test_serve_throughput_arm_checks_hold(arm):
    records, _ = _quiet(serve_throughput.ARMS[arm], device="cpu",
                        **serve_throughput.SMOKE_KW[arm])
    assert records and all(r["bits"] == 8 for r in records)
    if arm == "failover_arm":
        fo = next(r for r in records if r["arm"] == "failover")
        assert fo["lost"] == 0 and fo["logits_match"]
        shed = next(r for r in records if r["arm"] == "shed")
        assert math.isfinite(shed["retry_after_s"]) and shed["retry_after_s"] > 0
    if arm == "shuffled_arm":
        assert records[0]["cache_hit_rate"] >= 0.9
