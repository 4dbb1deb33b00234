"""The port's serving entry points on the CPU at tiny sizes: the ``--gnn``
and ``--arch`` launcher (``repro_torch.launch.serve``), the train-then-serve
and quantized-LM examples (``repro_torch.examples``) and the
serve_throughput arms whose checks hold at any speed (bit-identical logits,
hit rates, zero lost, finite retry hints). No JAX: these hold the port to
itself.
"""
import contextlib
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import serve_throughput  # noqa: E402
from repro_torch.examples import serve_quantized_lm, train_cluster_gcn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# the reference launcher's per-batch stats keys (repro.launch.serve)
LM_STATS_KEYS = {"prefill_s", "decode_s", "tokens_generated", "tok_per_s",
                 "decode_p50_s", "decode_p95_s", "live_slots"}


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
    (["--arch", "rwkv6-1.6b", "--gnn", "ogbn-arxiv", "--device", "cpu"],
     "exactly one"),
    (["--device", "cpu"], "--gnn"),
    (["--gnn", "ogbn-arxiv", "--feat-bits", "9"], "feat-bits"),
    (["--arch", "rwkv6-1.6b", "--smoke", "--wq-bits", "9"], "wq-bits")])
def test_gnn_launcher_rejects(argv, match, capsys):
    with pytest.raises(SystemExit):
        serve.main(argv)
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("wq_bits", [0, 4])
def test_lm_launcher_serves_every_request(wq_bits):
    result, text = _quiet(serve.main, [
        "--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--requests",
        "5", "--batch-slots", "2", "--prompt-len", "12", "--max-new", "4",
        "--wq-bits", str(wq_bits)])
    assert result["requests"] == 5 and result["device"] == "cpu"
    stats = result["stats"]
    assert [s["live_slots"] for s in stats] == [2, 2, 1]
    for s in stats:
        assert set(s) == LM_STATS_KEYS
        assert s["tokens_generated"] == 2 * 4
        assert s["prefill_s"] >= 0 and s["decode_p95_s"] >= s["decode_p50_s"]
    assert ("[serve] wq4: 1 projections" in text) == (wq_bits == 4)
    assert "[serve] served 5 requests, 24 tokens on cpu" in text


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_launcher_serves_every_arch(arch):
    result, _ = _quiet(serve.main, [
        "--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
        "--batch-slots", "2", "--prompt-len", "9", "--max-new", "3"])
    assert result["requests"] == 2
    assert [set(s) for s in result["stats"]] == [LM_STATS_KEYS]


def test_lm_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke_config(configs.get("codeqwen1.5-7b"))
    for entry in (lambda: lm.init_lm(cfg),
                  lambda: lm.init_decode_cache(cfg, 1, 8),
                  lambda: data.synthetic_batch(0, 0, batch=1, seq=4, vocab=8),
                  lambda: data.batch_for_arch(cfg, 0, 0, 1, 4),
                  lambda: convert.lm_params_from_jax({"embed": np.zeros(2)}),
                  lambda: serve.main(["--arch", "rwkv6-1.6b", "--smoke"]),
                  lambda: serve_quantized_lm.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    params, _ = lm.init_lm(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["embed"].dtype == torch.bfloat16


def test_serve_quantized_lm_example():
    result, text = _quiet(serve_quantized_lm.main, ["--device", "cpu"])
    assert text.rstrip().endswith("OK")
    assert result["n_quantized"] == 1 and 0.0 <= result["agreement"] <= 1.0
    assert result["bf16"]["tokens_generated"] == result["w4"]["tokens_generated"] == 48


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
