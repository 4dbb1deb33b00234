"""Port parity for ``repro_torch.tune.table`` and ``repro_torch.dist.elastic``
against the reference's ``repro.tune.table`` and ``repro.dist.elastic``.

The tuning table: the same JSON round trip, the same nearest-bucket
answers on a table of policies both packages accept, the active-table
precedence, and the port's own defaults: no packaged table (only a sweep
on an H100 may write one), and the reference's CPU table, whose 16 x 128
tiles the port's ExecutionPolicy rejects, loading as None with one
warning. Elastic: ``replan_mesh`` and ``StragglerWatchdog`` equal on a
grid of inputs, errors included.
"""
import dataclasses
import json
import pathlib
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api.policy import ExecutionPolicy as JPolicy  # noqa: E402
from repro.dist import elastic as jelastic  # noqa: E402
from repro.tune import table as jtable  # noqa: E402
from repro_torch.api.policy import ExecutionPolicy  # noqa: E402
from repro_torch.dist import StragglerWatchdog, replan_mesh  # noqa: E402
from repro_torch.tune import table  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# policies both packages accept: the reference's tiles are multiples of
# (8, 128), the port's at most 1024 threads, so (8, 128) with any word
# tile, jump, mode and reuse
_BASE = dict(block_m=8, block_n=128)
POLICIES = tuple(dict(_BASE, **kw) for kw in (
    dict(), dict(jump="compact"), dict(jump="sgt", block_w=8),
    dict(block_w=1, jump="mask"), dict(block_w=9, mode="mxu"),
    dict(jump="compact", reuse=False, fused_requantize=True)))
CELLS = [("bitserial_mm", 2, 0.0, (8, 64, 8)),
         ("bitserial_mm", 8, 0.9, (256, 4096, 16)),
         ("bgemm", 1, 0.5, (64, 2048, 64)),
         ("serve_forward", 8, 0.8, (1024, 1024, 128)),
         ("serve_forward", 4, 0.0, (256, 256, 128)),
         ("bitserial_gemm", 3, 0.95, (2304, 2304, 16))]
QUERIES = [dict(bits=b, sparsity=sp, shape=sh)
           for b in (None, 1, 3, 8, 16) for sp in (None, 0.0, 0.7, 0.99)
           for sh in (None, (8, 64, 8), (1024, 1024, 128), (40, 999, 7))]


def _doc():
    """One table document, the same JSON for both packages."""
    return {"schema_version": 1, "meta": {"note": "grid"}, "entries": [
        {"op": op, "bits": bits, "sparsity_band": band,
         "shape_bucket": list(shape),
         "policy": dataclasses.asdict(ExecutionPolicy(**POLICIES[i % len(
             POLICIES)])),
         "backend": "cuda", "median_ms": 1.0 + i, "baseline_ms": None}
        for i, (op, bits, band, shape) in enumerate(CELLS)]}


def test_table_round_trip_and_lookup_match_reference(tmp_path):
    t = table.TuningTable.from_dict(_doc())
    j = jtable.TuningTable.from_dict(_doc())
    assert t.to_dict() == j.to_dict()
    t2 = table.TuningTable.load(t.save(tmp_path / "t.json"))
    assert t2.to_dict() == t.to_dict() and t2.meta == {"note": "grid"}
    for op in ("bitserial_mm", "bitserial_gemm", "bgemm", "serve_forward",
               "unknown"):
        for q in QUERIES:
            got, want = t.lookup(op, **q), j.lookup(op, **q)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.to_dict() == want.to_dict()
                assert table.policy_to_dict(t.policy_for(op, **q)) == \
                    jtable.policy_to_dict(j.policy_for(op, **q))
    # put replaces the entry of the same cell, in both
    for tab, entry, pol in ((t, table.TableEntry, ExecutionPolicy),
                            (j, jtable.TableEntry, JPolicy)):
        tab.put(entry("bitserial_gemm", 2, 0.0, (8, 64, 8),
                      pol(jump="sgt", **_BASE)))
    assert len(t) == len(j) == len(CELLS)
    assert t.to_dict() == j.to_dict()


def test_policy_dict_round_trip_and_rejections():
    for kw in POLICIES:
        pol = ExecutionPolicy(**kw)
        d = table.policy_to_dict(pol)
        assert d == jtable.policy_to_dict(JPolicy(**kw))
        assert table.policy_from_dict(d) == pol
    with pytest.raises(ValueError, match="unknown ExecutionPolicy fields"):
        table.policy_from_dict({"block_q": 1})
    with pytest.raises(ValueError, match="at most 1024"):
        table.policy_from_dict({"block_m": 16, "block_n": 128})
    for bad, match in (({"entries": []}, "schema_version"),
                       ({"schema_version": 2, "entries": []}, "stale"),
                       ({"schema_version": 1, "entries": {}}, "list")):
        with pytest.raises(ValueError, match=match):
            table.TuningTable.from_dict(bad)


def test_reference_cpu_table_loads_as_none_with_one_warning(monkeypatch):
    """The reference's committed CPU table tiles 16 x 128 (2048 threads),
    which the port's ExecutionPolicy rejects: loading it warns once and
    gives no table, as any unusable table does; strict mode raises."""
    path = ROOT / "src" / "repro" / "tune" / "tables" / "cpu_kernels.json"
    assert any(e["policy"]["block_m"] * e["policy"]["block_n"] > 1024
               for e in json.loads(path.read_text())["entries"])
    monkeypatch.setattr(table, "_warned", set())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert table.TuningTable.load(path) is None
        assert table.TuningTable.load(path) is None
    assert len(caught) == 1 and caught[0].category is RuntimeWarning
    assert "falling back to default policies" in str(caught[0].message)
    with pytest.raises(ValueError, match="unusable"):
        table.TuningTable.load(path, strict=True)
    assert jtable.TuningTable.load(path) is not None  # the reference's own


def test_no_packaged_table_and_active_precedence(tmp_path, monkeypatch):
    """default_table() is None (nothing is packaged), so the active table
    is whatever was installed or scoped; dispatch_policy follows it."""
    assert table.DEFAULT_TABLE_PATH.name == "h100_kernels.json"
    assert not table.DEFAULT_TABLE_PATH.exists()
    monkeypatch.setattr(table, "_default_cache", table.AUTO)
    monkeypatch.setattr(table, "_installed", table.AUTO)
    assert table.default_table() is None and table.active_table() is None
    assert table.dispatch_policy("bitserial_mm", bits=2) is None
    t = table.TuningTable.from_dict(_doc())
    table.install(t)
    assert table.active_table() is t
    with table.use_table(None):
        assert table.active_table() is None
        with table.use_table(t.save(tmp_path / "t.json")):
            got = table.active_table()
            assert got is not t and got.to_dict() == t.to_dict()
    assert table.dispatch_policy("bitserial_mm", bits=2, shape=(8, 64, 8)) \
        == ExecutionPolicy(**POLICIES[0])
    table.install(None)
    assert table.active_table() is None
    table.install()
    assert table.active_table() is None
    meta = table.provenance({"run": 1})
    assert {"torch", "cuda", "backends", "run"} <= set(meta)
    assert "jax" not in meta and "cuda" in meta["backends"]


def test_server_takes_a_table_policy_per_bucket():
    """GNNServer(tuning_table=t) resolves each bucket's serve_forward
    policy from the table, and tuned_policies reports it; a path to an
    unusable table degrades to the ambient policy."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.serve import GNNServer, make_buckets

    cfg = gnn.GNNConfig.paper_gcn(128, 40)
    qp = gnn.quantize_params(gnn.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"), cfg)
    t = table.TuningTable.from_dict(_doc())
    buckets = make_buckets(node_budget=1024, edge_budget=4096, levels=3)
    srv = GNNServer(qp, cfg, buckets=buckets, tuning_table=t, devices=["cpu"])
    for b in buckets:
        srv._policy_for_n(b.n_pad)
    want = {b.n_pad: table.policy_to_dict(t.policy_for(
        "serve_forward", bits=8, shape=(b.n_pad, b.n_pad, 128)))
        for b in buckets}
    assert srv.tuned_policies() == want
    bad = ROOT / "src" / "repro" / "tune" / "tables" / "cpu_kernels.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert GNNServer(qp, cfg, tuning_table=bad,
                         devices=["cpu"])._table is None


# ------------------------------------------------------------------ elastic

@pytest.mark.parametrize("n", list(range(0, 18)) + [31, 64, 100])
@pytest.mark.parametrize("model_par", [0, 1, 2, 3, 4, 8])
def test_replan_mesh_matches_reference(n, model_par):
    try:
        want = jelastic.replan_mesh(n, model_par)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            replan_mesh(n, model_par)
        assert str(got.value) == str(e)
    else:
        assert replan_mesh(n, model_par) == want


@pytest.mark.parametrize("tolerance, window", [(1.0, 1), (2.0, 5), (1.5, 512),
                                               (3.0, 16)])
def test_straggler_watchdog_matches_reference(tolerance, window):
    """The same wall-time stream flags the same steps, keeps the same
    windows and reports the same p50/p95."""
    rng = np.random.default_rng(int(tolerance * 10) + window)
    walls = np.concatenate([rng.exponential(0.01, 200),
                            rng.exponential(0.05, 20), np.zeros(3),
                            [0.01, 0.02, 0.04, 0.08] * 5])
    wd = StragglerWatchdog(tolerance=tolerance, window=window)
    jwd = jelastic.StragglerWatchdog(tolerance=tolerance, window=window)
    for step, w in enumerate(walls):
        assert wd.observe(step, w) == jwd.observe(step, w)
    assert wd.times == jwd.times and wd.flagged == jwd.flagged
    assert (wd.p50, wd.p95) == (jwd.p50, jwd.p95)


@pytest.mark.parametrize("kw", [dict(tolerance=0.5), dict(tolerance=np.inf),
                                dict(tolerance=np.nan), dict(window=0)])
def test_straggler_watchdog_rejects_as_the_reference(kw):
    with pytest.raises(ValueError) as got:
        StragglerWatchdog(**kw)
    with pytest.raises(ValueError) as want:
        jelastic.StragglerWatchdog(**kw)
    assert str(got.value) == str(want.value)
    wd = StragglerWatchdog()
    for bad in (-1.0, np.inf, np.nan):
        with pytest.raises(ValueError, match="finite non-negative"):
            wd.observe(0, bad)
    assert not wd.observe(0, 0.0)
