"""Port parity for the tuning step of dispatch and the sweep harness:
``repro_torch.api.registry.resolve``'s table step, ``repro_torch.tune
.sweep``, ``repro_torch.launch.sweep`` and ``repro_torch.benchmarks
.kernel_bench`` against the reference's ``repro.api.registry``,
``repro.tune.sweep``, ``repro.launch.sweep`` and ``benchmarks/
kernel_bench.py``.

The reference runs on its ``pallas`` engine in interpret mode, the port
on ``cuda`` with CPU tensors, which take the kernels' plain versions.
Every test pins its table (``use_table``) on both sides, so no outcome
depends on the packaged tables. The reference's sweep timer is stubbed
where only the schema is compared: its interpret-mode times say nothing
of the port.
"""
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.api.policy import ExecutionPolicy as JPolicy  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.tune import sweep as jsweep  # noqa: E402
from repro.tune.table import TableEntry as JEntry  # noqa: E402
from repro.tune.table import TuningTable as JTable  # noqa: E402
from repro_torch import api, tune  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy  # noqa: E402
from repro_torch.core import bitops, zerotile  # noqa: E402
from repro_torch.tune import sweep  # noqa: E402
from repro_torch.tune.table import TableEntry, TuningTable  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _entry(op="bitserial_mm", bits=2, band=0.0, shape=(8, 64, 8),
           jump="mask", **pol_kw):
    return TableEntry(op=op, bits=bits, sparsity_band=band,
                      shape_bucket=shape,
                      policy=ExecutionPolicy(jump=jump, **pol_kw),
                      backend="cuda", median_ms=1.0)


# ------------------------------------------------------- dispatch precedence

def test_dispatch_precedence_explicit_beats_table_beats_default():
    table = TuningTable([_entry(jump="mask", block_m=16)])
    with tune.use_table(table):
        # the table fills silence
        _, pol = api.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8))
        assert pol.jump == "mask" and pol.block_m == 16
        # an explicit per-call policy beats the table
        _, pol = api.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8),
                             policy=DEFAULT_POLICY)
        assert pol == DEFAULT_POLICY
        # a use() context policy beats the table
        with api.use(policy=ExecutionPolicy(jump="compact")):
            _, pol = api.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8))
            assert pol.jump == "compact" and pol.block_m == 8
        # tuned=False (precomputed tile artifacts in flight) skips the table
        _, pol = api.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8),
                             tuned=False)
        assert pol == DEFAULT_POLICY
        # an op the table does not hold resolves to the default
        _, pol = api.resolve("bgemm", shape=(8, 64, 8))
        assert pol is DEFAULT_POLICY
    with tune.use_table(None):  # tuning disabled -> the hand-picked default
        _, pol = api.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8))
        assert pol == DEFAULT_POLICY


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_set_default_counts_by_identity_not_equality(monkeypatch, pkg):
    """An equal-valued policy installed by set_default is still a choice:
    the table no longer fills it, in both packages."""
    if pkg == "port":
        reg, tn, pol_cls = registry, tune, ExecutionPolicy
        entry = _entry(jump="mask", block_m=16)
        table = TuningTable([entry])
    else:
        reg, tn, pol_cls = jregistry, jtune, JPolicy
        table = JTable([JEntry(op="bitserial_mm", bits=2, sparsity_band=0.0,
                               shape_bucket=(8, 64, 8),
                               policy=JPolicy(jump="mask", block_m=16))])
    monkeypatch.setattr(reg, "_default", reg._default)
    with tn.use_table(table):
        _, pol = reg.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8))
        assert pol.jump == "mask"
        assert not reg._policy_configured()
        reg.set_default(policy=pol_cls())
        assert reg._policy_configured()
        _, pol = reg.resolve("bitserial_mm", s=2, t=2, shape=(8, 64, 8))
        assert pol == pol_cls() and pol.jump == "none"


def test_dispatch_results_identical_with_and_without_table():
    """Tuning is advisory: a table-picked policy changes speed only."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, (9, 70)).astype(np.int32)
    b = rng.integers(0, 8, (70, 5)).astype(np.int32)
    want = a.astype(np.int64) @ b
    table = TuningTable([_entry(bits=3, jump="compact", mode="mxu")])
    for backend in api.list_backends():
        for tbl in (table, None):
            with tune.use_table(tbl):
                got = api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b),
                                       2, 3, backend=backend)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


def _tiled_calls(tiles, ap, bp):
    a_vals = bitops.unpack_along_axis(ap, dim=2)
    aq = sum(a_vals[i].to(torch.int32) << i for i in range(ap.shape[0]))
    b_vals = bitops.unpack_along_axis(bp, dim=1)
    bq = sum(b_vals[i].to(torch.int32) << i for i in range(bp.shape[0]))
    alpha = torch.full((ap.shape[1], 1), 0.01)
    beta = torch.zeros((1, bp.shape[2]))
    return {
        "bitserial_mm": lambda: api.bitserial_mm(
            aq[:, :ap.shape[2] * 32], bq[:bp.shape[1] * 32], ap.shape[0],
            bp.shape[0], backend="cuda", tiles=tiles),
        "bitserial_mm_packed": lambda: api.bitserial_mm_packed(
            ap, bp, backend="cuda", tiles=tiles),
        "bgemm": lambda: api.bgemm(ap[0], bp[0], backend="cuda",
                                   tiles=tiles),
        "bitserial_fused": lambda: api.bitserial_fused(
            ap, bp, alpha, beta, out_bits=4, backend="cuda", tiles=tiles),
    }


@pytest.mark.parametrize("call", ["bitserial_mm", "bitserial_mm_packed",
                                  "bgemm", "bitserial_fused"])
def test_tiles_dispatch_never_consults_table(monkeypatch, call):
    """tiles= artifacts are built on DEFAULT_POLICY's grid; a table entry
    with another grid must not be swapped under them, so a call carrying
    tiles never reaches the table, and one without does."""
    from repro_torch.tune import table as table_mod

    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (16, 256)).astype(np.int32)
    a[:, 64:192] = 0
    b = rng.integers(0, 4, (256, 8)).astype(np.int32)
    ap = bitops.pack_a(torch.as_tensor(a), 2)
    bp = bitops.pack_b(torch.as_tensor(b), 2)
    tiles = zerotile.compact_artifacts(ap, DEFAULT_POLICY.block_m,
                                       DEFAULT_POLICY.block_w)
    asked = []
    real = table_mod.dispatch_policy

    def spy(op, **kw):
        asked.append(op)
        return real(op, **kw)

    monkeypatch.setattr(table_mod, "dispatch_policy", spy)
    table = TuningTable([_entry(op=op, bits=bits, shape=(16, 256, 8),
                                jump="compact", block_m=16, block_w=8)
                         for op, bits in (("bitserial_mm", 2), ("bgemm", 1),
                                          ("bitserial_fused", 2))])
    with tune.use_table(table):
        got = _tiled_calls(tiles, ap, bp)[call]()
        assert asked == []
        untiled = _tiled_calls(None, ap, bp)[call]()
        assert len(asked) == 1
    torch.testing.assert_close(got, untiled, rtol=0, atol=0)
    if call != "bitserial_fused":
        want = (a.astype(np.int64) & (1 if call == "bgemm" else 3)) @ \
            (b & (1 if call == "bgemm" else 3))
        np.testing.assert_array_equal(got.numpy(), want)


def test_install_and_context_precedence():
    t_ctx = TuningTable([_entry(jump="mask")])
    t_inst = TuningTable([_entry(jump="compact")])
    try:
        tune.install(t_inst)
        assert tune.active_table() is t_inst
        with tune.use_table(t_ctx):  # context beats install
            assert tune.active_table() is t_ctx
        with tune.use_table(None):   # context can disable
            assert tune.active_table() is None
        assert tune.active_table() is t_inst
    finally:
        tune.install()  # restore AUTO
    assert tune.active_table() is tune.default_table()


# --------------------------------------------- the reference's chain, case by case

# one table document for both packages: policies both accept (the
# reference's tiles are multiples of (8, 128), the port's at most 1024
# threads), several per op so the shape and bits decide
_POLS = ({}, {"jump": "compact"}, {"jump": "sgt", "block_w": 8},
         {"mode": "mxu"}, {"jump": "mask", "block_w": 1},
         {"mode": "mxu", "jump": "compact", "reuse": False})
_CELLS = [(op, bits, shape) for op in ("bitserial_mm", "bgemm",
                                       "bitserial_fused")
          for bits in ((1,) if op == "bgemm" else (1, 4, 8))
          for shape in ((2304, 2304, 16), (2304, 128, 64), (64, 2048, 64))]


def _doc():
    import dataclasses

    return {"schema_version": 1, "meta": {}, "entries": [
        {"op": op, "bits": bits, "sparsity_band": 0.0,
         "shape_bucket": list(shape),
         "policy": dataclasses.asdict(ExecutionPolicy(
             block_m=8, block_n=128, **_POLS[i % len(_POLS)])),
         "backend": "cuda", "median_ms": 1.0, "baseline_ms": None}
        for i, (op, bits, shape) in enumerate(_CELLS)]}


_QUERIES = [(op, s, t, shape)
            for op in ("bitserial_mm", "bgemm", "bitserial_fused", "wq_mm")
            for s, t in ((1, 1), (2, 3), (8, 8))
            for shape in ((2304, 2304, 16), (2304, 128, 16), (100, 640, 40),
                          None)]


@pytest.mark.parametrize("op, s, t, shape", _QUERIES)
def test_same_document_resolves_to_the_same_policy(op, s, t, shape):
    t_port = TuningTable.from_dict(_doc())
    t_ref = JTable.from_dict(_doc())
    with tune.use_table(t_port):
        _, got = api.resolve(op, s=s, t=t, shape=shape, backend="torch_dot")
        _, not_tuned = api.resolve(op, s=s, t=t, shape=shape,
                                   backend="torch_dot", tuned=False)
    with jtune.use_table(t_ref):
        _, want = japi.resolve(op, s=s, t=t, shape=shape, backend="xla_dot")
        _, j_not_tuned = japi.resolve(op, s=s, t=t, shape=shape,
                                      backend="xla_dot", tuned=False)
    if op == "wq_mm":  # no entry: each package's hand-picked default
        assert got is DEFAULT_POLICY and want is japi.DEFAULT_POLICY
    else:
        assert tune.policy_to_dict(got) == jtune.policy_to_dict(want)
        assert got.block_n == 128  # the table's, not the port's default
    # untuned, each package keeps its own hand-picked default
    assert not_tuned is DEFAULT_POLICY and j_not_tuned is japi.DEFAULT_POLICY


def test_call_sites_pass_the_reference_shapes(monkeypatch):
    """The four tuned call sites hand the table the same (op, bits, shape)
    hints as the reference's; bitpack gives no shape, as there."""
    asked = {"port": [], "reference": []}
    def spy(pkg):
        return lambda op, **kw: asked[pkg].append(
            (op, kw["bits"], kw["shape"] and tuple(kw["shape"])))

    monkeypatch.setattr(registry, "_tuned_policy", spy("port"))
    monkeypatch.setattr(jregistry, "_tuned_policy", spy("reference"))
    rng = np.random.default_rng(9)
    a = rng.integers(0, 8, (24, 100)).astype(np.int32)
    b = rng.integers(0, 4, (100, 12)).astype(np.int32)
    x = rng.standard_normal((24, 100)).astype(np.float32)
    alpha = np.full((24, 1), 0.01, np.float32)
    beta = np.zeros((1, 12), np.float32)

    def calls(mod, bt, conv, engine):
        ap, bp = bt.pack_a(conv(a), 3), bt.pack_b(conv(b), 2)
        mod.bitserial_mm(conv(a), conv(b), 3, 2, backend=engine)
        mod.bitserial_mm_packed(ap, bp, backend=engine)
        mod.bgemm(ap[0], bp[0], backend=engine)
        mod.bitserial_fused(ap, bp, conv(alpha), conv(beta), out_bits=4,
                            backend=engine)
        mod.bitpack(conv(x), conv(np.float32(0.1)), conv(np.float32(0.0)),
                    nbits=4, backend=engine)

    calls(api, bitops, torch.as_tensor, "torch_dot")
    calls(japi, jbitops, jnp.asarray, "xla_dot")
    assert asked["port"] == asked["reference"]
    assert asked["port"] == [
        ("bitserial_mm", 3, (24, 100, 12)), ("bitserial_mm", 3, (24, 128, 12)),
        ("bgemm", 1, (24, 128, 12)), ("bitserial_fused", 3, (24, 128, 12)),
        ("bitpack", 4, None)]


# ----------------------------------------------------------- sweep harness

_GRID = {
    "name": "unit", "ops": ["bgemm", "bitserial_mm"], "bits": [1, 2],
    "sparsity_bands": [0.0, 0.9], "shapes": [[16, 256, 16]],
    "iters": 1, "warmup": 1,
    "candidates": [{}, {"jump": "compact"}, {"jump": "sgt"},
                   {"block_n": 150}],
}


def test_run_sweep_matches_reference_grid_and_schema(monkeypatch):
    monkeypatch.setattr(jsweep, "bench_median", lambda *a, **k: 0.001)
    with jtune.use_table(None):
        want = jsweep.run_sweep(dict(_GRID, backend="pallas"),
                                log=lambda *_: None, source="unit.json")
    lines = []
    got = sweep.run_sweep(dict(_GRID, backend="cuda"), log=lines.append,
                          source="unit.json", device="cpu")
    assert [e.key for e in got.table.entries] == \
        [e.key for e in want.table.entries]
    assert got.table.meta["candidates"] == want.table.meta["candidates"] \
        == _GRID["candidates"][:3]
    # the same fields; "best" marks each side's own fastest arm
    assert [sorted(set(r) - {"best"}) for r in got.records] == \
        [sorted(set(r) - {"best"}) for r in want.records]
    for res in (got, want):
        assert all(r["phase"] == "sweep" for r in res.records)
        assert {r["op"] for r in res.records} == {"bgemm", "bitserial_gemm"}
        by_cell = {}
        for r in res.records:
            key = (r["op"], r["bits"], r["sparsity"])
            by_cell[key] = by_cell.get(key, 0) + r.get("best", False)
        assert len(by_cell) == 6 and set(by_cell.values()) == {1}
        # the rejection names the offending slot and keeps the policy's text
        assert [r["source"] for r in res.rejected] == \
            ["unit.json:candidates[3]"]
        assert res.rejected[0]["error"].startswith("unit.json:candidates[3]: ")
    assert got.rejected[0]["error"].endswith("got 8 * 150 = 1200")
    e = got.table.entries[0]
    assert e.backend == "cuda" and e.baseline_ms is not None
    meta = got.table.meta
    assert meta["generated_by"] == "repro_torch.launch.sweep"
    assert meta["swept_on"] == "cpu" and "jax" not in meta
    assert any("rejected candidate {'block_n': 150}" in ln for ln in lines)


def test_sweep_rejects_a_grid_without_valid_candidates():
    with pytest.raises(ValueError, match="no valid policy candidates"):
        sweep.run_sweep(dict(_GRID, candidates=[{"block_n": 150}]),
                        log=lambda *_: None, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep op"):
        sweep.run_sweep(dict(_GRID, ops=["wq_mm"]), log=lambda *_: None,
                        device="cpu")


def test_sweep_parity_gate_fails_on_a_wrong_arm(monkeypatch):
    """A candidate whose result differs from torch_dot fails the sweep."""
    real = api.bgemm

    def off_by_one(a, b, *, backend=None, policy=None, tiles=None):
        out = real(a, b, backend=backend, policy=policy, tiles=tiles)
        return out + 1 if policy is not None and policy.jump == "sgt" \
            else out

    monkeypatch.setattr(api, "bgemm", off_by_one)
    with pytest.raises(AssertionError, match="sweep parity: bgemm"):
        sweep.run_sweep(dict(_GRID, ops=["bgemm"]), log=lambda *_: None,
                        device="cpu")


def test_serve_sweep_matches_reference():
    """The serve arm at scale 0.004: the same bucket entries, record
    schema and grid rejection as the reference's; logits equal across the
    candidates (asserted inside)."""
    scfg = {"dataset": "ogbn-arxiv", "scale": 0.004, "parts": 4,
            "rounds": 1, "levels": 2,
            "candidates": [{}, {"jump": "compact"}, {"jump": "sgt"},
                           {"block_m": 16}]}
    j_rej, rej = [], []
    with jtune.use_table(None):
        j_ents, j_recs = jsweep._sweep_serve(scfg, j_rej, lambda *_: None,
                                             source="unit.json")
    ents, recs = sweep._sweep_serve(scfg, rej, lambda *_: None,
                                    source="unit.json", device="cpu")
    assert [e.key for e in ents] == [e.key for e in j_ents]
    assert len(ents) == 2 and ents[0].sparsity_band > 0.5
    # the same fields; "best" marks each side's own fastest arm
    assert [sorted(set(r) - {"best"}) for r in recs] == \
        [sorted(set(r) - {"best"}) for r in j_recs]
    assert [r["jump"] for r in recs] == ["none", "compact", "sgt"]
    assert sum(r.get("best", False) for r in recs) == 1
    assert sum(r.get("best", False) for r in j_recs) == 1
    assert rej == j_rej and [r["source"] for r in rej] == \
        ["unit.json:serve:candidates[3]"]
    assert "must keep the default tile grid" in rej[0]["error"]
    assert {e.policy for e in ents} == {next(
        ExecutionPolicy(**r["policy"]) for r in recs if r.get("best"))}


# ------------------------------------------------------------ the launcher

def test_launch_sweep_smoke_on_the_cpu_writes_a_strict_table(tmp_path,
                                                              capsys):
    from repro_torch.launch import sweep as launch

    out = tmp_path / "t.json"
    summary = launch.main(["--smoke", "--device", "cpu", "--out", str(out),
                           "--commit", "abc123"])
    t = TuningTable.load(out, strict=True)
    assert len(t) == summary["entries"] == 6 + 2  # 6 cells + 2 buckets
    assert {e.op for e in t.entries} == {"bgemm", "bitserial_mm",
                                         "serve_forward"}
    assert t.meta["commit"] == "abc123" and t.meta["config"] == "smoke"
    assert {"torch", "cuda", "backends"} <= set(t.meta)
    assert "jax" not in t.meta
    assert [r["source"].rsplit(":", 2)[1:] for r in summary["rejected"]] \
        == [["SMOKE_CONFIG", "candidates[3]"]]
    assert summary["rejected"][0]["source"].startswith(
        str(pathlib.Path(sweep.__file__)))
    assert "[sweep] {" in capsys.readouterr().out
    kernels_only = launch.main(["--smoke", "--device", "cpu", "--kernels-only",
                                "--out", str(tmp_path / "k.json")])
    assert kernels_only["entries"] == 6
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu"])  # neither --smoke nor --config


def test_launch_sweep_bench_out_keeps_other_records_and_refuses_reserved(
        tmp_path):
    from repro_torch.launch import sweep as launch

    bench = tmp_path / "BENCH_torch.json"
    bench.write_text(json.dumps({"schema": 2, "smoke": True, "records": [
        {"op": "bgemm", "median_ms": 1.0},
        {"op": "bgemm", "median_ms": 2.0, "phase": "sweep"}]}))
    launch.merge_bench(bench, [{"op": "bitserial_gemm", "phase": "sweep"}])
    got = json.loads(bench.read_text())
    assert got["smoke"] is True and got["schema"] == 2
    assert got["records"] == [{"op": "bgemm", "median_ms": 1.0},
                              {"op": "bitserial_gemm", "phase": "sweep"}]
    with pytest.raises(ValueError, match="reference's records"):
        launch.merge_bench(tmp_path / "BENCH_kernels.json", [])
    with pytest.raises(SystemExit):
        launch.main(["--smoke", "--device", "cpu", "--out",
                     str(tmp_path / "t.json"), "--bench-out",
                     str(ROOT / "BENCH_kernels.json")])
    assert not (tmp_path / "t.json").exists()


def test_sweep_is_a_lazy_attribute_of_tune():
    assert tune.sweep is sweep
    with pytest.raises(AttributeError):
        tune.no_such_module  # noqa: B018


# ------------------------------------------------------------- kernel_bench

def _schema(records):
    """{(op, arm, pattern): sorted keys} of a record list."""
    out = {}
    for r in records:
        out.setdefault((r["op"], r.get("arm"), r.get("pattern")),
                       set()).add(tuple(sorted(r)))
    return out


def test_kernel_bench_smoke_records_match_the_reference_schema(monkeypatch):
    """kernel_bench at its SMOKE sizes on the CPU, as suite ``kernels`` of
    run.py: every record key for key against the reference's own
    (BENCH_kernels.json, written by the reference's smoke run), the two
    speed gates emitted as claim_holds lines."""
    from repro_torch.benchmarks import common, kernel_bench, run

    assert ("kernels", kernel_bench.main) in run.SUITES
    assert run.SMOKE["kernels"] == {"smoke": True}
    got = []

    def main(**kw):
        recs = kernel_bench.main(**kw)
        got.extend(recs)
        return recs

    monkeypatch.setattr(run, "SUITES", [("kernels", main)])
    lines = run.main(device="cpu", smoke=True, suites=["kernels"])
    ref = json.loads((ROOT / "BENCH_kernels.json").read_text())
    assert ref["smoke"] is True
    want = _schema(ref["records"])
    mine = _schema(got)
    assert set(mine) == set(want)
    assert mine == want
    # the same cells as the reference's smoke run, in the same order
    key = ("op", "bits", "sparsity", "jump", "pattern", "arm")
    assert [tuple(r.get(k) for k in key) for r in got
            if not r["op"].startswith("serve")] == \
        [tuple(r.get(k) for k in key) for r in ref["records"]
         if not r["op"].startswith("serve")]
    claims = {ln["name"]: ln for ln in lines if "claim_holds" in ln}
    assert "sgt_no_slower_than_compact" in claims
    assert "train_step_int_vs_fake_4b" in claims
    assert all(ln["suite"] == "kernels" for ln in lines)
    assert len(common.RECORDS) >= len(lines)
