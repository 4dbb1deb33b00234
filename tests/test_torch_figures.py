"""Port parity for the paper-figure suites (``repro_torch.benchmarks``) and
their timing primitive (``repro_torch.perf.report``).

Each suite's ``main`` runs at ``device="cpu"``, where the ``cuda`` engine
takes the kernels' plain versions, and its emitted names and ``derived``
columns must equal the reference's for the same arguments: fig8b's non-zero
tile fractions, fig9b's byte ratios, fig8a's bit work and fig9a's tile
loads, all exact. fig9b adds the features-only strategy and III's split to
the reference's lines; nothing else differs. The suites' own equality checks
(fig8b compact against dense, fig9a reuse against no reuse, fig8a's and
fig8c's products against the exact ones) run inside them and raise.

The reference's timer is replaced by a constant, so none of its timed
calls runs; where a reference suite has no size arguments and its defaults
are large (fig8a, fig8c), both packages draw their random operands at
those sizes through a numpy whose generators return at most 8 x 8 arrays:
the names depend on the sizes, not on the data. fig8b's and fig9a's
reference runs make their untimed equality checks on its xla_dot engine
rather than its Pallas kernels in interpret mode: the columns compared do
not depend on the engine. Times are not compared.
"""
import contextlib
import io
import json
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import fig7_speedup as jfig7  # noqa: E402
from benchmarks import fig8a_lowbit_gemm as jfig8a  # noqa: E402
from benchmarks import fig8b_zerotile as jfig8b  # noqa: E402
from benchmarks import fig8c_adjsize as jfig8c  # noqa: E402
from benchmarks import fig9a_reuse as jfig9a  # noqa: E402
from benchmarks import fig9b_transfer as jfig9b  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.perf import report as jreport  # noqa: E402
from repro_torch.benchmarks import (common, fig7_speedup, fig8a_lowbit_gemm,  # noqa: E402
                                    fig8b_zerotile, fig8c_adjsize, fig9a_reuse,
                                    fig9b_transfer, run)
from repro_torch.perf import report  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(fn, **kw) -> list[tuple]:
    """Run ``fn(**kw)`` and parse the CSV lines it prints:
    (name, value, unit, tag, {extra: value})."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fn(**kw)
    out = []
    for line in buf.getvalue().splitlines():
        if line.startswith("#") or line.startswith("name,"):
            continue
        name, value, unit, tag, *extra = line.split(",")
        out.append((name, value, unit, tag,
                    dict(kv.split("=", 1) for kv in extra if kv)))
    return out


def _names(lines):
    return [x[0] for x in lines]


def _derived(lines):
    return {x[0]: float(x[1]) for x in lines if x[3] == "derived"}


@pytest.fixture
def ref_timer(monkeypatch):
    """The reference suites' timers return a constant without calling."""
    for mod in (jfig7, jfig8a, jfig8b, jfig8c, jfig9a):
        monkeypatch.setattr(mod, "timeit", lambda *a, **k: 1e-3)
    monkeypatch.setattr(jfig9b, "_t", lambda fn, iters=5: 1e-3)


class _TinyRng:
    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def _shape(self, shape):
        return tuple(min(s, 8) for s in shape)

    def random(self, shape):
        return self._rng.random(self._shape(shape))

    def integers(self, lo, hi, shape):
        return self._rng.integers(lo, hi, self._shape(shape))


class _TinyNumpy:
    """numpy, but its generators draw at most 8 x 8 arrays."""
    random = types.SimpleNamespace(default_rng=_TinyRng)

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture
def tiny_numpy(monkeypatch):
    for mod in (jfig8a, jfig8c, fig8a_lowbit_gemm, fig8c_adjsize):
        monkeypatch.setattr(mod, "np", _TinyNumpy())
    # fig8a's int8 baseline needs more than 16 rows; its time is not compared
    monkeypatch.setattr(fig8a_lowbit_gemm.torch, "_int_mm",
                        lambda a, b: a.to(torch.int32) @ b.to(torch.int32))


def test_fig7_names_match_reference(ref_timer):
    kw = dict(scale=0.002, bits_list=(2, 8))
    want = (_lines(jfig7.run, model="gcn", dsets=("proteins", "ppi"), **kw)
            + _lines(jfig7.run, model="gin", dsets=("proteins",), **kw))
    got = _lines(fig7_speedup.main, gcn_dsets=("proteins", "ppi"),
                 gin_dsets=("proteins",), device="cpu", **kw)
    assert _names(got) == _names(want)
    assert all(float(x[1]) > 0 and x[2] == "us" for x in got)


def test_fig8a_names_and_bit_work_match_reference(ref_timer, tiny_numpy):
    want = _lines(jfig8a.main)
    got = _lines(fig8a_lowbit_gemm.main, device="cpu")
    assert _names(got) == _names(want)
    assert _derived(got) == _derived(want) and len(_derived(got)) == 12


def test_fig8a_runs_and_checks_its_product():
    got = _lines(fig8a_lowbit_gemm.main, ns=(32,), d=64, bits_list=(2, 7),
                 device="cpu")
    assert _names(got) == ["fig8a_int8_n32", "fig8a_qgtc2_n32",
                           "fig8a_qgtc2_n32_bitwork", "fig8a_qgtc7_n32",
                           "fig8a_qgtc7_n32_bitwork"]


def test_fig8b_names_and_tile_fractions_match_reference(ref_timer, monkeypatch):
    # the reference's checks run on its xla_dot engine, not in interpret mode
    monkeypatch.setattr(jfig8b, "api", types.SimpleNamespace(
        bitserial_mm_packed=lambda a, h, backend, policy, tiles:
        japi.bitserial_mm_packed(a, h, backend="xla_dot", policy=policy,
                                 tiles=tiles)))
    want = _lines(jfig8b.main, scale=0.002)
    got = _lines(fig8b_zerotile.main, scale=0.002, device="cpu")
    assert _names(got) == _names(want)
    fracs = [(x[0], x[1], x[4]) for x in want if x[0].endswith("_tile_frac")]
    assert fracs == [(x[0], x[1], x[4]) for x in got
                     if x[0].endswith("_tile_frac")] and len(fracs) == 5
    skips = [x[4]["skip_ratio"] for x in want if "skip_ratio" in x[4]]
    assert skips == [x[4]["skip_ratio"] for x in got if "skip_ratio" in x[4]]


def test_fig8c_names_match_reference(ref_timer, tiny_numpy):
    want = _lines(jfig8c.main)
    got = _lines(fig8c_adjsize.main, device="cpu")
    assert _names(got) == _names(want) and len(got) == 12


def test_fig8c_runs_and_checks_its_product():
    got = _lines(fig8c_adjsize.main, ds=(16,), ns=(128, 300), device="cpu")
    assert _names(got) == ["fig8c_N128_D16", "fig8c_N300_D16"]


def test_fig9a_names_and_tile_loads_match_reference(ref_timer, monkeypatch):
    monkeypatch.setattr(jfig9a, "api", types.SimpleNamespace(
        ExecutionPolicy=japi.ExecutionPolicy,
        bitserial_mm_packed=lambda a, x, backend, policy:
        japi.bitserial_mm_packed(a, x, backend="xla_dot", policy=policy)))
    want = _lines(jfig9a.main)
    got = _lines(fig9a_reuse.main, device="cpu")
    assert _names(got) == _names(want)
    assert _derived(got) == _derived(want) and len(_derived(got)) == 6


def test_fig9b_names_and_byte_ratios_match_reference(ref_timer):
    want = _lines(jfig9b.main, scale=0.02)
    got = _lines(fig9b_transfer.main, scale=0.02, device="cpu")
    added = {f"fig9b_{d}_{s}" for d in ("ogbn-arxiv", "ogbn-products")
             for s in ("III_feats", "III_split")}
    assert [n for n in _names(got) if n not in added] == _names(want)
    assert added <= set(_names(got))
    assert _derived(got) == _derived(want) and len(_derived(got)) == 4
    byte_cols = {x[0]: x[4]["bytes"] for x in want if "bytes" in x[4]}
    assert byte_cols == {x[0]: x[4]["bytes"] for x in got
                         if "bytes" in x[4] and x[0] not in added}
    split = next(x for x in got if x[0] == "fig9b_ogbn-arxiv_III_split")[4]
    assert set(split) == {"nodes", "edges", "pack_ms", "stage_ms", "h2d_ms",
                          "unpack_ms", "copy_only_ms"}


@pytest.mark.parametrize("suite,mod", [("fig8b", fig8b_zerotile),
                                       ("fig9a", fig9a_reuse)])
def test_equality_checks_are_live(monkeypatch, suite, mod):
    """fig8b's and fig9a's equality checks raise when the two schedules
    disagree."""
    real = mod.api.bitserial_mm_packed
    calls = []

    def off_by_one_once(*a, **k):
        calls.append(1)
        out = real(*a, **k)
        return out + 1 if len(calls) == 1 else out

    monkeypatch.setattr(mod.api, "bitserial_mm_packed", off_by_one_once)
    with pytest.raises(AssertionError, match=suite):
        _lines(mod.main, device="cpu", **run.SMOKE[suite])


def test_run_writes_the_records(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "SUITES", [x for x in run.SUITES
                                        if x[0] in ("fig8a", "fig9a")])
    out = tmp_path / "figures.json"
    with contextlib.redirect_stdout(io.StringIO()):
        records = run.main(device="cpu", smoke=True, out=out)
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["smoke"] is True
    assert doc["records"] == records
    assert {r["suite"] for r in records} == {"fig8a", "fig9a"}
    assert records[0] == {"suite": "fig8a", **common.RECORDS[-len(records)]}
    with pytest.raises(ValueError, match="reference"):
        run.main(device="cpu", out=tmp_path / "BENCH_kernels.json")
    assert [s for s, _ in run.SUITES] == ["fig8a", "fig9a"]
    assert set(run.SMOKE) == {"fig7", "fig8a", "fig8b", "fig8c", "fig9a", "fig9b",
                              "table2", "serve"}


def test_percentile_and_latency_summary_equal_reference():
    rng = np.random.default_rng(0)
    for xs in ([], [0.5], list(rng.random(7)), list(rng.random(100))):
        for q in (0, 1, 50, 95, 99, 100):
            assert report.percentile(xs, q) == jreport.percentile(xs, q)
        assert report.latency_summary(xs, "p_") == jreport.latency_summary(xs, "p_")


def test_bench_median_on_the_cpu():
    calls = []

    def fn(x, *, scale):
        calls.append(1)
        return x * scale

    t = report.bench_median(fn, torch.ones(3), warmup=2, iters=5, scale=2.0)
    assert t >= 0 and len(calls) == 7
    assert common.timeit(lambda: None, iters=3) >= 0
