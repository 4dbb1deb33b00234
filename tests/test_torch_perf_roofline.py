"""The port's H100 roofline (``repro_torch.perf.roofline``) and the dry-run
renderers of ``repro_torch.perf.report``, against the reference's
``repro.perf.roofline`` / ``repro.perf.report`` on the CPU.

The reference reads its collectives from XLA HLO text, the port from
``(op, result_bytes, group)`` records of the collectives a step issued: the
same op, size and group give the same effective bytes (one synthetic HLO
line per op kind for the reference), the same per-op sums and the same trip
multipliers. ``roofline_terms`` equals the reference's once the reference's
``HW`` holds the port's rates (patched in the test only); the report's
tables are the same strings for the same records. Everything is compared
exactly: both sides do the same float64 arithmetic.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.perf import report as jreport  # noqa: E402
from repro.perf import roofline as jroof  # noqa: E402
from repro_torch.perf import report, roofline  # noqa: E402

OPS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
       "collective-permute")
GROUPS = (1, 2, 4, 8, 16, 256)
SHAPES = (("f32", (16, 256), 4), ("bf16", (3, 4096), 2), ("s32", (7,), 4))


def _hlo_line(op, dt, dims, group, scope=None):
    shape = f"{dt}[{','.join(map(str, dims))}]{{0}}"
    groups = ("source_target_pairs={{0,1}}" if op == "collective-permute"
              else "replica_groups={{" + ",".join(map(str, range(group)))
              + "}}")
    meta = f', metadata={{op_name="{scope}"}}' if scope else ""
    return f"  %c.1 = {shape} {op}({shape} %p), {groups}{meta}"


def _nbytes(dims, width):
    n = width
    for d in dims:
        n *= d
    return n


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("group", GROUPS)
def test_effective_bytes_match_the_reference(op, group):
    for dt, dims, width in SHAPES:
        want = jroof.parse_hlo_collectives(_hlo_line(op, dt, dims, group),
                                           default_group=group)
        got = roofline.parse_collectives([(op, _nbytes(dims, width), group)])
        assert got == want


def test_sums_and_trip_multipliers_match_the_reference():
    trips = {"layers": 32, "micro_scan": 2, "absent": 7}
    scopes = ("jit(step)/layers/while/body/dot", "jit(step)/micro_scan/"
              "layers/x", "jit(step)/head", None)
    lines, recs = [], []
    for i, op in enumerate(OPS * 2):
        dt, dims, width = SHAPES[i % len(SHAPES)]
        g = GROUPS[i % len(GROUPS)]
        scope = scopes[i % len(scopes)]
        lines.append(_hlo_line(op, dt, dims, g, scope))
        recs.append((op, _nbytes(dims, width), g, scope or ""))
    hlo = "\n".join(lines + ["  %n = f32[4]{0} add(f32[4] %a, f32[4] %b)"])
    for t in (None, trips):
        want = jroof.collective_bytes(hlo, default_group=1, trips=t)
        got = roofline.collective_bytes(recs, trips=t)
        assert got.pop("link_s") > 0
        assert got == want


def test_a_zero_size_collective_is_dropped_as_the_reference_drops_it():
    line = "  %c = f32[0]{0} all-reduce(f32[0] %p), replica_groups={{0,1}}"
    assert jroof.parse_hlo_collectives(line) == []
    assert roofline.parse_collectives([("all-reduce", 0, 2)]) == []


@pytest.mark.parametrize("kind", ["train", "fwd"])
def test_model_flops_match_the_reference(kind):
    for n, toks, act in ((7_000_000_000, 1 << 20, None),
                         (1_300_000_000, 4096, 400_000_000)):
        assert roofline.model_flops(n, toks, kind, act) == \
            jroof.model_flops(n, toks, kind, act)


def test_hw_is_the_h100_datasheet():
    assert roofline.HW["peak_flops_bf16"] == 989e12
    assert roofline.HW["peak_flops_fp32"] == 67e12
    assert roofline.HW["hbm_bw"] == 3.35e12
    assert roofline.HW["nvlink_bw"] == 450e9
    assert roofline.HW["ib_bw"] == 50e9
    assert roofline.link_bw(8) == 450e9 and roofline.link_bw(9) == 50e9
    if not torch.cuda.is_available():
        assert roofline.hbm_bytes() == 80e9


@pytest.mark.parametrize("group", [2, 8, 16, 256])
def test_roofline_terms_match_the_reference_at_the_h100_rates(monkeypatch,
                                                              group):
    monkeypatch.setitem(jroof.HW, "peak_flops_bf16",
                        roofline.HW["peak_flops_bf16"])
    monkeypatch.setitem(jroof.HW, "hbm_bw", roofline.HW["hbm_bw"])
    monkeypatch.setitem(jroof.HW, "ici_bw", roofline.link_bw(group))
    cases = ((3.1e14, 2.2e11, 7.5e9, 256, 1.9e16, 0.0, 0.0),
             (1e9, 5e12, 0.0, 16, 0.0, 2e8, 1e10),
             (0.0, 1e6, 1e12, 512, 1e15, 0.0, 0.0))
    for f, by, coll, n, mf, ef, eb in cases:
        want = jroof.roofline_terms(f, by, coll, n_devices=n,
                                    model_flops_total=mf, extra_flops=ef,
                                    extra_bytes=eb).as_dict()
        got = roofline.roofline_terms(f, by, coll, n_devices=n,
                                      model_flops_total=mf, extra_flops=ef,
                                      extra_bytes=eb, group=group).as_dict()
        assert got == want
        # the records' own link time: every op in the group's rate
        s = roofline.collective_bytes([("all-reduce", coll / 2, group)])
        assert roofline.roofline_terms(
            f, by, coll, n_devices=n, collective_s=s["link_s"]
        ).collective_s == s["total_effective_bytes"] / roofline.link_bw(group)


def _records():
    ok = {"arch": "codeqwen1.5-7b", "shape": "train_4k", "mesh": "16x16",
          "status": "OK", "compile_s": 21.37,
          "roofline": {"compute_s": 0.2766, "memory_s": 3.27e-2,
                       "collective_s": 2.27, "bottleneck": "collective",
                       "useful_flops_ratio": 0.7421},
          "memory": {"peak_bytes_est": 3.4e9}, "fits_hbm": True,
          "cost_hlo_raw": {"flops": 2.1e14},
          "analytic": {"flops_per_device": 2.7e14},
          "collectives": {"total_effective_bytes": 9.7e10},
          "collectives_by_op": {"all-reduce": {"count": 96},
                                "all-gather": {"count": 33}}}
    tiny = dict(ok, shape="decode_32k", mesh="2x16x16", fits_hbm=False,
                roofline=dict(ok["roofline"], compute_s=3e-5,
                              memory_s=0.0, collective_s=5e-7,
                              bottleneck="compute"))
    skip = {"arch": "olmoe-1b-7b", "shape": "long_500k", "mesh": "16x16",
            "status": "SKIP", "reason": "SKIP(full-attn): 524k dense KV + "
                                        "quadratic decode attention"}
    fail = {"arch": "whisper-large-v3", "shape": "train_4k", "mesh": "16x16",
            "status": "FAIL", "error": "RuntimeError('Cannot unflatten "
                                       "unevenly sharded tensor')"}
    return [ok, tiny, skip, fail, dict(skip, mesh="2x16x16"),
            dict(fail, mesh="2x16x16")]


def test_report_tables_match_the_reference(tmp_path):
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    assert report.load(tmp_path) == jreport.load(tmp_path) == recs
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    for x in (0, 3e-5, 5e-3, 0.2, 12.5):
        assert report._fmt_s(x) == jreport._fmt_s(x)


def test_report_main_prints_the_three_tables(tmp_path, capsys, monkeypatch):
    for i, r in enumerate(_records()):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    monkeypatch.setattr("sys.argv", ["report", str(tmp_path)])
    report.main()
    ours = capsys.readouterr().out
    jreport.main()
    assert ours == capsys.readouterr().out
    assert ours.count("| codeqwen1.5-7b |") == 4


def _compared():
    """Two runs' records: the second moves the train cell's collectives,
    peak and bottleneck and counts them with ``CommDebugMode``."""
    by_op = {"all-gather": {"count": 144, "result_bytes": 78.17e9},
             "all-reduce": {"count": 114, "result_bytes": 57.95e9}}
    ok = dict(_records()[0], collectives_by_op=by_op,
              memory={"peak_bytes_est": 34.86e9, "param_bytes": 1024})
    after = dict(ok, fits_hbm=False,
                 collectives_by_op={"all-reduce": {"count": 395,
                                                   "result_bytes": 88.0e9}},
                 memory=dict(ok["memory"], peak_bytes_est=34.35e9),
                 roofline=dict(ok["roofline"], collective_s=3.3,
                               bottleneck="memory"),
                 comm_debug={"equal": True})
    skip = _records()[2]
    return [ok, skip], [after, skip, dict(ok, mesh="2x16x16")]


def test_compare_table_sets_two_runs_side_by_side():
    before, after = _compared()
    rows = report.compare_table(before, after).splitlines()
    assert len(rows) == 2 + len(after)
    assert all(r.count("|") == 12 for r in rows)
    assert rows[2] == ("| codeqwen1.5-7b | train_4k | 16x16 | OK | "
                       "gather 144/78.170 reduce 114/57.950 -> "
                       "reduce 395/88.000 | 2.270 -> 3.300 | "
                       "collective -> memory | 34.86 -> 34.35 | Y -> N | "
                       "Y | - -> Y |")
    assert rows[3] == ("| olmoe-1b-7b | long_500k | 16x16 | SKIP -> SKIP |"
                       + " - |" * 7)
    # a cell the first run did not have
    assert rows[4].startswith("| codeqwen1.5-7b | train_4k | 2x16x16 | "
                              "None -> OK |")
    # flops or parameter bytes that moved read N
    moved = dict(after[0], cost_hlo_raw={"flops": 1.0})
    assert report.compare_table(before, [moved]).splitlines()[2].endswith(
        "| N | - -> Y |")


def test_report_main_compares_two_directories(tmp_path, capsys, monkeypatch):
    for name, recs in zip(("a", "b"), _compared()):
        (tmp_path / name).mkdir()
        for i, r in enumerate(recs):
            (tmp_path / name / f"{i:02d}.json").write_text(json.dumps(r))
    monkeypatch.setattr("sys.argv", ["report", "--compare",
                                     str(tmp_path / "a"), str(tmp_path / "b")])
    report.main()
    out = capsys.readouterr().out
    assert out == report.compare_table(*map(report.load, (
        tmp_path / "a", tmp_path / "b"))) + "\n"
