"""The port's contract lint and trace checker (``repro_torch.analysis``,
``repro_torch.launch.lint``), on the CPU.

The lint is clean on the port's own tree; each rule flags a known-bad
snippet and stays quiet on a good one (the snippets are written into
``tmp_path`` under the package's layout and linted with ``rel_root``);
waivers, baseline identity and stale-baseline strictness give what the
reference's ``repro.analysis.engine`` gives on the same sources; every
literal policy site gets the reference's verdict. The trace checker
passes on every registered engine and on the int training step, and
flags a float GEMM planted in an engine, in the training forward, and
torch_dot's former float64 card route.
"""
import ast
import json
import pathlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import engine as jengine  # noqa: E402
from repro.api.policy import DEFAULT_POLICY as JDEFAULT  # noqa: E402
from repro.api.policy import ExecutionPolicy as JPolicy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis import engine, trace  # noqa: E402
from repro_torch.analysis.rules import ALL_RULES, get_rule  # noqa: E402
from repro_torch.analysis.rules import policy_sites  # noqa: E402
from repro_torch.api import backends, registry  # noqa: E402
from repro_torch.api.backend import Backend  # noqa: E402
from repro_torch.core import bitops  # noqa: E402
from repro_torch.launch import lint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(tmp_path, files: dict) -> pathlib.Path:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tmp_path


def _lint(tmp_path, files, rule=None):
    root = _tree(tmp_path, files)
    rules = None if rule is None else [get_rule(rule)]
    return engine.run_lint([root / "src"], rules=rules, rel_root=root).findings


# ------------------------------------------------------------------- lint

def test_port_tree_is_clean_strict(capsys):
    assert engine.DEFAULT_SCAN_ROOTS == ("src/repro_torch",)
    result = engine.run_lint()
    assert result.files > 70
    assert result.findings == [], "\n".join(map(str, result.findings))
    assert lint.main(["--strict"]) == 0
    assert "0 findings" in capsys.readouterr().out


def test_every_waiver_in_the_port_carries_a_reason():
    for path in engine.iter_py_files([ROOT / "src" / "repro_torch"]):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = engine._WAIVER_RE.search(line)
            if m and "analysis" not in path.parts:
                reason = line[m.end():].strip(" —-:#")
                assert len(reason) > 10, f"{path}:{i}: waiver without a reason"


BAD_GOOD = {
    "kernel-int-purity": (
        "src/repro_torch/kernels/bitserial.py",
        """\
        import torch
        def gemm(a, b):
            return a.to(torch.float32) @ b.double()
        def scale(x):
            return torch.floor(x * 0.5)
        """,
        """\
        import torch
        def gemm(a, b):
            return popcount(a & b).sum(dim=1) << 2
        # lint: allow[kernel-int-purity] — the §4.5 epilogue is float
        def epilogue(acc, alpha):
            return torch.floor(acc.to(torch.float32) * alpha + 0.5)
        """),
    "bench-timer-sync": (
        "src/repro_torch/benchmarks/fig_x.py",
        """\
        import time
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        def wall(fn):
            t0 = time.time()
            fn()
            t1 = time.time()
            return t1 - t0
        """,
        """\
        import time
        import torch
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        def loss_time(fn):
            t0 = time.time()
            loss = fn()
            return loss.item(), time.time() - t0
        """),
    "api-dispatch-bypass": (
        "src/repro_torch/serve/bad.py",
        """\
        from repro_torch.kernels import ops
        from repro_torch.kernels.bitserial import bitserial_gemm
        import repro_torch.kernels._build
        """,
        """\
        from repro_torch import api
        from repro_torch.kernels import sgt
        """),
    "serve-chaos-harness": (
        "src/repro_torch/serve/engine.py",
        """\
        import time
        from repro_torch.serve.chaos import ReplicaFault
        def step(rep):
            time.sleep(0.5)
            raise ReplicaFault(rep, "kill", 0)
        """,
        """\
        from repro_torch.serve.chaos import ReplicaFault
        def step(run):
            try:
                return run()
            except ReplicaFault:
                return None
        """),
    "policy-grid": (
        "src/repro_torch/benchmarks/fig_y.py",
        """\
        from repro_torch.api import DEFAULT_POLICY, ExecutionPolicy
        a = ExecutionPolicy(block_m=0)
        b = DEFAULT_POLICY.replace(jump="bogus")
        """,
        """\
        from repro_torch.api import DEFAULT_POLICY, ExecutionPolicy
        a = ExecutionPolicy(block_m=16, jump="compact")
        b = DEFAULT_POLICY.replace(mode="mxu")
        c = ExecutionPolicy(block_m=width)
        """),
}


@pytest.mark.parametrize("rule", sorted(BAD_GOOD))
def test_rule_flags_bad_and_passes_good(tmp_path, rule):
    path, bad, good = BAD_GOOD[rule]
    found = _lint(tmp_path / "bad", {path: bad})
    assert found and {f.rule for f in found} == {rule}, found
    assert all(f.path == path for f in found)
    assert _lint(tmp_path / "good", {path: good}) == []
    # out of the rule's scope the bad snippet passes
    if rule not in ("api-dispatch-bypass", "policy-grid"):
        assert _lint(tmp_path / "elsewhere",
                     {"src/repro_torch/graph/x.py": bad}, rule) == []


def test_rule_finding_counts(tmp_path):
    counts = {}
    for rule, (path, bad, _) in BAD_GOOD.items():
        counts[rule] = len(_lint(tmp_path / rule, {path: bad}))
    # purity: float32, '@', .double(), floor, 0.5; timers: the stop in
    # timed and t1 in wall (t1 - t0 subtracts names, not a timer call)
    assert counts == {"kernel-int-purity": 5, "bench-timer-sync": 2,
                      "api-dispatch-bypass": 3, "serve-chaos-harness": 2,
                      "policy-grid": 2}


def test_dispatch_exempts_kernels_api_and_tests(tmp_path):
    src = "from repro_torch.kernels import ops\n"
    files = {"src/repro_torch/api/x.py": src,
             "src/repro_torch/kernels/y.py": src, "tests/test_z.py": src}
    root = _tree(tmp_path, files)
    assert engine.run_lint([root], rel_root=root).findings == []


def test_registry_has_the_ported_rules():
    assert [r.name for r in ALL_RULES] == [
        "kernel-int-purity", "sharding-spec-layering",
        "sharding-axis-declared", "bench-timer-sync", "api-dispatch-bypass",
        "serve-chaos-harness", "policy-grid"]
    with pytest.raises(KeyError, match="unknown lint rule"):
        get_rule("serve-jit-static")


# --------------------------------------------- the engine against the reference

WAIVER_SOURCES = [
    """\
    x = f(1)  # lint: allow[call-all]
    # lint: allow[call-all] — standalone: covers the next code line

    y = g(2)
    z = h(3)
    """,
    """\
    # lint: allow[call-all, other] — a def: the whole body
    def body():
        a = f()
        return g(a)
    b = k()
    class C:  # lint: allow[*]
        v = f()
    w = f()
    """,
    """\
    # lint: allow[other]
    q = f()
    r = f()  # lint: allow[call-all]
    """,
]


def _call_rule(base):
    class CallAll(base):
        name = "call-all"

        def applies_to(self, path):
            return True

        def check(self, path, tree, lines):
            return [self.finding(path, n, f"call of {ast.unparse(n.func)}")
                    for n in ast.walk(tree) if isinstance(n, ast.Call)]
    return CallAll()


@pytest.mark.parametrize("case", range(len(WAIVER_SOURCES)))
def test_waivers_and_baselines_match_reference(tmp_path, case):
    src = textwrap.dedent(WAIVER_SOURCES[case])
    path = tmp_path / "src" / "pkg" / "m.py"
    path.parent.mkdir(parents=True)
    path.write_text(src)
    tree, lines = ast.parse(src), src.splitlines()
    assert engine.waived_lines(tree, lines) == jengine.waived_lines(tree, lines)

    def as_tuples(fs):
        return [(f.rule, f.path, f.line, f.col, f.message) for f in fs]

    got = engine.lint_file(path, [_call_rule(engine.Rule)], tmp_path)
    want = jengine.lint_file(path, [_call_rule(jengine.Rule)], tmp_path)
    assert as_tuples(got) == as_tuples(want) and got
    assert engine.baseline_payload(got) == jengine.baseline_payload(want)
    # pin all but the first finding, plus an entry that matches nothing
    pin = engine.baseline_payload(got[1:])
    pin["findings"].append({"rule": "call-all", "path": "src/pkg/m.py",
                            "message": "call of gone"})
    bfile = tmp_path / "baseline.json"
    bfile.write_text(json.dumps(pin))
    base, jbase = engine.load_baseline(bfile), jengine.load_baseline(bfile)
    assert base == jbase
    new, sup, stale = engine.split_by_baseline(got, base)
    jnew, jsup, jstale = jengine.split_by_baseline(want, jbase)
    assert (as_tuples(new), as_tuples(sup), stale) == \
        (as_tuples(jnew), as_tuples(jsup), jstale)
    assert stale == [("call-all", "src/pkg/m.py", "call of gone")]


def test_baseline_rejects_bad_files(tmp_path):
    f = tmp_path / "b.json"
    f.write_text(json.dumps({"version": 2, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        engine.load_baseline(f)
    f.write_text(json.dumps({"version": 1, "findings": [{"rule": "x"}]}))
    with pytest.raises(ValueError, match="missing"):
        engine.load_baseline(f)


# Planted kwargs where the two policies' contracts coincide. The tile
# grids differ by design: the port's kernels take any whole-warp tile, the
# reference's Pallas tiles need block_m % 8 and block_n % 128.
PLANTED_KWARGS = [{"block_m": "8"}, {"block_m": 16}, {"block_w": 0},
                  {"block_w": 8}, {"jump": "bogus"}, {"mode": "tpu"},
                  {"mode": "mxu", "jump": "sgt"}, {"reuse": False},
                  {"fused_requantize": True}, {"block_m": -8}]


def _verdict(make, kwargs):
    try:
        make(**kwargs)
    except (TypeError, ValueError):
        return False
    return True


def test_policy_sites_match_reference_verdicts():
    sites = policy_sites.collect_sites()
    literal = [s for s in sites if s["kwargs"] is not None]
    assert literal and len(sites) > len(literal)
    cases = [(s["kind"], s["kwargs"]) for s in literal]
    cases += [(kind, kw) for kw in PLANTED_KWARGS
              for kind in ("construct", "replace")]
    for kind, kw in cases:
        port = _verdict(lambda **k: policy_sites.build(kind, k), kw)
        ref = _verdict(JPolicy if kind == "construct" else JDEFAULT.replace,
                       kw)
        assert port == ref, (kind, kw)
    assert all(_verdict(lambda **k: policy_sites.build(s["kind"], k),
                        s["kwargs"]) for s in literal)
    n, dynamic, fails = trace.check_policy_sites()
    assert (n, dynamic, fails) == (len(sites), len(sites) - len(literal), [])


def test_check_policy_sites_flags_a_bad_literal(tmp_path):
    root = _tree(tmp_path, {"src/repro_torch/x.py":
                            "from repro_torch.api import ExecutionPolicy\n"
                            "p = ExecutionPolicy(block_w=0)\n"})
    n, dynamic, fails = trace.check_policy_sites([root], rel_root=root)
    assert (n, dynamic) == (1, 0)
    assert len(fails) == 1 and fails[0].startswith("src/repro_torch/x.py:2:")


# ------------------------------------------------------------------ the CLI

def test_cli_json_strict_and_list_rules(tmp_path, capsys):
    assert lint.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split("\n")
    assert [l.split()[0] for l in listed if l] == [r.name for r in ALL_RULES]

    path, bad, _ = BAD_GOOD["serve-chaos-harness"]
    root = _tree(tmp_path, {path: bad})
    args = [str(root / "src"), "--rel-root", str(root)]
    assert lint.main(args + ["--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["files"] == 1 and len(payload["findings"]) == 2
    assert {f["rule"] for f in payload["findings"]} == {"serve-chaos-harness"}

    base = tmp_path / "base.json"
    assert lint.main(args + ["--write-baseline", str(base)]) == 0
    capsys.readouterr()
    assert lint.main(args + ["--baseline", str(base), "--strict"]) == 0
    assert "2 baselined" in capsys.readouterr().out
    # fix the violations: the pinned entries go stale, and --strict fails
    (root / path).write_text("x = 1\n")
    assert lint.main(args + ["--baseline", str(base)]) == 0
    assert lint.main(args + ["--baseline", str(base), "--strict"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    assert lint.main(args + ["--baseline", str(base), "--strict",
                             "--json"]) == 1
    assert len(json.loads(capsys.readouterr().out)["stale_baseline"]) == 2


# ------------------------------------------------------------- the trace

def test_trace_checks_pass_on_cpu():
    report = trace.run_trace_checks(device="cpu", bits=(1, 3, 8),
                                    log=lambda *_: None)
    assert report["failures"] == []
    assert report["backends"] == list(api.list_backends())
    assert report["device"] == "cpu" and report["launches"] == {}
    assert report["train_path"] == {"checks": 2 * 2 * len(report["backends"]),
                                    "failures": 0}
    assert report["policy_sites"]["validated"] > 0


class _FloatEngine(Backend):
    """An engine whose bit-serial product is a float matmul."""
    name = "float_probe"
    capabilities = frozenset({"bitserial_mm", "bgemm"})

    def bitserial_mm(self, a_packed, b_packed, *, policy, tiles=None):
        a = bitops.unpack_along_axis(a_packed, dim=2).to(torch.float32)
        b = bitops.unpack_along_axis(b_packed, dim=1).to(torch.float32)
        w = 2.0 ** torch.arange(a.shape[0], dtype=torch.float32)
        v = 2.0 ** torch.arange(b.shape[0], dtype=torch.float32)
        return ((w[:, None, None] * a).sum(0) @ (v[:, None, None] * b).sum(0)
                ).to(torch.int32)

    def bgemm(self, a_packed, b_packed, *, policy, tiles=None):
        return self.bitserial_mm(a_packed[None], b_packed[None], policy=policy)


@pytest.fixture
def float_engine(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    monkeypatch.setattr(registry, "_ORDER", list(registry._ORDER))
    return registry.register(_FloatEngine())


def test_check_backend_flags_a_float_engine(float_engine):
    checks, fails = trace.check_backend("float_probe", device="cpu",
                                        bits=(1, 3))
    # bgemm, 1x1, 3x3, 1x8, 8x1 and tiles stripped: every one flagged
    assert checks == 6
    assert len({f.split(": ")[0] for f in fails if "float op 'mm'" in f}) == 6
    assert "float_probe" in api.list_backends()
    _, tf = trace.check_train_path(device="cpu", bits=(4,),
                                   backends=["float_probe"])
    assert tf and all("'mm' runs in float" in f for f in tf)


def test_trace_flags_torch_dots_float64_route(monkeypatch):
    """torch_dot's former card route, a float64 matmul (inexact for wide
    operands), is flagged on every integer path; the limb route passes."""
    def float64_route(a, b, s, t):
        mask_a = (1 << s) - 1 if s < 32 else -1
        mask_b = (1 << t) - 1 if t < 32 else -1
        return ((a & mask_a).to(torch.float64)
                @ (b & mask_b).to(torch.float64)).to(torch.int64)

    monkeypatch.setattr(backends, "_int_matmul", float64_route)
    checks, fails = trace.check_backend("torch_dot", device="cpu", bits=(2,))
    assert fails and all("float op 'mm'" in f or "'mm' runs in float" in f
                         for f in fails)
    _, tf = trace.check_train_path(device="cpu", bits=(4,),
                                   backends=["torch_dot"])
    assert tf and all("'mm' runs in float" in f for f in tf)

    monkeypatch.setattr(backends, "_int_matmul",
                        lambda a, b, s, t: backends.int_matmul_mod32(a, b, s, t))
    assert trace.check_backend("torch_dot", device="cpu", bits=(2,))[1] == []


def test_check_train_path_flags_a_float_gemm_in_the_forward(monkeypatch):
    from repro_torch.api import nn

    real = nn.affine_matmul_correction

    def with_float_gemm(aq, bq, qa, qb, prod):
        out = real(aq, bq, qa, qb, prod)
        return out + 0.0 * (aq.to(torch.float32) @ bq.to(torch.float32))

    monkeypatch.setattr(nn, "affine_matmul_correction", with_float_gemm)
    _, fails = trace.check_train_path(device="cpu", bits=(4,),
                                      backends=["popcount"])
    assert fails == ["train:popcount:forward_int:4b: 'mm' runs in float: "
                     "the int training path must keep every GEMM integer",
                     "train:popcount:grad:4b: 'mm' runs in float: "
                     "the int training path must keep every GEMM integer"]


def test_tiles_contract_errors_are_checked(monkeypatch):
    """An engine that stops refusing a device-tensor s_max or an unknown tag
    is flagged."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "_unpack_tiles", lambda tiles: (
        None, None, 0, "compact"))
    _, fails = trace.check_backend("cuda", device="cpu", bits=(1,))
    assert sorted(f.split(":")[1] + ":" + f.split(":")[2] for f in fails) == [
        "tiles:s_max-device-scalar", "tiles:unknown-tag"]


def test_record_ops_sees_integer_and_float_ops():
    a = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    _, ops = trace.record_ops(lambda x: (x @ x.t()).to(torch.float32) * 2.0, a)
    assert [op for op, _ in ops] == ["t", "mm", "_to_copy", "mul"]
    assert trace.float_ops(ops) == ["_to_copy", "mul"]


def test_torch_dot_card_route_runs_here_and_matches_exact():
    """The limb route itself is exercised in
    tests/test_torch_bittensor.py; here one case through the trace."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (4, 16)).astype(np.int32))
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (16, 4)).astype(np.int32))
    got, ops = trace.record_ops(
        lambda x, y: bitops.wrap_int32(backends.int_matmul_mod32(x, y)), a, b)
    want = (a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)).astype(
        np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert "_int_mm" in {op for op, _ in ops} and not trace.float_ops(ops)
