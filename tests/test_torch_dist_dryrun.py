"""``python -m repro_torch.launch.dryrun`` in subprocesses on the fake
256-rank (16, 16) mesh, on the CPU: codeqwen1.5-7b at full size x
``train_4k`` and ``decode_32k``; whisper-large-v3 x ``train_4k`` (20 heads
on the 16-way "model" axis, forward and backward) and rwkv6-1.6b x
``prefill_32k`` (the chunked scan run per rank, 1024 chunks a layer).

Each cell must be ``OK``; its per-device parameter bytes must equal the sum,
over the leaves, of each leaf's bytes over its shard count under the cell's
rules (computed here from the sharding trees alone); its measured
temporaries must make the reference's peak formula; it must have issued
all-reduces with nonzero bytes (tensor parallelism's sums over "model");
its records must equal torch's ``CommDebugMode`` counts op by op
(``--comm-debug``, in the same run); and the report's tables of its
records must be the reference renderer's strings.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

CELLS = (("codeqwen1.5-7b", "train_4k", "train"),
         ("codeqwen1.5-7b", "decode_32k", "serve"),
         ("whisper-large-v3", "train_4k", "train"),
         ("rwkv6-1.6b", "prefill_32k", "serve"))
# each arch's parameter count, to the order the config gives
MIN_PARAMS = {"codeqwen1.5-7b": 7e9, "whisper-large-v3": 1.5e9,
              "rwkv6-1.6b": 1.5e9}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out), "--comm-debug"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, _ in CELLS]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(CELLS), logs
    return {(r["arch"], r["shape"]): r for r in
            (json.loads(p.read_text()) for p in sorted(out.glob("*.json")))}


def _param_bytes_by_shards(arch, mode) -> int:
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps

    p, a = steps.abstract_params(configs.get(arch))
    sh = steps.param_shardings(
        shd.AbstractMesh((16, 16), ("data", "model")), shd.make_rules(mode),
        a, p)
    from repro_torch.train import optimizer as opt

    sizes = {"data": 16, "model": 16}
    total = 0
    for leaf, s in zip(opt.tree_leaves(p), opt.tree_leaves(sh)):
        shards = 1
        for entry in s.spec:
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                shards *= sizes[a]
        total += leaf.numel() * leaf.element_size() // shards
    return total


@pytest.mark.parametrize("arch,shape,mode", CELLS)
def test_cell_is_ok_with_its_shard_bytes_and_collectives(records, arch,
                                                         shape, mode):
    r = records[(arch, shape)]
    assert r["status"] == "OK", r.get("error")
    assert r["mesh"] == "16x16" and r["mesh_info"]["n_devices"] == 256
    mem = r["memory"]
    assert mem["param_bytes"] == _param_bytes_by_shards(arch, mode)
    # the step's temporaries, measured (perf/roofline.PeakMemory)
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    # the arguments hold the parameters and, training, two moments of
    # the same shards; the donated trees are aliased
    assert mem["argument_bytes"] >= (3 if mode == "train" else 1) * \
        mem["param_bytes"]
    assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
    assert mem["peak_top"] and all(t["bytes"] > 0 for t in mem["peak_top"])
    # tensor parallelism sums the row-parallel products over "model"
    by_op = r["collectives_by_op"]
    assert by_op["all-reduce"]["count"] > 0
    assert by_op["all-reduce"]["effective_bytes"] > 0
    assert r["collectives"]["total_effective_bytes"] == sum(
        v["effective_bytes"] for v in by_op.values())
    rl = r["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    assert r["fits_hbm"] is True and r["n_params"] > MIN_PARAMS[arch]


@pytest.mark.parametrize("arch,shape,mode", CELLS)
def test_records_equal_comm_debug_mode(records, arch, shape, mode):
    r = records[(arch, shape)]
    c = r["comm_debug"]
    assert c["equal"] and c["records"] == c["counts"], c
    assert c["records"] == {op: v["count"] for op, v in
                            r["collectives_by_op"].items()}


def test_the_report_renders_the_records_as_the_reference(records):
    from repro.perf import report as jreport
    from repro_torch.perf import report

    recs = list(records.values())
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
