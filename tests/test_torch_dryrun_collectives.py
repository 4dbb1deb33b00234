"""The dry run's collective records (``perf.roofline.record_collectives``)
against torch's own count (``CommDebugMode``), and the layouts a sharded
step's gradients take, on the CPU with fake process groups (no JAX).

Each group lives in a subprocess running this file (a process has one
default group):

- ``four``, a 4-rank group: ``a @ b`` with ``a`` and ``b`` both
  ``Shard(0)`` and ``a + x`` with ``x`` ``Shard(1)`` on a 1-D mesh, where
  DTensor issues two all-gathers inside the ops' own dispatch: the
  records hold both, as ``CommDebugMode`` counts them in a run of its own,
  and the window's FLOPs are ``torch.utils.flop_counter``'s on the global
  shapes, nothing counted again for the local ops beneath. On a (2, 2)
  ``("data", "model")`` mesh a ``constrain``ed DTensor's gradient comes
  back in the constraint's placements, when the forward is the identity
  and when it redistributes (the transpose of the reference's
  ``with_sharding_constraint``), where the same product without the
  constraint hands it back in another layout.
- ``wide``, the fake 16x16 group of the dry run: small codeqwen- and
  rwkv6-family train steps whose ``d_ff`` splits over "model": their
  records equal ``CommDebugMode``'s counts op by op, and no storage they
  allocate holds the MLP's (rwkv6: the channel mix's) activation or its
  gradient at the whole ``d_ff`` (the rank's batch rows by ``d_ff``, or
  more); a small zamba2-family prefill and train step whose Mamba-2
  ``in_proj`` segments (z, x, B, C, dt) each split over "model" (131
  columns a rank, the shard boundaries inside the segments): records equal
  to ``CommDebugMode``'s, at most two all-gathers a Mamba-2 block (B and C,
  which every head shares) in its forward, and no storage at the rank's
  rows by the whole in_proj or conv width; and ``dist.sharding.write_along``
  on a sequence-sharded cache at n = t = 4096 (a slice and a ring index)
  allocates no (n, t) tensor, none larger than the source or t positions.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

# the families whose FFN width splits over "model" (rwkv6 at d_model 1024,
# where DTensor would gather the channel mix's activation rather than its
# gradient, and at a sequence whose rows by d_ff outnumber the scan's
# initial state, made at the global batch)
FFN = {"codeqwen1.5-7b": dict(d_ff=1024, vocab=512, seq=64, batch=32),
       "rwkv6-1.6b": dict(d_model=1024, d_ff=4096, vocab=512, seq=512,
                          batch=32)}
# zamba2 with in_proj's five segments split over 16: d_in 1024, ssm_state
# 16, 16 heads (2096 = 16 x 131 columns; the conv's 1056 = 16 x 66), the
# shared attention's 16 heads over "model" too
MAMBA = dict(d_model=512, ssm_state=16, n_heads=16, n_kv_heads=16, d_head=32,
             vocab=512, seq=256, batch=16)
MAMBA_KINDS = ("prefill", "train")
WRITE = dict(n=4096, batch=16, heads=1, head_dim=8)


def _dt(mesh, shape, place, grad=False):
    from torch.distributed.tensor import distribute_tensor

    t = distribute_tensor(torch.empty(shape, device="meta"), mesh, place,
                          src_data_rank=None)
    return t.requires_grad_() if grad else t


def _comm_counts(comm) -> dict:
    from repro_torch.perf import roofline

    return {roofline.op_name(op.__name__) or op.__name__: n
            for op, n in comm.get_comm_counts().items()}


def _by_op(records) -> dict:
    out: dict = {}
    for op, _, _ in records:
        out[op] = out.get(op, 0) + 1
    return out


def _on_four() -> dict:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import _mesh
    from repro_torch.perf import roofline

    out = {}
    mesh = _mesh((4,), ("model",))
    a = _dt(mesh, (8, 16), [Shard(0)])
    b = _dt(mesh, (16, 8), [Shard(0)])
    x = _dt(mesh, (8, 16), [Shard(1)])
    flops: dict = {}
    with roofline.record_collectives(flops) as recs:
        c = a @ b
        d = a + x
    comm = CommDebugMode()
    with comm:
        a @ b
        a + x
    with FlopCounterMode(display=False) as fc:
        torch.empty((8, 16)) @ torch.empty((16, 8))
        torch.empty((8, 16)) + torch.empty((8, 16))
    out["dispatch"] = {"records": recs, "comm": _comm_counts(comm),
                       "flops": flops, "global_flops": fc.get_total_flops(),
                       "out": [list(c.to_local().shape),
                               list(d.to_local().shape)]}

    mesh = _mesh((2, 2), ("data", "model"))
    rules = shd.make_rules("train")
    grads = {}
    for name, start in (("identity", [Shard(0), Replicate()]),
                        ("redistribute", [Replicate(), Replicate()])):
        for constrained in (True, False):
            x = _dt(mesh, (8, 16), start, grad=True)
            w = _dt(mesh, (16, 4), [Replicate(), Shard(0)], grad=True)
            with shd.shard_ctx(mesh, rules):
                y = shd.constrain(x, "batch", None) if constrained else x
                (y @ w).sum().backward()
            grads[f"{name}_{constrained}"] = [repr(p)
                                              for p in x.grad.placements]
    out["grads"] = grads
    out["target"] = [repr(p) for p in shd.placements(
        mesh, shd.logical_spec(mesh, rules, ("batch", None), (8, 16)))]
    return out


def _on_wide() -> dict:
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import ssm
    from repro_torch.perf import roofline

    mesh = make_production_mesh()
    seen = []
    watch = roofline.PeakMemory._watch

    def logged(self, st, nbytes, info):
        if nbytes:
            seen.append([str(info[0]), list(info[1]), nbytes
                         // info[2].itemsize])
        return watch(self, st, nbytes, info)

    block = ssm._mamba_block
    blocks = []

    def step(arch, kind, over):
        """One small step of ``arch``: its records, ``CommDebugMode``'s
        counts, its allocations, and the records of each Mamba-2 block's
        forward."""
        over = dict(over)
        shape = ShapeSpec(name=f"small_{kind}", kind=kind,
                          seq=over.pop("seq"), batch=over.pop("batch"))
        cfg = dataclasses.replace(smoke_config(configs.get(arch)), **over)
        step_fn, inputs, _ = steps.lower_cell(cfg, shape, mesh)
        seen.clear()
        blocks.clear()

        def counted(*a, **kw):
            n = len(recs)
            out = block(*a, **kw)
            blocks.append([list(r[:2]) for r in recs[n:]])
            return out

        roofline.PeakMemory._watch = logged
        ssm._mamba_block = counted
        try:
            with roofline.record_collectives(
                    memory=roofline.PeakMemory()) as recs:
                step_fn(*inputs)
        finally:
            roofline.PeakMemory._watch = watch
            ssm._mamba_block = block
        comm = CommDebugMode()
        with comm:
            step_fn(*inputs)
        return {"records": _by_op(recs), "comm": _comm_counts(comm),
                "allocations": list(seen), "blocks": list(blocks),
                "shards": {"data": shd.mesh_shape(mesh)["data"],
                           "model": shd.mesh_shape(mesh)["model"]}}

    out = {"step": {arch: step(arch, "train", over)
                    for arch, over in FFN.items()},
           "mamba": {kind: step("zamba2-7b", kind, MAMBA)
                     for kind in MAMBA_KINDS}}

    n, b = WRITE["n"], WRITE["batch"]
    rules = shd.make_rules("serve", context_parallel=True)
    kv = ("cache_batch", "cache_seq", "kv_heads", None)
    kshape = (b, n, WRITE["heads"], WRITE["head_dim"])
    place = shd.placements(mesh, shd.logical_spec(mesh, rules, kv, kshape))
    writes = {}
    for name, index in (("slice", slice(0, n)),
                        ("ring", (7 + torch.arange(n, device="meta")) % n)):
        cache = _dt(mesh, kshape, place)
        src = _dt(mesh, kshape, shd.placements(mesh, shd.logical_spec(
            mesh, shd.make_rules("serve"), ("batch", None, "kv_heads", None),
            kshape)))
        seen.clear()
        roofline.PeakMemory._watch = logged
        try:
            with torch.no_grad(), shd.sharded(mesh, rules), \
                    roofline.PeakMemory():
                shd.write_along(cache, 1, index, src)
        finally:
            roofline.PeakMemory._watch = watch
        writes[name] = {"allocations": list(seen),
                        "cache_spec": list(shd.spec_of(cache)),
                        "src_local": src.to_local().numel()}
    out["write_along"] = writes
    return out


def _main(which: str) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4 if which == "four" else 256)
    out = _on_four() if which == "four" else _on_wide()
    dist.destroy_process_group()
    print(json.dumps(out, default=list))


@pytest.fixture(scope="module")
def groups():
    procs = {w: subprocess.Popen([sys.executable, __file__, w],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for w in ("four", "wide")}
    out = {}
    for w, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[w] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_collectives_inside_a_dispatch_are_recorded(groups):
    r = groups["four"]["dispatch"]
    # a @ b: b gathered whole; a + x: x's Shard(1) moved to Shard(0), on a
    # CPU mesh an all-gather and a local chunk: each 8x16 float32
    assert [tuple(x) for x in r["records"]] == [("all-gather", 512, 4)] * 2
    assert r["comm"] == {"all-gather": 2}
    assert r["out"] == [[2, 8], [2, 16]]


def test_the_window_flops_are_the_global_ops_once(groups):
    r = groups["four"]["dispatch"]
    assert r["global_flops"] == 2 * 8 * 16 * 8
    assert r["flops"] == {"sharded": r["global_flops"], "local": 0}


@pytest.mark.parametrize("forward", ["identity", "redistribute"])
def test_a_constrained_gradient_takes_the_constraints_placements(groups,
                                                                 forward):
    r = groups["four"]
    assert r["target"] == ["Shard(dim=0)", "Replicate()"]
    assert r["grads"][f"{forward}_True"] == r["target"]
    # the same product without the constraint: DTensor's own layout
    assert r["grads"][f"{forward}_False"] != r["target"]


@pytest.mark.parametrize("arch", list(FFN))
def test_train_step_records_equal_comm_debug_mode(groups, arch):
    r = groups["wide"]["step"][arch]
    assert r["records"] and r["records"] == r["comm"], r
    assert r["records"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("arch", list(FFN))
def test_train_step_holds_no_mlp_activation_at_the_whole_ffn_width(groups,
                                                                    arch):
    r = groups["wide"]["step"][arch]
    d_ff = FFN[arch]["d_ff"]
    rows = FFN[arch]["batch"] // r["shards"]["data"] * FFN[arch]["seq"]
    assert r["allocations"]
    for op, shape, numel in r["allocations"]:
        # the rank's rows at the whole d_ff, whatever the shape DTensor
        # stages them in ((d_ff, rows) gathered, (rows * shards, d_ff /
        # shards) scattered)
        assert numel < rows * d_ff, (op, shape)
        assert d_ff not in shape, (op, shape)


def _mamba_widths():
    d_in = 2 * MAMBA["d_model"]
    n, heads = MAMBA["ssm_state"], d_in // 64
    return 2 * d_in + 2 * n + heads, d_in + 2 * n


@pytest.mark.parametrize("kind", MAMBA_KINDS)
def test_mamba2_step_records_equal_comm_debug_mode(groups, kind):
    r = groups["wide"]["mamba"][kind]
    assert r["records"] and r["records"] == r["comm"], r
    # the weight's (and the conv's) grouping by all-to-all, not a gather
    assert r["records"].get("all-to-all", 0) > 0


@pytest.mark.parametrize("kind", MAMBA_KINDS)
def test_mamba2_split_gathers_only_b_and_c(groups, kind):
    r = groups["wide"]["mamba"][kind]
    rows = MAMBA["batch"] // r["shards"]["data"] * MAMBA["seq"]
    assert r["blocks"]
    for recs in r["blocks"]:
        gathers = [b for op, b in recs if op == "all-gather"]
        # B and C, (rows, ssm_state) float32 each; the rest of in_proj's
        # product stays split
        assert gathers == [rows * MAMBA["ssm_state"] * 4] * 2, recs


@pytest.mark.parametrize("kind", MAMBA_KINDS)
def test_mamba2_step_holds_no_in_proj_product_at_the_whole_width(groups,
                                                                 kind):
    r = groups["wide"]["mamba"][kind]
    rows = MAMBA["batch"] // r["shards"]["data"] * MAMBA["seq"]
    widths = _mamba_widths()
    assert widths == (2096, 1056)
    assert r["allocations"]
    for op, shape, numel in r["allocations"]:
        # the rank's rows at the whole in_proj or conv width, gathered or
        # staged
        assert numel < rows * min(widths), (op, shape)
        assert not set(widths) & set(shape), (op, shape)


@pytest.mark.parametrize("index", ["slice", "ring"])
def test_write_along_allocates_no_n_by_t(groups, index):
    r = groups["wide"]["write_along"][index]
    n = WRITE["n"]
    assert r["cache_spec"][1] == "model"
    assert r["allocations"]
    for op, shape, numel in r["allocations"]:
        assert numel < n * n, (op, shape)
        # O(t): none larger than the source laid out as the cache (whole
        # along the sequence) or than t positions
        assert numel <= max(r["src_local"], n), (op, shape)


if __name__ == "__main__":
    _main(sys.argv[1])
