"""Multi-pod dry run: build and run one step of every (arch x shape x mesh)
cell on the production mesh without data, as the reference's
``repro.launch.dryrun``.

Where the reference lowers and compiles each cell through XLA on 512 fake
host devices, the port runs the cell's step once on a ``fake`` process
group of 256 (16x16) or 512 (2x16x16) ranks, with DTensor parameters,
optimizer state, batch and cache on the ``meta`` device: every op computes
its local shard's shape and every redistribution issues its collective,
recorded as it goes (``perf.roofline.record_collectives``): the explicit
ones and those DTensor issues inside an op's own dispatch, every
collective the step issues, as XLA's post-SPMD HLO holds every one the
reference counts (``--comm-debug`` checks the records against torch's
``CommDebugMode``). The fake group lives in a subprocess of its own, so it
never shares a default group with a real one.

For each cell we record, under the reference's keys:
  - status: OK, SKIP (``configs.base.supports``) or FAIL with the error (an
    op DTensor cannot shard, as the reference records a compile failure)
  - memory: per-device argument bytes from the local shard shapes, and the
    parameter bytes among them; the step's peak, measured on rank 0 by
    ``perf.roofline.PeakMemory`` in the same run as the collectives: every
    storage an op allocates (a DTensor's local shard, DTensor's own
    redistributions included) from its birth to its death, meta storages
    holding no data but their sizes. ``temp_bytes`` is that in-step peak
    less the step's new outputs (output less alias bytes), so that the
    reference's ``peak_bytes_est = argument + output + temp - alias`` is
    the argument bytes plus the in-step peak (plus, for a prefill, the
    cache that ``lower_cell`` makes before the step); ``peak_top`` the
    largest storages live at the peak. Not measured: what a kernel
    allocates and frees inside itself beyond the H100 scratch that
    ``PeakMemory`` models (a cuBLAS workspace), what the card's allocator
    adds in rounding, and the other ranks of an uneven split (rank 0 holds
    the largest shard)
  - cost_hlo_raw: the step's FLOPs per device by ``torch.utils.flop_counter``'s
    formulas (no HLO here): the DTensor ops' on their global shapes over
    the device count, plus the per-rank functions' (``shard_map``: the
    attention core, the scans, the expert dispatch) on one rank's shards
  - collectives by op from the recorded records (every layer runs once, so
    the trip multipliers are 1; ``scan_trips`` keeps the reference's);
    with ``--comm-debug``, ``comm_debug``: ``CommDebugMode``'s counts by
    op beside the records', and whether they are equal
  - the analytic cost (``perf.kernel_cost``), the three roofline terms on
    the H100's rates, the bottleneck, MODEL_FLOPS, and ``fits_hbm``: the
    measured peak against the card's 80 GB

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun  # 40 cells
  python -m repro_torch.launch.dryrun --all --multi-pod           # 512 ranks

``--save-hlo PATH`` writes the cell's collective records, one per line (the
port has no HLO text). ``--cell-timeout S`` records a cell whose step runs
past S seconds as FAIL: DTensor's sharding propagation plans every distinct
(op, input placements) once, and on the 3-D multi-pod mesh that planning can
take many minutes on a CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import traceback

__all__ = ["run_cell", "main"]


def _leaves(tree):
    """The local shards (DTensors) or whole tensors of a tree of dicts,
    tuples and lists."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "element_size"):
        yield tree.to_local() if isinstance(tree, DTensor) else tree


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _comm_counts(comm, records) -> dict:
    """``CommDebugMode``'s counts and the records' by op (the roofline's op
    names; a c10d op it counts that has none keeps its own), and whether
    they are equal."""
    from repro_torch.perf import roofline

    debug: dict = {}
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op))
        name = roofline.op_name(name) or name
        debug[name] = debug.get(name, 0) + n
    recorded: dict = {}
    for op, _, _ in records:
        recorded[op] = recorded.get(op, 0) + 1
    return {"counts": debug, "records": recorded, "equal": debug == recorded}


def _out_of_time(signum, frame):
    raise TimeoutError("the step did not finish in its time budget "
                       "(--cell-timeout)")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             q_chunk: int = 1024, t_chunk: int = 512,
             save_hlo: str | None = None, zero3: bool = False,
             kv_bits: int = 0, n_micro: int = 1,
             timeout_s: int = 0, comm_debug: bool = False) -> dict:
    """One cell on the default (fake) process group's production mesh.

    ``timeout_s`` > 0 bounds the step's run (main thread only): past it the
    cell is recorded FAIL with a ``TimeoutError`` and where it stood.
    ``comm_debug`` also runs the step under torch's ``CommDebugMode``
    (below the recorder, so it sees the same dispatches) and records its
    counts by op beside the records' (``comm_debug``).
    """
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs
    from repro_torch.configs.base import SHAPES, supports
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh, mesh_info
    from repro_torch.perf import kernel_cost, roofline

    cfg = configs.get(arch)
    if kv_bits:
        cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind, "zero3": zero3, "kv_bits": kv_bits,
           "n_micro": n_micro}
    ok, reason = supports(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    rec["mesh_info"] = mesh_info(mesh)
    t0 = time.time()
    try:
        step_fn, inputs, meta = steps.lower_cell(
            cfg, shape, mesh, q_chunk=q_chunk, t_chunk=t_chunk, zero3=zero3,
            n_micro=n_micro)
        rec["lower_s"] = round(time.time() - t0, 2)
        arg_bytes = _local_bytes(inputs)
        param_bytes = _local_bytes(inputs[0])
        arg_storages = {t.untyped_storage()._cdata for t in _leaves(inputs)}
        t1 = time.time()
        if timeout_s:
            signal.signal(signal.SIGALRM, _out_of_time)
            signal.alarm(timeout_s)
        flops: dict = {}
        peak = roofline.PeakMemory()
        comm = CommDebugMode() if comm_debug else None
        try:
            with comm or contextlib.nullcontext(), \
                    roofline.record_collectives(flops, memory=peak) as recs:
                out = step_fn(*inputs)
        finally:
            if timeout_s:
                signal.alarm(0)
        rec["compile_s"] = round(time.time() - t1, 2)
        rec["n_params"] = meta["n_params"]
    except Exception as e:
        # the frames of the port (where the op came from) and the last one
        frames = traceback.extract_tb(e.__traceback__)
        ours = [f for f in frames if "repro_torch" in f.filename]
        rec.update(status="FAIL", error=repr(e),
                   traceback="".join(traceback.format_list(
                       ours + frames[-1:]))[-2000:])
        return rec

    # the train step updates params and ostate in place (the reference's
    # donation): they are aliased, and only the metrics are new
    if shape.kind == "train":
        alias = _local_bytes(inputs[:2])
        out_bytes = alias + _local_bytes(out[2])
    elif shape.kind == "decode":
        alias = _local_bytes(inputs[1])
        out_bytes = _local_bytes(out)
    else:
        alias = 0
        out_bytes = _local_bytes(out)
    # the in-step peak holds the step's new outputs (the aliased trees are
    # updated in place): the rest of it is the reference's temporaries.
    # An output resident before the step that is no argument (the prefill's
    # cache, which lower_cell makes and the reference's prefill makes
    # inside its step) is resident beside the peak.
    resident_out = sum(
        t.numel() * t.element_size() for t in _leaves(out)
        if not peak.born(t) and t.untyped_storage()._cdata not in arg_storages)
    temp = peak.peak_bytes + resident_out - (out_bytes - alias)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": temp, "alias_bytes": alias,
           "param_bytes": param_bytes,
           "peak_bytes_est": arg_bytes + out_bytes + temp - alias,
           "peak_top": peak.top()}
    cost = {"flops": flops["sharded"] / n_dev + float(flops["local"]),
            "bytes_accessed": 0.0, "raw_keys": ["flops"],
            "note": "torch.utils.flop_counter's formulas: DTensor ops on "
                    "their global shapes over the device count, per-rank "
                    "functions' ops on one rank's shards"}
    trips = kernel_cost.scan_trip_counts(cfg, shape, q_chunk=q_chunk,
                                         t_chunk=t_chunk)
    trips["micro_scan"] = n_micro
    coll = roofline.collective_bytes(recs)
    if comm is not None:
        rec["comm_debug"] = _comm_counts(comm, recs)
    if save_hlo:
        pathlib.Path(save_hlo).write_text(
            "\n".join(f"{op} {size} {g}" for op, size, g in recs) + "\n")
    rec["hlo_lines"] = 0

    n_tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    counts = kernel_cost.matmul_param_counts(cfg)
    mf = roofline.model_flops(meta["n_params"], n_tokens,
                              kind="train" if shape.kind == "train" else "fwd",
                              n_active_params=counts["active"])
    ana = kernel_cost.analytic_cost(cfg, shape, n_dev, meta["n_params"] * 2)
    rep = roofline.roofline_terms(
        ana.flops_per_device, ana.hbm_bytes_per_device,
        coll["total_effective_bytes"], n_devices=n_dev, model_flops_total=mf,
        collective_s=coll["link_s"])
    rec.update(
        status="OK",
        memory=mem,
        cost_hlo_raw=cost,
        analytic=ana.as_dict(),
        scan_trips=trips,
        collectives={k: v for k, v in coll.items() if k != "by_op"},
        collectives_raw_effective=coll["total_effective_bytes"],
        collectives_by_op=coll["by_op"],
        roofline=rep.as_dict(),
        fits_hbm=bool(mem["peak_bytes_est"] < roofline.HW["hbm_bytes"]),
        hbm_bytes=roofline.HW["hbm_bytes"],
        tokens_per_call=n_tokens,
    )
    return rec


def _cell_name(tag: str, arch: str, shape: str, multi_pod: bool) -> str:
    tag = f"{tag}__" if tag else ""
    return f"{tag}{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}.json"


def _worker(args, cells) -> None:
    """Run ``cells`` on one production mesh, in this process: a fake group
    of 256 or 512 ranks."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.set_num_threads(1)
    mp = args.multi_pod
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if mp else 256)
    out_dir = pathlib.Path(args.out)
    for arch, shape in cells:
        rec = run_cell(arch, shape, multi_pod=mp, q_chunk=args.q_chunk,
                       t_chunk=args.t_chunk, save_hlo=args.save_hlo,
                       zero3=args.zero3, kv_bits=args.kv_bits,
                       n_micro=args.n_micro, timeout_s=args.cell_timeout,
                       comm_debug=args.comm_debug)
        (out_dir / _cell_name(args.tag, arch, shape, mp)).write_text(
            json.dumps(rec, indent=1))
        status = rec["status"]
        if status == "OK":
            r = rec["roofline"]
            extra = (f"bottleneck={r['bottleneck']} "
                     f"c={r['compute_s']:.3e}s m={r['memory_s']:.3e}s "
                     f"k={r['collective_s']:.3e}s "
                     f"peak={rec['memory']['peak_bytes_est'] / 1e9:.2f}GB "
                     f"fits_hbm={rec['fits_hbm']}")
            if "comm_debug" in rec:
                extra += f" comm_debug_equal={rec['comm_debug']['equal']}"
        elif status == "SKIP":
            extra = rec["reason"]
        else:
            extra = rec.get("error", "")[:200]
        print(f"[{status}] {arch} x {shape} x "
              f"{'2x16x16' if mp else '16x16'}: {extra}", flush=True)
    dist.destroy_process_group()


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--t-chunk", type=int, default=512)
    ap.add_argument("--save-hlo", default=None)
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--cell-timeout", type=int, default=0,
                    help="seconds a cell's step may run before it is "
                         "recorded FAIL (0: no bound)")
    ap.add_argument("--comm-debug", action="store_true",
                    help="also count each cell's collectives with torch's "
                         "CommDebugMode and record both counts")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES

    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in configs.ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    if args.worker:
        _worker(args, cells)
        return 0
    # one subprocess per mesh: a fake group must not share the process
    # with a real one, and a group's world size is fixed
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    argv = [a for a in (sys.argv[1:] if argv is None else argv)
            if a not in ("--multi-pod", "--both-meshes")]
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    rc = 0
    for mp in meshes:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--worker",
               *argv, *(["--multi-pod"] if mp else [])]
        rc = max(rc, subprocess.run(cmd, env=env).returncode)
    return rc


if __name__ == "__main__":
    sys.exit(main())
