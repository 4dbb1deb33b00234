"""``launch/train.py --model-parallel 2`` on 2 gloo ranks (a (1, 2)
``("data", "model")`` mesh), on the CPU; no JAX.

Both ranks run, in one spawned session (a ``file://`` rendezvous in
``tmp_path``, one torch thread a rank, a join timeout of 120 s):

  A   4 steps uninterrupted, a checkpoint every 2;
  B   the same command with ``--simulate-failure-at 1`` (exit code 17 on
      both ranks after step 1), then again: it resumes from step 2;
  C   a resume of a checkpoint saved at ``--model-parallel 1`` by one
      process (this one), at step 2, with ``--steps 2``: it restores and
      saves step 2 again;
  D   3 steps with ``--grad-compress-bits 8``, against the same run in one
      process (this one): every loss within 1e-3 relative. The smoke
      config computes in bf16, whose sums round apart when sharded (the
      losses of step 0, before any update, are 1.6e-4 apart). That the
      sharded quantization equals the unsharded one exactly is
      ``test_torch_dist_ranks``'s check;
  E   ``dist.checkpoint.save`` of a sharded tree whose write fails on rank
      0 (its directory is a file): every rank raises, none returns.

B's step-4 checkpoint must equal A's byte for byte (leaves and dtypes), and
C's re-saved step 2 the single-process one's: the elastic restore
distributes each leaf onto the new mesh and the save gathers it back.
"""
import json
import multiprocessing
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 2
TIMEOUT_S = 120
LM = ["--arch", "codeqwen1.5-7b", "--smoke", "--device", "cpu", "--batch",
      "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]
COMPRESSED = ["--steps", "3", "--grad-compress-bits", "8"]


def _rank_main(rank, store_dir, runs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/rdv",
                            rank=rank, world_size=WORLD)
    from repro_torch.launch import train

    out = []
    for argv in runs:
        try:
            res = train.main(argv)
            out.append({"code": 0, "history": res["history"],
                        "mesh_shape": res["mesh_shape"]})
        except SystemExit as e:
            out.append({"code": e.code})
    out.append(_failed_save(store_dir))
    (pathlib.Path(store_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _failed_save(store_dir) -> str:
    """Save a sharded tree under a path that is a file: the name of the
    exception this rank raised, or "returned"."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(model=WORLD, device="cpu")
    x = shd.NamedSharding(mesh, shd.pspec(None, "model")).distribute(
        torch.arange(8.0).reshape(2, 4))
    blocker = pathlib.Path(store_dir) / "not_a_dir"
    blocker.touch()
    try:
        ckpt.save(blocker, 1, {"x": x})
    except Exception as e:  # the test reads which rank raised what
        return type(e).__name__
    return "returned"


def _leaves(step_dir: pathlib.Path) -> dict:
    return {p.name: np.load(p) for p in sorted(step_dir.glob("leaf_*.npy"))}


def _same_checkpoint(a: pathlib.Path, b: pathlib.Path) -> None:
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    for k in ("step", "cfg_hash", "n_leaves", "shapes", "dtypes"):
        assert ma[k] == mb[k], k
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].tobytes() == lb[k].tobytes(), k


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    from repro_torch.launch import train

    root = tmp_path_factory.mktemp("mp2")
    dirs = {k: root / k for k in ("A", "B", "C")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:  # C's checkpoint, saved by one process at --model-parallel 1
        train.main(LM + ["--steps", "2", "--ckpt-dir", str(dirs["C"])])
        compressed = train.main(LM + COMPRESSED)["history"]
    finally:
        torch.set_num_threads(threads)
    single = root / "C_single"
    shutil.copytree(dirs["C"] / "step_0000000002", single)
    mp2 = ["--model-parallel", "2"]
    runs = [LM + mp2 + ["--steps", "4", "--ckpt-dir", str(dirs["A"])],
            LM + mp2 + ["--steps", "4", "--ckpt-dir", str(dirs["B"]),
                        "--simulate-failure-at", "1"],
            LM + mp2 + ["--steps", "4", "--ckpt-dir", str(dirs["B"])],
            LM + mp2 + ["--steps", "2", "--ckpt-dir", str(dirs["C"])],
            LM + mp2 + COMPRESSED]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(root), runs))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    got = [json.loads((root / f"rank{r}.json").read_text())
           for r in range(WORLD)]
    return got, dirs, single, compressed


def test_both_ranks_train_on_a_1_by_2_mesh(session):
    got, _, _, _ = session
    for rank in range(WORLD):
        a = got[rank][0]
        assert a["code"] == 0 and a["mesh_shape"] == {"data": 1, "model": 2}
        assert [h["step"] for h in a["history"]] == [0, 1, 2, 3]
        assert all(0.0 < h["loss"] < 10 for h in a["history"])
    assert got[0][0]["history"][-1]["loss"] == got[1][0]["history"][-1]["loss"]


def test_a_failed_run_resumes_bit_equal(session):
    got, dirs, _, _ = session
    for rank in range(WORLD):
        assert got[rank][1]["code"] == 17
        b = got[rank][2]
        assert b["code"] == 0 and [h["step"] for h in b["history"]] == [2, 3]
    _same_checkpoint(dirs["A"] / "step_0000000004",
                     dirs["B"] / "step_0000000004")
    manifest = json.loads((dirs["B"] / "step_0000000004" / "manifest.json")
                          .read_text())
    assert manifest["mesh_shape"] == {"data": 1, "model": 2}


def test_a_single_process_checkpoint_restores_on_the_mesh(session):
    got, dirs, single, _ = session
    for rank in range(WORLD):
        assert got[rank][3] == {"code": 0, "history": [],
                                "mesh_shape": {"data": 1, "model": 2}}
    _same_checkpoint(single, dirs["C"] / "step_0000000002")


def test_compressed_gradients_train_on_the_mesh(session):
    got, _, _, want = session
    assert [h["step"] for h in want] == [0, 1, 2]
    for rank in range(WORLD):
        d = got[rank][4]
        assert d["code"] == 0 and d["mesh_shape"] == {"data": 1, "model": 2}
        assert [h["step"] for h in d["history"]] == [0, 1, 2]
        for a, b in zip(d["history"], want):
            assert abs(a["loss"] - b["loss"]) <= 1e-3 * abs(b["loss"])


def test_a_failed_write_raises_on_every_rank(session):
    got, _, _, _ = session
    assert got[0][5] in ("FileExistsError", "NotADirectoryError")
    assert got[1][5] == "RuntimeError"
