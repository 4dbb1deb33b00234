"""Atomic filesystem checkpoints, as the reference's ``repro.dist.checkpoint``,
in its layout, so that either package reads what the other wrote.

Layout (one directory per step, written atomically):

    <dir>/step_0000000010/
        manifest.json       {"format", "step", "cfg_hash", "n_leaves",
                             "shapes", "dtypes", "mesh_shape"}
        leaf_00000.npy      the tree's leaves, in JAX's order
        leaf_00001.npy
        ...

Leaf order is JAX's ``jax.tree.leaves``: a dict's keys sorted, a tuple or
list in order, so ``(params, ostate)`` flattens as the parameters by
sorted key path, then ``mu``, ``nu`` and ``step``.

Atomicity: leaves and manifest are written into ``step_N.tmp`` and the
directory is ``os.replace``d into place as the last operation, so a crash
mid-write leaves at most a stale ``.tmp`` (ignored by readers, removed by
the next save) and never a half-valid step. A re-save of an existing step
moves the old copy to ``step_N.old.tmp`` first, and the next save or
restore moves it back if the crash came between the two replaces.

Leaves are host numpy arrays, gathered from the device. A bfloat16 leaf is
written as the reference's ``np.save`` writes an ``ml_dtypes.bfloat16``
array, 2-byte void records with the descriptor ``'<V2'``, with
``"bfloat16"`` in the manifest; it reads back through ``uint16`` and
``.view(torch.bfloat16)``, so neither side needs ``ml_dtypes``.

Sharded trees: ``save`` gathers each DTensor leaf to the whole tensor on
every rank (a collective: every rank of the mesh calls ``save``), rank 0
writes, and every rank waits for the write. ``restore(shardings=...)``
distributes each leaf onto the *new* mesh by its ``NamedSharding``, any
mesh: the reference's elastic restore. Without ``shardings`` each leaf
goes to one device (``device=``, or each leaf of ``like``'s).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from pathlib import Path

import numpy as np
import torch

__all__ = ["save", "restore", "list_steps", "latest_step", "config_hash"]

_STEP_RE = re.compile(r"step_(\d{10})$")


def _step_name(step: int) -> str:
    return f"step_{step:010d}"


def config_hash(obj) -> str:
    """Stable short hash of any repr-able config bundle (the port's configs
    have the reference's reprs, so the hashes agree)."""
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def list_steps(base) -> list[int]:
    base = Path(base)
    if not base.is_dir():
        return []
    out = []
    for d in base.iterdir():
        m = _STEP_RE.fullmatch(d.name)
        if m and d.is_dir():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(base) -> int | None:
    steps = list_steps(base)
    return steps[-1] if steps else None


def _leaves(tree) -> list:
    """JAX's leaf order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(like, it):
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, it) for t in like)
    return next(it)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _gathered(leaf):
    """A DTensor leaf as the whole tensor (a collective), else the leaf."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        return leaf.full_tensor()
    return leaf


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _write_leaf(path: Path, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    # the reference's np.save of a bfloat16 array: descriptor '<V2'
    arr = np.require(arr, requirements="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _recover_old_tmp(base: Path) -> None:
    """Finish any re-save interrupted between its two ``os.replace`` calls:
    a ``step_N.old.tmp`` is the valid step N moved aside by ``save``; if
    step N itself is missing, move the old copy back."""
    for old in base.glob("step_*.old.tmp"):
        final = base / old.name[: -len(".old.tmp")]
        if final.exists():
            shutil.rmtree(old, ignore_errors=True)  # superseded copy
        else:
            os.replace(old, final)


def save(base, step: int, tree, *, cfg_hash: str | None = None,
         keep: int | None = None, mesh_shape=None) -> Path:
    """Atomically write ``tree`` as checkpoint ``step`` under ``base``.

    keep=N      after the write, delete all but the newest N steps
    mesh_shape  recorded in the manifest (informational: the mesh the run
                was on; restore works on any mesh regardless)

    With DTensor leaves every rank calls it. The leaves are gathered one at
    a time (every rank joins each gather) and rank 0 copies each to the
    host and frees it before the next, so no rank holds more than one
    whole leaf beside its shards. Every rank then learns whether rank 0's
    write succeeded, and raises if it did not.
    """
    base = Path(base)
    final = base / _step_name(step)
    writer = _rank() == 0
    err = None
    tmp = shapes = dtypes = None
    if writer:
        try:
            tmp = _begin(base, step)
            shapes, dtypes = [], []
        except Exception as e:  # raised after the gathers
            err = e
    for i, leaf in enumerate(_leaves(tree)):
        full = _gathered(leaf)
        if writer and err is None:
            try:
                name = _dtype_name(full)
                arr = _to_numpy(full)
                shapes.append(list(arr.shape))
                dtypes.append(name)
                _write_leaf(tmp / f"leaf_{i:05d}.npy", arr, name)
            except Exception as e:  # raised below
                err = e
        del full
    if writer and err is None:
        try:
            _commit(base, step, tmp, shapes, dtypes, cfg_hash, keep,
                    mesh_shape)
        except Exception as e:  # raised below
            err = e
    failed = _writer_failed(err is not None)
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"checkpoint step {step} under {base}: rank 0's "
                           f"write failed")
    return final


def _writer_failed(failed: bool) -> bool:
    """Rank 0's ``failed``, on every rank (the identity in one process)."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return failed
    flag = [failed]
    dist.broadcast_object_list(flag, src=0)
    return bool(flag[0])


def _begin(base: Path, step: int) -> Path:
    """A fresh ``step_N.tmp`` directory, after clearing crash leftovers."""
    base.mkdir(parents=True, exist_ok=True)
    _recover_old_tmp(base)
    for stale in base.glob("step_*.tmp"):  # crash leftovers of earlier runs
        if not stale.name.endswith(".old.tmp"):
            shutil.rmtree(stale, ignore_errors=True)
    tmp = base / (_step_name(step) + ".tmp")
    tmp.mkdir()
    return tmp


def _commit(base: Path, step: int, tmp: Path, shapes, dtypes, cfg_hash,
            keep, mesh_shape) -> None:
    """Write the manifest into ``tmp`` and move it into place."""
    manifest = {
        "format": 1,
        "step": int(step),
        "cfg_hash": cfg_hash,
        "n_leaves": len(shapes),
        "shapes": shapes,
        "dtypes": dtypes,
        "mesh_shape": dict(mesh_shape) if mesh_shape is not None else None,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))

    final = base / _step_name(step)
    old = None
    if final.exists():  # a re-save of the same step: move the valid copy
        # aside, so a crash between the two replaces never loses the step
        old = base / (_step_name(step) + ".old.tmp")
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)

    if keep is not None:
        for s in list_steps(base)[:-keep]:
            shutil.rmtree(base / _step_name(s), ignore_errors=True)


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16":  # void records ('|V2' / '<V2') or uint16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(dtype_name))


def restore(base, like, *, cfg_hash: str | None = None,
            step: int | None = None, device=None, shardings=None):
    """Load checkpoint ``step`` (default: the latest) in the structure of
    ``like``. Returns ``(tree, manifest)``.

    Checks ``cfg_hash`` (when both sides have one), the leaf count and
    every shape against ``like`` before reading a leaf. Each leaf goes to
    ``device``, or, with None, to the device of ``like``'s leaf in its
    place (the CPU where that is not a tensor). With ``shardings`` (a tree
    of ``dist.sharding.NamedSharding`` in the structure of ``like``), each
    leaf is distributed onto its mesh instead, whatever mesh wrote it.
    """
    base = Path(base)
    if base.is_dir():
        _recover_old_tmp(base)  # finish any interrupted re-save first
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base}")
    d = base / _step_name(step)
    manifest = json.loads((d / "manifest.json").read_text())

    if cfg_hash is not None and manifest.get("cfg_hash") is not None \
            and manifest["cfg_hash"] != cfg_hash:
        raise ValueError(
            f"cfg_hash mismatch: checkpoint has {manifest['cfg_hash']!r}, "
            f"caller expects {cfg_hash!r}: refusing to restore")

    flat = _leaves(like)
    if manifest["n_leaves"] != len(flat):
        raise ValueError(
            f"leaf count mismatch: checkpoint has {manifest['n_leaves']} "
            f"leaves, restore target has {len(flat)}")
    for i, (leaf, shape) in enumerate(zip(flat, manifest["shapes"])):
        if hasattr(leaf, "shape") and list(leaf.shape) != list(shape):
            raise ValueError(
                f"shape mismatch at leaf_{i:05d}: checkpoint has {shape}, "
                f"restore target has {list(leaf.shape)}")

    shs = None if shardings is None else _leaves(shardings)
    loaded = []
    for i, (leaf, name) in enumerate(zip(flat, manifest["dtypes"])):
        t = _to_torch(np.load(d / f"leaf_{i:05d}.npy"), name)
        if shs is not None:
            mesh = shs[i].mesh
            loaded.append(shs[i].distribute(t.to(mesh.device_type)))
            continue
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        loaded.append(t.to(dev))
    return _unflatten(like, iter(loaded)), manifest
