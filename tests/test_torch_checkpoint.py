"""The port's atomic checkpoints (``repro_torch.dist.checkpoint``): the
reference's own checkpoint cases (``tests/test_checkpoint.py``) on torch
trees, and checkpoints read across the two packages bit for bit.

A tree of float32, bfloat16 and int32 leaves saved by the reference is
restored by the port and the other way round: every leaf equal bit for
bit, the manifests equal, each ``.npy`` file equal byte for byte, and
``config_hash`` equal for the same configs (the port's config classes
have the reference's reprs).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.dist import checkpoint as rckpt  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import trainer as rtrainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(5.0),
                       "step": torch.tensor(3, dtype=torch.int32)}}


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_save_restore_bit_exact(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 10, t, cfg_hash="abc")
    restored, manifest = ckpt.restore(tmp_path, t, cfg_hash="abc")
    assert manifest["step"] == 10
    for a, b in zip(ckpt._leaves(t), ckpt._leaves(restored)):
        assert _equal(a, b)
    assert list(restored) == list(t) and list(restored["nested"]) == ["b",
                                                                     "step"]


def test_bf16_leaves_round_trip(tmp_path):
    t = {"p": torch.randn(4, 6).to(torch.bfloat16),
         "s": {"mu": torch.randn(3).to(torch.bfloat16)}}
    ckpt.save(tmp_path, 1, t)
    restored, m = ckpt.restore(tmp_path, t)
    assert m["dtypes"] == ["bfloat16", "bfloat16"]
    assert _equal(restored["p"], t["p"]) and _equal(restored["s"]["mu"],
                                                    t["s"]["mu"])


def test_retention_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    assert ckpt.list_steps(tmp_path) == [4, 5]
    assert ckpt.latest_step(tmp_path) == 5


def test_cfg_hash_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t, cfg_hash="aaa")
    with pytest.raises(ValueError, match="cfg_hash"):
        ckpt.restore(tmp_path, t, cfg_hash="bbb")


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(tmp_path, {"w": torch.zeros(8, 16)})
    bad = _tree()
    bad["w"] = torch.zeros(8, 15)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, bad)


def test_interrupted_write_never_corrupts(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    # a crash mid-write: a stale .tmp dir must be ignored, then removed
    tmp = tmp_path / "step_0000000002.tmp"
    tmp.mkdir()
    (tmp / "leaf_00000.npy").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1
    _, m = ckpt.restore(tmp_path, t)
    assert m["step"] == 1
    ckpt.save(tmp_path, 3, t)
    assert not tmp.exists() and ckpt.list_steps(tmp_path) == [1, 3]


def test_interrupted_resave_keeps_the_step(tmp_path):
    """A crash between a re-save's two replaces leaves step_N.old.tmp and
    no step_N: the next restore moves the old copy back."""
    t = _tree()
    ckpt.save(tmp_path, 4, t)
    (tmp_path / "step_0000000004").rename(tmp_path / "step_0000000004.old.tmp")
    restored, m = ckpt.restore(tmp_path, t)
    assert m["step"] == 4 and _equal(restored["w"], t["w"])
    ckpt.save(tmp_path, 4, _tree(1))  # a re-save replaces it whole
    assert ckpt.list_steps(tmp_path) == [4]
    assert not list(tmp_path.glob("*.tmp"))
    assert _equal(ckpt.restore(tmp_path, t)[0]["w"], _tree(1)["w"])


def test_restore_places_leaves_on_the_device(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    like = {"w": torch.empty(8, 16, device="meta"),
            "nested": {"b": np.zeros(5), "step": 0}}
    restored, _ = ckpt.restore(tmp_path, like, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert _equal(restored["nested"]["step"], t["nested"]["step"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", t)


# ------------------------------------------------------------ cross-reading

def _mixed_numpy(seed=0):
    """float32, bfloat16 and int32 leaves, as numpy (bf16 as float32)."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32),
                       "ln": rng.normal(size=(2, 4)).astype(np.float32)},
            "step": np.int32(7)}


def _jax_tree(npt):
    return ({"a": jnp.asarray(npt["a"]),
             "layers": {"w": jnp.asarray(npt["layers"]["w"], jnp.bfloat16),
                        "ln": jnp.asarray(npt["layers"]["ln"],
                                          jnp.bfloat16)}},
            {"step": jnp.asarray(npt["step"])})


def _torch_tree(npt):
    return ({"a": torch.tensor(npt["a"]),
             "layers": {"w": torch.tensor(npt["layers"]["w"]).to(torch.bfloat16),
                        "ln": torch.tensor(npt["layers"]["ln"]).to(
                            torch.bfloat16)}},
            {"step": torch.tensor(npt["step"])})


def _bits(x):
    """(shape, bytes) of a leaf, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.shape, x.tobytes()


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    npt = _mixed_numpy()
    ref = _jax_tree(npt)
    rckpt.save(tmp_path / "ref", 5, ref, cfg_hash="h")
    got, manifest = ckpt.restore(tmp_path / "ref", _torch_tree(_mixed_numpy(1)),
                                 cfg_hash="h")
    assert manifest["dtypes"] == ["float32", "bfloat16", "bfloat16", "int32"]
    assert got[0]["layers"]["w"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(ref), ckpt._leaves(got)):
        assert _bits(a) == _bits(b)


def test_port_checkpoint_restored_by_the_reference(tmp_path):
    npt = _mixed_numpy()
    tt = _torch_tree(npt)
    ckpt.save(tmp_path / "port", 5, tt, cfg_hash="h")
    got, manifest = rckpt.restore(tmp_path / "port", _jax_tree(_mixed_numpy(1)),
                                  cfg_hash="h")
    assert got[0]["layers"]["w"].dtype == jnp.bfloat16
    for a, b in zip(ckpt._leaves(tt), jax.tree.leaves(got)):
        assert _bits(a) == _bits(b)


def test_both_packages_write_the_same_files(tmp_path):
    npt = _mixed_numpy()
    rckpt.save(tmp_path / "ref", 5, _jax_tree(npt), cfg_hash="h")
    ckpt.save(tmp_path / "port", 5, _torch_tree(npt), cfg_hash="h")
    ref = _files(tmp_path / "ref" / "step_0000000005")
    port = _files(tmp_path / "port" / "step_0000000005")
    assert json.loads(ref.pop("manifest.json")) == json.loads(
        port.pop("manifest.json"))
    assert ref == port


def test_config_hashes_agree():
    for arch in ("rwkv6-1.6b", "h2o-danube-3-4b"):
        for smoke in (False, True):
            cr, ct = rconfigs.get(arch), configs.get(arch)
            if smoke:
                cr, ct = rconfigs.smoke_config(cr), configs.smoke_config(ct)
            assert repr(ct) == repr(cr)
            assert ckpt.config_hash((ct, opt.AdamWConfig(lr=3e-3,
                                                         grad_clip=1.0))) == \
                rckpt.config_hash((cr, ropt.AdamWConfig(lr=3e-3,
                                                        grad_clip=1.0)))
    gr = dataclasses.replace(rconfigs.get("qgtc-gcn"), in_dim=8, n_classes=3)
    gt = dataclasses.replace(configs.get("qgtc-gcn"), in_dim=8, n_classes=3)
    kw = dict(steps=30, lr=3e-3, path="int_bitserial", grad_bits=8)
    ocfg = dict(lr=3e-3, weight_decay=1e-4, grad_clip=1.0)
    assert ckpt.config_hash((gt, trainer.TrainConfig(**kw),
                             opt.AdamWConfig(**ocfg))) == \
        rckpt.config_hash((gr, rtrainer.TrainConfig(**kw),
                           ropt.AdamWConfig(**ocfg)))
