"""The port's LM configs, shared layers, analytic cost model and synthetic
data against the JAX reference (``repro.configs``, ``repro.models.layers``,
``repro.perf.kernel_cost``, ``repro.train.data``), on numpy inputs from a
seed.

Configs and the cost model are pure Python over the same dataclass, so they
must be equal. The layers hold float32 results within 1e-6 relative to the
largest reference value (one float32 rounding apart at most), and bf16
results within one bf16 step. The data stream is the port's own draw: its
dialects, recurrence and purity are checked, not the reference's tokens.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.perf import kernel_cost as rkc  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.perf import kernel_cost  # noqa: E402
from repro_torch.train import data  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------- configs

def test_arch_list_matches_the_reference():
    assert configs.ARCHS == rconfigs.ARCHS


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_config_equal_full_and_smoke(arch):
    full, ref = configs.get(arch), rconfigs.get(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(configs.smoke_config(full))
            == dataclasses.asdict(rconfigs.smoke_config(ref)))
    for prop in ("head_dim", "padded_vocab", "attention_free", "sub_quadratic"):
        assert getattr(full, prop) == getattr(ref, prop)


def test_shapes_and_supports_match():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    for arch in rconfigs.ARCHS:
        for name in rconfigs.SHAPES:
            assert configs.supports(configs.get(arch), configs.SHAPES[name]) == \
                rconfigs.supports(rconfigs.get(arch), rconfigs.SHAPES[name])


@pytest.mark.parametrize("name", ["qgtc-gcn", "qgtc-gin"])
def test_get_still_resolves_the_gnn_configs(name):
    got = configs.get(name)
    assert isinstance(got, gnn.GNNConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(rconfigs.get(name))


def test_get_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")


# -------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, wj, bj = (jnp.asarray(a, jdt) for a in (x, w, b))
    xt, wt, bt = (torch.tensor(a).to(tdt) for a in (x, w, b))
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    got = TL.rms_norm(xt, wt)
    assert got.dtype == tdt
    assert _rel(got.float(), _np(RL.rms_norm(xj, wj))) <= tol
    got = TL.layer_norm(xt, wt, bt)
    assert got.dtype == tdt
    assert _rel(got.float(), _np(RL.layer_norm(xj, wj, bj))) <= tol


@pytest.mark.parametrize("cos_rank", [2, 3])
def test_rope_and_apply_rope_match(cos_rank):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) if cos_rank == 2 else \
        np.stack([np.arange(7), np.arange(7) + 30])
    cr, sr = RL.rope(jnp.asarray(pos), 16, 1e4)
    ct, st = TL.rope(torch.tensor(pos), 16, 1e4)
    assert _rel(ct, cr) <= 1e-6 and _rel(st, sr) <= 1e-6
    got = TL.apply_rope(torch.tensor(x), ct, st)
    assert _rel(got, RL.apply_rope(jnp.asarray(x), cr, sr)) <= 1e-6


def test_dense_and_cross_entropy_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    y = TL.dense(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    yr = RL.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert _rel(y, yr) <= 1e-6
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[0, :2] = -1  # padding
    for z in (0.0, 1e-4):
        lt, nt = TL.cross_entropy(y, torch.tensor(labels), z_loss=z)
        lr, nr = RL.cross_entropy(yr, jnp.asarray(labels), z_loss=z)
        assert int(nt) == int(nr) == 8
        assert abs(float(lt) - float(lr)) <= 1e-6 * abs(float(lr))


def test_initializer_scales_axes_and_meta():
    gen = torch.Generator().manual_seed(0)
    ini = TL.Initializer(gen, dtype=torch.float32, lead=(3,))
    w, ax = ini.normal((256, 512), ("embed", "mlp"))
    assert w.shape == (3, 256, 512) and ax == ("embed", "mlp")
    assert abs(float(w.std()) - 1 / math.sqrt(256)) < 0.01 / math.sqrt(256)
    v, _ = ini.normal((4096,), ("embed",), scale=0.5)
    assert abs(float(v.std()) - 0.5) < 0.02
    o, ax = ini.ones((8,), ("norm",))
    assert torch.equal(o, torch.ones(3, 8)) and ax == ("norm",)
    meta = TL.Initializer(None, dtype=torch.bfloat16, device="meta")
    m, _ = meta.normal((4, 4), (None, None), dtype=torch.float32)
    assert m.device.type == "meta" and m.dtype == torch.float32


# ---------------------------------------------------------------- kernel_cost

@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_kernel_cost_equal_for_every_shape(arch):
    cfg, ref = configs.get(arch), rconfigs.get(arch)
    assert kernel_cost.matmul_param_counts(cfg) == rkc.matmul_param_counts(ref)
    for name in rconfigs.SHAPES:
        shape, rshape = configs.SHAPES[name], rconfigs.SHAPES[name]
        assert kernel_cost.scan_trip_counts(cfg, shape) == \
            rkc.scan_trip_counts(ref, rshape)
        for kv_bits in (0, 8, 4):
            c = dataclasses.replace(cfg, kv_bits=kv_bits)
            r = dataclasses.replace(ref, kv_bits=kv_bits)
            for n_dev in (1, 16, 256):
                total = rkc.matmul_param_counts(r)["total"]
                assert kernel_cost.analytic_cost(c, shape, n_dev, total).as_dict() \
                    == rkc.analytic_cost(r, rshape, n_dev, total).as_dict()


# ---------------------------------------------------------------------- data

def test_synthetic_batch_is_pure_in_seed_and_step():
    a = data.synthetic_batch(7, 123, batch=4, seq=32, vocab=65536, device="cpu")
    b = data.synthetic_batch(7, 123, batch=4, seq=32, vocab=65536, device="cpu")
    c = data.synthetic_batch(7, 124, batch=4, seq=32, vocab=65536, device="cpu")
    d = data.synthetic_batch(8, 123, batch=4, seq=32, vocab=65536, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    assert a[0].dtype == a[1].dtype == torch.int32
    assert a[0].shape == a[1].shape == (4, 32)


@pytest.mark.parametrize("vocab", [512, 100])
def test_synthetic_batch_follows_one_dialect_per_row(vocab):
    toks, labels = data.synthetic_batch(0, 3, batch=64, seq=24, vocab=vocab,
                                        device="cpu")
    toks, labels = toks.numpy().astype(np.int64), labels.numpy().astype(np.int64)
    v = min(vocab, 256)
    # labels are the next-token shift of the recurrence
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    assert toks.min() >= 0 and toks.max() < v
    dialects = list(zip(data._DIALECTS_A, data._DIALECTS_C))
    used = set()
    for row_t, row_l in zip(toks, labels):
        fits = [(a, c) for a, c in dialects
                if np.array_equal((a * row_t + c) % v, row_l)]
        assert len(fits) >= 1
        used.add(fits[0])
    assert len(used) > 1


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-large-v3",
                                  "rwkv6-1.6b"])
def test_batch_for_arch_stub_modalities(arch):
    cfg = configs.smoke_config(configs.get(arch))
    b1 = data.batch_for_arch(cfg, 0, 5, 2, 16, device="cpu")
    b2 = data.batch_for_arch(cfg, 0, 5, 2, 16, device="cpu")
    keys = {"tokens", "labels"}
    if cfg.family == "vlm":
        keys.add("patches")
        assert b1["patches"].shape == (2, cfg.n_patches, cfg.d_model)
    if cfg.family == "audio_encdec":
        keys.add("frames")
        assert b1["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    assert set(b1) == keys
    for k in keys:
        assert torch.equal(b1[k], b2[k])
        if k in ("patches", "frames"):
            assert b1[k].dtype == torch.bfloat16
            assert 0.05 < float(b1[k].float().std()) < 0.2
