"""The port's RWKV6 and Mamba2 mixers (``repro_torch.models.ssm``) against
the JAX reference's (``repro.models.ssm``), on numpy inputs from a seed:
the GLA and SSD cores in their chunked, sequential and step forms, the
blocks and their decode steps, and the states.

Float32 throughout; results within 1e-5 relative to the largest reference
value. The reference's functions are compiled (``jax.jit``); they hold no
bf16 rounding that XLA could skip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.layers import Initializer  # noqa: E402
from repro.models.lm import split_tree  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref) -> float:
    got = np.asarray(got.float(), np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays])


def _gla_inputs(b, t, h, k, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32)
                for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, t, h, k)) * decay).astype(np.float32)
    u = rng.normal(size=(h, k)).astype(np.float32)
    s0 = rng.normal(size=(b, h, k, k)).astype(np.float32)
    return r, kk, v, lw, u, s0


def _ssd_inputs(b, t, h, p, n, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    a = -np.exp(rng.normal(size=(b, t, h)) * decay).astype(np.float32)
    B, C = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(2))
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return x, a, B, C, s0


# ------------------------------------------------------------ GLA and SSD

@pytest.mark.parametrize("t,chunk", [(16, 8), (13, 8), (8, 8), (5, 4)])
@pytest.mark.parametrize("decay", [1.0, 0.25])
def test_gla_chunked_and_sequential(t, chunk, decay):
    """T a multiple of the chunk and not (padded); log decays of the blocks'
    own scale (-exp(N(0, 1)) and weaker)."""
    j, tt = _both(*_gla_inputs(2, t, 3, 8, seed=t, decay=decay))
    o_r, s_r = jax.jit(RS.gla_chunked, static_argnums=6)(*j, chunk)
    o_t, s_t = TS.gla_chunked(*tt, chunk)
    assert _rel(o_t, o_r) <= TOL and _rel(s_t, s_r) <= TOL
    o_r, s_r = jax.jit(RS.gla_sequential)(*j)
    o_q, s_q = TS.gla_sequential(*tt)
    assert _rel(o_q, o_r) <= TOL and _rel(s_q, s_r) <= TOL
    # the port's two forms agree with each other
    assert _rel(o_t, o_q.numpy()) <= TOL and _rel(s_t, s_q.numpy()) <= TOL


@pytest.mark.parametrize("core", ["gla", "ssd"])
def test_chunked_forms_stay_finite_under_strong_decay(core):
    """Log decays to -exp(16): every exp() argument of the chunked forms is
    <= 0, so nothing overflows. (At this scale the float32 cumulative sums
    differ in their last bits between any two summation orders, so the
    outputs are held to finiteness, not to the reference.)"""
    if core == "gla":
        _, tt = _both(*_gla_inputs(2, 24, 3, 8, seed=1, decay=4.0))
        outs = TS.gla_chunked(*tt, 8)
    else:
        _, tt = _both(*_ssd_inputs(2, 24, 3, 8, 4, seed=1, decay=4.0))
        outs = TS.ssd_chunked(*tt, 8)
    assert all(torch.isfinite(o).all() for o in outs)


@pytest.mark.parametrize("t,chunk", [(16, 8), (13, 8), (8, 8), (5, 4),
                                     (100, 32)])
def test_gla_chunk_batched_form(t, chunk):
    """The per-rank form (every chunk's own work batched, only the state
    recurrence a loop): within TOL of the reference's chunked form and of
    the port's loop over the chunks."""
    j, tt = _both(*_gla_inputs(2, t, 3, 8, seed=t))
    o_r, s_r = jax.jit(RS.gla_chunked, static_argnums=6)(*j, chunk)
    o_b, s_b = TS.gla_chunks_batched(*tt, chunk)
    assert _rel(o_b, o_r) <= TOL and _rel(s_b, s_r) <= TOL
    o_t, s_t = TS.gla_chunked(*tt, chunk)
    assert _rel(o_b, o_t.numpy()) <= TOL and _rel(s_b, s_t.numpy()) <= TOL


@pytest.mark.parametrize("t,chunk", [(16, 8), (13, 8), (8, 8), (3, 4),
                                     (130, 128)])
def test_ssd_chunk_batched_form(t, chunk):
    """The per-rank form takes the single group's B, C (B, T, N), which
    every head shares (``C . B`` once for all heads): within TOL of the
    reference's chunked form on B, C broadcast to the heads and of the
    port's loop over the chunks."""
    x, a, B, C, s0 = _ssd_inputs(2, t, 3, 8, 4, seed=t)
    B, C = (np.broadcast_to(z[:, :, :1], z.shape).copy() for z in (B, C))
    j, tt = _both(x, a, B, C, s0)
    y_r, s_r = jax.jit(RS.ssd_chunked, static_argnums=5)(*j, chunk)
    grouped = [tt[0], tt[1], tt[2][:, :, 0], tt[3][:, :, 0], tt[4]]
    y_b, s_b = TS.ssd_chunks_batched(*grouped, chunk)
    assert _rel(y_b, y_r) <= TOL and _rel(s_b, s_r) <= TOL
    y_t, s_t = TS.ssd_chunked(*tt, chunk)
    assert _rel(y_b, y_t.numpy()) <= TOL and _rel(s_b, s_t.numpy()) <= TOL


def test_scans_off_a_mesh_run_the_loop_forms(monkeypatch):
    """Outside a shard context, and inside one on an ``AbstractMesh``, the
    blocks run ``gla_chunked`` / ``ssd_chunked`` as before: the per-rank
    forms are never called, and the outputs are bit-equal."""
    from repro_torch.dist import sharding as shd

    def refuse(*a, **k):
        raise AssertionError("per-rank scan off a mesh")

    monkeypatch.setattr(TS, "gla_chunks_batched", refuse)
    monkeypatch.setattr(TS, "ssd_chunks_batched", refuse)
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    for arch, init, block in (("rwkv6-1.6b", RS.init_rwkv6_block,
                               TS.rwkv6_block),
                              ("zamba2-7b", RS.init_mamba2_block,
                               TS.mamba2_block)):
        cfg_r, cfg_t = _cfgs(arch)
        _, pt = _block_params(init, cfg_r)
        x = torch.tensor(np.random.default_rng(3).normal(
            size=(2, 40, cfg_r.d_model)).astype(np.float32))
        want = block(pt, x, cfg_t, chunk=16)
        with shd.shard_ctx(mesh, shd.make_rules("train")):
            got = block(pt, x, cfg_t, chunk=16)
        assert torch.equal(got, want)


def test_gla_step():
    j, tt = _both(*_gla_inputs(2, 1, 3, 8, seed=5))
    jr = [a[:, 0] for a in j[:4]] + j[4:]
    tr = [a[:, 0] for a in tt[:4]] + tt[4:]
    o_r, s_r = jax.jit(RS.gla_step)(*jr)
    o_t, s_t = TS.gla_step(*tr)
    assert _rel(o_t, o_r) <= TOL and _rel(s_t, s_r) <= TOL


@pytest.mark.parametrize("t,chunk", [(16, 8), (13, 8), (8, 8), (3, 4)])
@pytest.mark.parametrize("decay", [1.0, 0.25])
def test_ssd_chunked_and_sequential(t, chunk, decay):
    x, a, B, C, s0 = _ssd_inputs(2, t, 3, 8, 4, seed=t, decay=decay)
    j, tt = _both(x, a, B, C, s0)
    y_r, s_r = jax.jit(RS.ssd_chunked, static_argnums=5)(*j, chunk)
    y_t, s_t = TS.ssd_chunked(*tt, chunk)
    assert _rel(y_t, y_r) <= TOL and _rel(s_t, s_r) <= TOL
    y_r, s_r = jax.jit(RS.ssd_sequential)(*j)
    y_q, s_q = TS.ssd_sequential(*tt)
    assert _rel(y_q, y_r) <= TOL and _rel(s_q, s_r) <= TOL
    assert _rel(y_t, y_q.numpy()) <= TOL and _rel(s_t, s_q.numpy()) <= TOL


def test_ssd_step():
    x, a, B, C, s0 = _ssd_inputs(2, 1, 3, 8, 4, seed=9)
    (xj, aj, bj, cj, sj), (xt, at, bt, ct, st) = _both(x, a, B, C, s0)
    y_r, s_r = jax.jit(RS.ssd_step)(xj[:, 0], aj[:, 0], bj[:, 0], cj[:, 0], sj)
    y_t, s_t = TS.ssd_step(xt[:, 0], at[:, 0], bt[:, 0], ct[:, 0], st)
    assert _rel(y_t, y_r) <= TOL and _rel(s_t, s_r) <= TOL


# ------------------------------------------------------------------ blocks

def _cfgs(arch):
    ref = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                              dtype="float32")
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _block_params(init, cfg_r, seed=0):
    """Reference block parameters, their zero/one leaves perturbed so that
    the token-shift lerps, biases and gains all act."""
    p, _ = split_tree(init(Initializer(jax.random.PRNGKey(seed), jnp.float32),
                           cfg_r))
    rng = np.random.default_rng(seed)
    pnp = {k: np.asarray(v) + (0.1 * rng.normal(size=v.shape)).astype(np.float32)
           for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in pnp.items()},
            convert.lm_params_from_jax(pnp, device="cpu"))


@pytest.mark.parametrize("t", [1, 7, 40])
def test_rwkv6_block_and_step(t):
    """t=40 spans two chunks of 32 (the second padded)."""
    cfg_r, cfg_t = _cfgs("rwkv6-1.6b")
    pr, pt = _block_params(RS.init_rwkv6_block, cfg_r)
    x = np.random.default_rng(t).normal(size=(2, t, cfg_r.d_model)).astype(
        np.float32)
    out_r = jax.jit(lambda p, x: RS.rwkv6_block(p, x, cfg_r))(pr, jnp.asarray(x))
    out_t = TS.rwkv6_block(pt, torch.tensor(x), cfg_t)
    assert _rel(out_t, out_r) <= TOL
    # the step from the reference's state
    st_r = jax.tree.map(lambda a: a + 0.3, RS.rwkv6_state(cfg_r, 2))
    st_t = {k: torch.tensor(np.asarray(v)) for k, v in st_r.items()}
    y_r, n_r = jax.jit(lambda p, x, s: RS.rwkv6_block_step(p, x, s, cfg_r))(
        pr, jnp.asarray(x[:, 0]), st_r)
    y_t, n_t = TS.rwkv6_block_step(pt, torch.tensor(x[:, 0]), st_t, cfg_t)
    assert _rel(y_t, y_r) <= TOL
    for k in n_r:
        assert _rel(n_t[k], n_r[k]) <= TOL


@pytest.mark.parametrize("t", [1, 7, 130])
def test_mamba2_block_and_step(t):
    """t=130 spans two chunks of 128 (the second padded)."""
    cfg_r, cfg_t = _cfgs("zamba2-7b")
    pr, pt = _block_params(RS.init_mamba2_block, cfg_r)
    x = np.random.default_rng(t).normal(size=(2, t, cfg_r.d_model)).astype(
        np.float32)
    out_r = jax.jit(lambda p, x: RS.mamba2_block(p, x, cfg_r))(pr, jnp.asarray(x))
    out_t = TS.mamba2_block(pt, torch.tensor(x), cfg_t)
    assert _rel(out_t, out_r) <= TOL
    st_r = jax.tree.map(lambda a: a + 0.3, RS.mamba2_state(cfg_r, 2))
    st_t = {k: torch.tensor(np.asarray(v)) for k, v in st_r.items()}
    y_r, n_r = jax.jit(lambda p, x, s: RS.mamba2_block_step(p, x, s, cfg_r))(
        pr, jnp.asarray(x[:, 0]), st_r)
    y_t, n_t = TS.mamba2_block_step(pt, torch.tensor(x[:, 0]), st_t, cfg_t)
    assert _rel(y_t, y_r) <= TOL
    for k in n_r:
        assert _rel(n_t[k], n_r[k]) <= TOL


@pytest.mark.parametrize("arch,family", [("rwkv6-1.6b", "rwkv"),
                                         ("zamba2-7b", "mamba")])
def test_block_state_continues_into_the_step(arch, family):
    """The chunked block's final state, fed to the step, gives the step's
    output for the next token: the port's prefill-then-decode invariant."""
    cfg_r, cfg_t = _cfgs(arch)
    init = RS.init_rwkv6_block if family == "rwkv" else RS.init_mamba2_block
    _, pt = _block_params(init, cfg_r)
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(2, 9, cfg_r.d_model)).astype(np.float32))
    block = TS._rwkv_block if family == "rwkv" else TS._mamba_block
    step = TS.rwkv6_block_step if family == "rwkv" else TS.mamba2_block_step
    full, _ = block(pt, x, cfg_t, 4)
    _, st = block(pt, x[:, :8], cfg_t, 4)
    y, _ = step(pt, x[:, 8], st, cfg_t)
    assert _rel(y, full[:, 8].numpy()) <= TOL


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_states_match(arch):
    cfg_r, cfg_t = _cfgs(arch)
    fr, ft = ((RS.rwkv6_state, TS.rwkv6_state) if arch.startswith("rwkv")
              else (RS.mamba2_state, TS.mamba2_state))
    sr, st = fr(cfg_r, 3), ft(cfg_t, 3, lead=(2,))
    assert set(st) == set(sr)
    for k in sr:
        assert tuple(st[k].shape) == (2,) + sr[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()
