"""The port's attention, KV caches, FFNs and MoE
(``repro_torch.models.transformer``) against the JAX reference's
(``repro.models.transformer``), block by block, on weights and inputs
drawn with numpy from a seed.

The KV quantizers must be bit-equal (int8 values, packed nibbles and bf16
scales). Float outputs are held to 1e-5 relative to the largest reference
value. Each layer is fed the reference's own input, so a quantized cache is
compared on the cache the reference wrote. The reference is compiled
(``jax.jit``) except where an int8 cache is involved: there it runs op by
op (``jax.disable_jit``), because XLA fuses ``_kv_dequant``'s bf16 product
``q.astype(bf16) * s.astype(bf16)`` into the float32 scores and skips its
rounding to bf16 (``test_compiled_reference_skips_the_int8_bf16_rounding``);
op by op it rounds, as the source says and the port does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

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
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _cfgs(arch="codeqwen1.5-7b", **kw):
    ref = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                              dtype="float32", **kw)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _params(init, cfg_r, seed=0):
    """A reference parameter dict drawn by the reference's initializer, and
    the port's copy."""
    from repro.models.layers import Initializer

    p, _ = _split(init(Initializer(jax.random.PRNGKey(seed), jnp.float32),
                       cfg_r))
    pnp = jax.tree.map(np.asarray, p)
    return p, convert.lm_params_from_jax(pnp, device="cpu")


def _split(tree):
    from repro.models.lm import split_tree

    return split_tree(tree)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


def _pos(b, t, start=0):
    p = np.broadcast_to(np.arange(start, start + t)[None], (b, t)).copy()
    return jnp.asarray(p), torch.tensor(p)


# ---------------------------------------------------------------- KV quant

def test_kv4_group_matches():
    for dh in range(2, 258, 2):
        assert TT._kv4_group(dh) == RT._kv4_group(dh)


@pytest.mark.parametrize("dh", [16, 120, 160])
@pytest.mark.parametrize("nbits", [8, 4])
def test_kv_quant_bit_equal(dh, nbits):
    xj, xt = _x((2, 9, 3, dh), seed=dh + nbits)
    # values on the rounding grid's half points and an all-zero head
    xj = xj.at[0, 0, 0].set(0.0)
    xt[0, 0, 0] = 0.0
    qr, sr = RT._kv_quant(xj, nbits)
    qt, st = TT._kv_quant(xt, nbits)
    assert qt.dtype == (torch.int8 if nbits == 8 else torch.uint8)
    assert st.dtype == torch.bfloat16 and tuple(st.shape) == sr.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sr.astype(jnp.float32)))
    for dt_r, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        dr = RT._kv_dequant(qr, sr, nbits, dtype=dt_r)
        dq = TT._kv_dequant(qt, st, nbits, dtype=dt_t)
        assert dq.dtype == dt_t
        np.testing.assert_array_equal(dq.float().numpy(),
                                      np.asarray(dr.astype(jnp.float32)))
    # the default dequantizes to bf16 whatever the model's dtype
    assert TT._kv_dequant(qt, st, nbits).dtype == torch.bfloat16


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("ring", [False, True])
def test_init_attn_cache_matches(kv_bits, ring):
    cfg_r, cfg_t = _cfgs(kv_bits=kv_bits, swa_window=8)
    cr = RT.init_attn_cache(cfg_r, 2, 24, dtype=jnp.float32, ring=ring)
    ct = TT.init_attn_cache(cfg_t, 2, 24, dtype=torch.float32, ring=ring)
    assert set(ct) == set(cr)
    for k in cr:
        assert tuple(ct[k].shape) == cr[k].shape
        assert str(ct[k].dtype).split(".")[-1] == str(cr[k].dtype)
        np.testing.assert_array_equal(ct[k].float().numpy(),
                                      np.asarray(cr[k]).astype(np.float32))


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b"])
@pytest.mark.parametrize("q_chunk", [1024, 4])
def test_self_attention_without_cache(arch, q_chunk):
    """rep 2 (GQA) and rep 1; q_chunk=4 takes the chunked path with a
    padded last chunk."""
    cfg_r, cfg_t = _cfgs(arch, n_kv_heads=2 if arch.startswith("code") else 4)
    pr, pt = _params(RT.init_attention, cfg_r)
    xj, xt = _x((2, 9, cfg_r.d_model))
    qr, qt = _pos(2, 9)
    out_r, _ = jax.jit(lambda p, x, q: RT.attention(
        p, x, cfg_r, positions=q, q_chunk=q_chunk))(pr, xj, qr)
    out_t, c = TT.attention(pt, xt, cfg_t, positions=qt, q_chunk=q_chunk)
    assert c is None and _rel(out_t, out_r) <= TOL
    # causal=False, no positions: the encoder's self-attention
    out_r, _ = jax.jit(lambda p, x: RT.attention(
        p, x, cfg_r, causal=False, q_chunk=q_chunk))(pr, xj)
    out_t, _ = TT.attention(pt, xt, cfg_t, causal=False, q_chunk=q_chunk)
    assert _rel(out_t, out_r) <= TOL


def test_swa_without_cache_and_chunked():
    cfg_r, cfg_t = _cfgs("h2o-danube-3-4b", swa_window=4)
    pr, pt = _params(RT.init_attention, cfg_r)
    xj, xt = _x((2, 11, cfg_r.d_model))
    for q_chunk in (1024, 3):
        out_r, _ = jax.jit(lambda p, x: RT.attention(
            p, x, cfg_r, q_chunk=q_chunk))(pr, xj)
        out_t, _ = TT.attention(pt, xt, cfg_t, q_chunk=q_chunk)
        assert _rel(out_t, out_r) <= TOL


def test_cross_attention_and_cross_kv():
    cfg_r, cfg_t = _cfgs("whisper-large-v3")
    pr, pt = _params(RT.init_attention, cfg_r)
    xj, xt = _x((2, 5, cfg_r.d_model))
    ej, et = _x((2, 8, cfg_r.d_model), seed=7)
    out_r, _ = RT.attention(pr, xj, cfg_r, kv_src=ej, use_rope=False,
                            causal=False)
    out_t, _ = TT.attention(pt, xt, cfg_t, kv_src=et, use_rope=False,
                            causal=False)
    assert _rel(out_t, out_r) <= TOL
    kv_r, kv_t = RT.cross_kv(pr, ej, cfg_r), TT.cross_kv(pt, et, cfg_t)
    for k in ("k", "v"):
        assert _rel(kv_t[k], kv_r[k]) <= TOL
    # cross decode: the cache holds the encoder's K/V, no kv_src
    out_r, _ = RT.attention(pr, xj[:, :1], cfg_r, cache=kv_r, use_rope=False,
                            causal=False)
    c = {k: v.clone() for k, v in kv_t.items()}
    out_t, c2 = TT.attention(pt, xt[:, :1], cfg_t, cache=c, use_rope=False,
                             causal=False)
    assert c2 is c and _rel(out_t, out_r) <= TOL


def _prefill_decode(arch, t, steps, **kw):
    """Prefill t tokens into a fresh cache, then decode ``steps`` more, the
    port fed the reference's input each time. Returns the worst error of
    the outputs and of the float cache leaves, and the count of integer
    cache words (quantized K/V and their bf16 scales, ring positions) that
    differ."""
    cfg_r, cfg_t = _cfgs(arch, **kw)
    pr, pt = _params(RT.init_attention, cfg_r)
    xj, xt = _x((2, t + steps, cfg_r.d_model))
    max_seq = t + steps + 3
    cr = RT.init_attn_cache(cfg_r, 2, max_seq, dtype=jnp.float32)
    ct = TT.init_attn_cache(cfg_t, 2, max_seq, dtype=torch.float32)
    step_r = lambda p, x, q, c, at: RT.attention(  # noqa: E731
        p, x, cfg_r, positions=q, cache=c, cache_pos=at)
    if cfg_r.kv_bits != 8:
        step_r = jax.jit(step_r)
    errs, words = [0.0], 0
    with jax.disable_jit(cfg_r.kv_bits == 8):
        for start, n in [(0, t)] + [(t + i, 1) for i in range(steps)]:
            qr, qt = _pos(2, n, start)
            out_r, cr = step_r(pr, xj[:, start:start + n], qr, cr,
                               jnp.int32(start))
            out_t, ct = TT.attention(pt, xt[:, start:start + n], cfg_t,
                                     positions=qt, cache=ct, cache_pos=start)
            errs.append(_rel(out_t, out_r))
            for k in cr:
                if cr[k].dtype == jnp.float32:
                    errs.append(_rel(ct[k], cr[k]))
                else:
                    a = np.asarray(jnp.asarray(cr[k]).astype(jnp.float32))
                    words += int((ct[k].float().numpy() != a).sum())
    return max(errs), words


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_full_cache_prefill_then_decode(kv_bits):
    err, words = _prefill_decode("codeqwen1.5-7b", 7, 3, kv_bits=kv_bits)
    assert err <= TOL
    assert words == 0  # the same quantized cache, word for word


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("t", [3, 9])
def test_swa_ring_buffer(kv_bits, t):
    """A window of 4: a prompt shorter than it, and one longer (the ring
    keeps the tail), then decode steps that wrap the ring."""
    err, words = _prefill_decode("h2o-danube-3-4b", t, 5, kv_bits=kv_bits,
                                 swa_window=4)
    assert err <= TOL
    assert words == 0


def test_compiled_reference_skips_the_int8_bf16_rounding():
    """Why the int8 cases hold the port to the reference op by op: compiled,
    the reference's dequantization feeding a float32 op keeps the product
    unrounded; op by op (and in the port) it is rounded to bf16."""
    xj, xt = _x((2, 9, 3, 16))
    q, s = RT._kv_quant(xj, 8)
    fused = jax.jit(lambda q, s: RT._kv_dequant(q, s, 8).astype(
        jnp.float32) * 1.0)(q, s)
    with jax.disable_jit():
        op_by_op = RT._kv_dequant(q, s, 8).astype(jnp.float32) * 1.0
    qt, st = TT._kv_quant(xt, 8)
    port = TT._kv_dequant(qt, st, 8).float()
    np.testing.assert_array_equal(port.numpy(), np.asarray(op_by_op))
    assert (np.asarray(fused) != np.asarray(op_by_op)).any()


def test_prefill_attn_cache_matches():
    cfg_r, cfg_t = _cfgs()
    pr, pt = _params(RT.init_attention, cfg_r)
    xj, xt = _x((2, 6, cfg_r.d_model))
    out_r, cr = jax.jit(lambda p, x: RT.prefill_attn_cache(
        p, x, cfg_r, 10, dtype=jnp.float32))(pr, xj)
    out_t, ct = TT.prefill_attn_cache(pt, xt, cfg_t, 10, dtype=torch.float32)
    assert _rel(out_t, out_r) <= TOL
    assert _rel(ct["k"], cr["k"]) <= TOL and _rel(ct["v"], cr["v"]) <= TOL


def test_full_cache_overflow_raises():
    cfg_r, cfg_t = _cfgs()
    _, pt = _params(RT.init_attention, cfg_r)
    _, xt = _x((2, 4, cfg_r.d_model))
    c = TT.init_attn_cache(cfg_t, 2, 5, dtype=torch.float32)
    with pytest.raises(ValueError, match="cannot take"):
        TT.attention(pt, xt, cfg_t, cache=c, cache_pos=3)


# ----------------------------------------------------------------- FFN, MoE

@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "whisper-large-v3",
                                  "minitron-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_swiglu_gelu_relu2(arch, dtype):
    """swiglu, gelu (jax.nn.gelu's tanh form) and squared ReLU."""
    cfg_r, cfg_t = _cfgs(arch)
    pr, pt = _params(RT.init_mlp, cfg_r)
    xj, xt = _x((2, 5, cfg_r.d_model))
    if dtype == "bfloat16":
        pr = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pr)
        pt = {k: v.to(torch.bfloat16) for k, v in pt.items()}
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    got = TT.mlp(pt, xt, cfg_t)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, RT.mlp(pr, xj, cfg_r)) <= (TOL if dtype == "float32"
                                                else 2e-2)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    got = torch.nn.functional.gelu(x, approximate="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(
        jnp.asarray(x.numpy()))), rtol=1e-6, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(x).numpy(), got.numpy(),
                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 6, 24, 64, 96, 4096])
def test_auto_groups(s):
    assert TT._auto_groups(s) == RT._auto_groups(s)


@pytest.mark.parametrize("capacity_factor", [1.25, 2.0])
@pytest.mark.parametrize("b,t", [(2, 9), (2, 1), (3, 16)])
def test_moe_matches(capacity_factor, b, t):
    """The reference's default capacity drops tokens; E/k (2.0 here) is
    dropless. Outputs are compared, not the slots ``sel`` names."""
    cfg_r, cfg_t = _cfgs("olmoe-1b-7b", capacity_factor=capacity_factor)
    pr, pt = _params(RT.init_moe, cfg_r)
    xj, xt = _x((b, t, cfg_r.d_model))
    got = TT.moe(pt, xt, cfg_t)
    assert _rel(got, jax.jit(RT.moe, static_argnums=2)(pr, xj, cfg_r)) <= TOL
    # the routing weights match slot by slot once sorted by token
    xs = (xj.reshape(1, b * t, -1), xt.reshape(1, b * t, -1))
    cap = min(max(4, int(b * t * 2 / 4 * capacity_factor)), b * t)
    sel_r, w_r, v_r = jax.jit(RT._moe_route, static_argnums=(2, 3))(
        pr, xs[0], cfg_r, cap)
    sel_t, w_t, v_t = TT._moe_route(pt, xs[1], cfg_t, cap)
    assert int(v_t.sum()) == int(np.asarray(v_r).sum())
    for e in range(cfg_r.moe_experts):
        keep_r = np.asarray(v_r[0, e])
        keep_t = v_t[0, e].numpy()
        np.testing.assert_array_equal(np.sort(np.asarray(sel_r[0, e])[keep_r]),
                                      np.sort(sel_t[0, e].numpy()[keep_t]))
