"""The port's LM trees against the JAX reference's, and the decode caches
that differ from the plain path: every parameter leaf's key path, shape,
dtype and logical axes at the ten full configs (the port's ``init_lm`` on
the ``meta`` device against ``jax.eval_shape`` of the reference's), the
decode caches and input specs the same way, then prefill + teacher-forced
decode with int8 and int4 KV caches, a sliding window shorter than the
prompt, and bf16 weights (those two in ``test_torch_lm_window.py``).

Tolerances, relative to the largest reference value: 1e-4 in float32;
2e-2 in bf16 (one bf16 step is 2**-8; a few layers of bf16 roundings in
another order). The int8 cases hold the port to the reference op by op
(``jax.disable_jit``): compiled, the reference fuses ``_kv_dequant``'s
bf16 product into the float32 scores and skips its rounding (on these
inputs its own compiled and op-by-op decode differ by 9e-3), while the
source, its op-by-op run and the port round it. An int8 level is 1/127 of
a head's largest value, so float inputs one rounding apart can land on
either side of a level's edge; on olmoe's smoke config one word of the
second layer's prompt K moves (38 against 39), and the logits 6.8e-4
after it: the MoE family runs here at 4 bits, where no level moves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, T, PROMPT, STEPS = 2, 17, 13, 4


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


def _flat(tree, prefix=""):
    """{keystr-like path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _axes_paths(axes):
    """{keystr path: axes tuple} of a reference axes tree."""
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(
                axes, is_leaf=lambda x: isinstance(x, tuple))[0]}


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


# --------------------------------------------------------------------- trees

@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_init_tree_matches_at_full_width(arch):
    cfg_r, cfg_t = rconfigs.get(arch), configs.get(arch)
    seen = {}

    def init():
        p, a = rlm.init_lm(jax.random.PRNGKey(0), cfg_r)
        seen["axes"] = a
        return p

    shapes = jax.eval_shape(init)
    params, axes = lm.init_lm(cfg_t, device="meta")
    ref_leaves = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = _flat(params)
    assert set(got) == set(ref_leaves)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == ref_leaves[path].shape, path
        assert _dtype_name(leaf) == str(ref_leaves[path].dtype), path
    assert _flat(axes) == _axes_paths(seen["axes"])
    assert lm.param_count(params) == rlm.param_count(shapes)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_decode_cache_and_input_specs_match(arch, kv_bits):
    cfg_r = dataclasses.replace(rconfigs.get(arch), kv_bits=kv_bits)
    cfg_t = configs.ModelConfig(**dataclasses.asdict(cfg_r))
    seen = {}

    def init():
        c, a = rlm.init_decode_cache(cfg_r, 4, 1024)
        seen["axes"] = a
        return c

    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(jax.eval_shape(init))[0]}
    cache, axes = lm.init_decode_cache(cfg_t, 4, 1024, device="meta")
    got = _flat(cache)
    assert set(got) == set(ref)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == ref[path].shape, path
        assert _dtype_name(leaf) == str(ref[path].dtype), path
    assert _flat(axes) == _axes_paths(seen["axes"])
    for name in rconfigs.SHAPES:
        r = rlm.input_specs(cfg_r, rconfigs.SHAPES[name])
        t = lm.input_specs(cfg_t, configs.SHAPES[name])
        if isinstance(t, tuple):  # decode: (inputs, cache)
            t_flat = {**_flat(t[0], "[0]"), **_flat(t[1], "[1]")}
        else:
            t_flat = _flat(t)
        r_flat = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(r)[0]}
        assert set(t_flat) == set(r_flat), name
        for path, leaf in t_flat.items():
            assert tuple(leaf.shape) == r_flat[path].shape, (name, path)
            assert _dtype_name(leaf) == str(r_flat[path].dtype), (name, path)


def test_decode_cache_on_the_cpu_is_allocated_and_empty():
    cfg = configs.smoke_config(configs.get("h2o-danube-3-4b"))
    cache, _ = lm.init_decode_cache(cfg, 2, 40, device="cpu")
    assert int(cache["pos"]) == 0 and cache["pos"].device.type == "cpu"
    c = cache["layers"]["self"]
    assert tuple(c["k"].shape) == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                                   cfg.head_dim)
    assert (c["kv_pos"] == -1).all() and not c["k"].any()
    # each layer's slice is its own memory, not a broadcast view
    c["k"][0].fill_(1.0)
    assert not c["k"][1].any()


# ------------------------------------------------------ caches, window, bf16

def _run(arch, dtype="float32", op_by_op=False, tol=1e-4, **kw):
    cfg_r = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                                dtype=dtype, **kw)
    cfg_t = configs.ModelConfig(**dataclasses.asdict(cfg_r))
    params, _ = rlm.init_lm(jax.random.PRNGKey(1), cfg_r)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg_r.vocab, (B, T)).astype(
        np.int32)
    prefill = lambda p, t: rlm.prefill(p, {"tokens": t}, cfg_r,  # noqa: E731
                                       max_seq=T + 4)
    step = lambda p, c, t: rlm.decode_step(p, c, t, cfg_r)  # noqa: E731
    if not op_by_op:
        prefill, step = jax.jit(prefill), jax.jit(step)
    with jax.disable_jit(op_by_op):
        lr, cr = prefill(params, jnp.asarray(toks[:, :PROMPT]))
        ref = [lr]
        for i in range(STEPS):
            lr, cr = step(params, cr, jnp.asarray(toks[:, PROMPT + i:
                                                       PROMPT + i + 1]))
            ref.append(lr)
    lt, ct = lm.prefill(tp, {"tokens": torch.tensor(toks[:, :PROMPT])}, cfg_t,
                        max_seq=T + 4)
    got = [lt]
    for i in range(STEPS):
        lt, ct = lm.decode_step(tp, ct, torch.tensor(
            toks[:, PROMPT + i:PROMPT + i + 1]), cfg_t)
        got.append(lt)
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= tol, errs
    return cr, ct


@pytest.mark.parametrize("arch,kv_bits", [
    ("codeqwen1.5-7b", 8), ("codeqwen1.5-7b", 4), ("zamba2-7b", 8),
    ("zamba2-7b", 4), ("olmoe-1b-7b", 4)])
def test_quantized_kv_cache(arch, kv_bits):
    kw = {}
    if arch == "olmoe-1b-7b":
        kw["capacity_factor"] = 2.0  # dropless
    cr, ct = _run(arch, kv_bits=kv_bits, op_by_op=kv_bits == 8, **kw)
    key = "attn" if arch == "zamba2-7b" else "layers"
    for k in ("k", "v", "k_s", "v_s"):
        ref = np.asarray(jnp.asarray(cr[key]["self"][k]).astype(jnp.float32))
        assert ct[key]["self"][k].dtype == (
            torch.bfloat16 if k.endswith("_s") else
            torch.int8 if kv_bits == 8 else torch.uint8)
        np.testing.assert_array_equal(ct[key]["self"][k].float().numpy(), ref)
