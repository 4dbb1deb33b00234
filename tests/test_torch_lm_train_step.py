"""The port's LM train step (``repro_torch.launch.steps``) and its AdamW on
bfloat16 leaves against the JAX reference.

``make_train_step`` against the reference's, compiled without a mesh, for
three float32 steps from the same parameters and batches (numpy, from a
seed): the loss within 1e-5 relative at every step. Each parameter leaf
after the third within 5e-4 of the reference's in norm, ||got - ref|| /
||ref||, and every element within 5e-4 of its leaf's largest |ref|
(dense and hybrid: at most 2.3e-4); each first moment within 5e-3 in
norm. rwkv6 keeps a few elements past the element bound: AdamW's first
step moves an element by lr * g / (|g| + eps), so an element whose
gradient is at the float noise of the two frameworks' products (they
agree within 1e-4, ``test_torch_lm_grad.py``) moves by any amount up to
lr in either, and a run carries that on. From the same start rwkv6's
smoke model has one such element in ``layers.wk`` after the first step
(5.0e-4 apart, half of lr); after the third 16 elements of the tree are
past 5e-4 of their leaf's largest value (``embed`` one, 1.3e-3 apart;
``layers.mu`` 13, ``layers.gn_b`` and ``layers.wk`` one each), so rwkv6
is held to at most 32 such elements; its worst leaf is 3.6e-4 apart in
norm, dense and hybrid 5e-6 and 4e-5, and the losses 5.2e-6 relative.
The moments are the gradients themselves, taken at parameters that
drifted apart so: rwkv6's reach 7.2e-4 in norm. ``n_micro`` 2 splits the
batch in two and reports ``tokens`` as the batch's element count, the
reference's quirk. A bfloat16 run's losses within 1e-3 relative.

AdamW on bfloat16 leaves, rounded as JAX's promotion rules round them:
bit-equal to the reference over five steps with the same gradients,
clipping off, weight decay 0 and 0.1; and with clipping on (the global
norm is a bf16 reduction whose order may differ between XLA and torch:
held to one bf16 step of each leaf's largest value, though it has been
bit-equal on these inputs). A tree with
a float32 leaf among bfloat16 ones (the MoE router) promotes the clipped
gradients and the moments to float32 as JAX does.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import data  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

B, T, N_STEPS = 4, 16, 3
OCFG = dict(lr=1e-3, grad_clip=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                              dtype=dtype)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _batches(cfg_r, n):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg_r.vocab, (B, T)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -2:] = -1  # padding: the tokens quirk shows
        b = {"tokens": toks, "labels": labels}
        if cfg_r.family == "vlm":
            b["patches"] = (0.1 * rng.normal(
                size=(B, cfg_r.n_patches, cfg_r.d_model))).astype(np.float32)
        out.append(b)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run_both(arch, n_micro, dtype="float32"):
    cfg_r, cfg = _cfgs(arch, dtype)
    params_j, _ = rlm.init_lm(jax.random.PRNGKey(0), cfg_r)
    state_j = ropt.adamw_init(params_j)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, params_j),
                                        device="cpu")
    state = opt.adamw_init(params)
    step_j = jax.jit(rsteps.make_train_step(
        cfg_r, ropt.AdamWConfig(**OCFG), n_micro=n_micro))
    step = steps.make_train_step(cfg, opt.AdamWConfig(**OCFG),
                                 n_micro=n_micro)
    rows = []
    for b in _batches(cfg_r, N_STEPS):
        params_j, state_j, m_j = step_j(
            params_j, state_j, {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.tensor(v) for k, v in b.items()})
        rows.append((float(m_j["loss"]), m["loss"].item(),
                     int(m_j["tokens"]), int(m["tokens"])))
    return rows, (params_j, state_j), (params, state)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_train_step_matches_reference(arch, n_micro):
    rows, (pj, sj), (pt, st) = _run_both(arch, n_micro)
    for loss_j, loss_t, tok_j, tok_t in rows:
        assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
        assert tok_t == tok_j == (B * T if n_micro > 1 else B * (T - 2))
    assert int(st["step"]) == int(sj["step"]) == N_STEPS
    for got, want, tol in ((pt, pj, 5e-4), (st["mu"], sj["mu"], 5e-3)):
        want = _flat(jax.tree.map(_f32, want))
        for name, x in _flat(got).items():
            d = _f32(x) - want[name]
            err = float(np.linalg.norm(d))
            assert err <= tol * float(np.linalg.norm(want[name])), (name, err)
    want = _flat(jax.tree.map(_f32, pj))
    n_past = 0
    for name, x in _flat(pt).items():
        d = np.abs(_f32(x) - want[name])
        n_past += int(np.sum(d > 5e-4 * np.max(np.abs(want[name]))))
    assert n_past <= (32 if arch == "rwkv6-1.6b" else 0), n_past


def test_bf16_train_step_losses_match_reference():
    rows, _, (pt, _) = _run_both("codeqwen1.5-7b", 1, "bfloat16")
    assert pt["embed"].dtype == torch.bfloat16
    for loss_j, loss_t, _, _ in rows:
        assert abs(loss_t - loss_j) <= 1e-3 * abs(loss_j)


def test_train_step_updates_in_place_and_frees_old_leaves():
    _, cfg = _cfgs("codeqwen1.5-7b")
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = opt.adamw_init(params)
    old = weakref.ref(params["embed"])
    batch = data.batch_for_arch(cfg, 0, 0, 2, 8, device="cpu")
    new_p, new_s, m = steps.make_train_step(
        cfg, opt.AdamWConfig(**OCFG))(params, state, batch)
    gc.collect()
    assert new_p is params and new_s is state and old() is None
    assert int(state["step"]) == 1 and torch.isfinite(m["loss"])


def test_training_learns_synthetic_language():
    """The claim of the reference's ``test_lm_archs.py``: 30 steps on the
    dialect stream cut the loss below 0.7 of its first value."""
    cfg = configs.smoke_config(configs.get("codeqwen1.5-7b"))
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = opt.adamw_init(params)
    step = steps.make_train_step(cfg, opt.AdamWConfig(lr=3e-3, grad_clip=1.0))
    losses = []
    for i in range(30):
        batch = data.batch_for_arch(cfg, 0, i, 8, 64, device="cpu")
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] * 0.7, losses[::10]


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_abstract_trees_match_reference(arch):
    cfg_r = rconfigs.get(arch)
    cfg = configs.get(arch)
    p_j, _ = rsteps.abstract_params(cfg_r)
    p_t, _ = steps.abstract_params(cfg)
    o_j, o_t = rsteps.abstract_opt_state(p_j), steps.abstract_opt_state(p_t)
    c_j, _ = rsteps.abstract_cache(cfg_r, 2, 64)
    c_t, _ = steps.abstract_cache(cfg, 2, 64)
    assert steps.count_params(p_t) == rsteps.count_params(p_j)
    for got, want in ((p_t, p_j), (o_t, o_j), (c_t, c_j)):
        want = _flat(want)
        got = _flat(got)
        assert set(got) == set(want)
        for name, x in got.items():
            assert tuple(x.shape) == tuple(want[name].shape), name
            assert str(x.dtype).split(".")[-1] == str(want[name].dtype), name
    assert p_t["embed"].device.type == "meta"


def test_prefill_and_decode_fns_are_the_models():
    _, cfg = _cfgs("rwkv6-1.6b")
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = data.synthetic_batch(0, 0, batch=2, seq=9, vocab=cfg.vocab,
                                device="cpu")[0]
    logits, cache = steps.make_prefill_fn(cfg, 16)(params, {"tokens": toks[:, :8]})
    with torch.no_grad():
        want, want_cache = lm.prefill(params, {"tokens": toks[:, :8]}, cfg, 16)
    assert torch.equal(logits, want) and not logits.requires_grad
    got, _ = steps.make_decode_fn(cfg)(params, cache, toks[:, 8:])
    with torch.no_grad():
        want, _ = lm.decode_step(params, want_cache, toks[:, 8:], cfg)
    assert torch.equal(got, want)


# ---------------------------------------------- AdamW on bfloat16 leaves

def _tree(rng, mixed=False):
    t = {"a": rng.normal(size=(64, 64)),
         "b": {"c": rng.normal(size=(256,)), "d": rng.normal(size=(32, 8))}}
    out = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    if mixed:  # as the MoE router among bf16 leaves
        out["b"]["router"] = jnp.asarray(rng.normal(size=(16, 4)), jnp.float32)
    return out


def _torch_tree(t):
    return convert.lm_params_from_jax(jax.tree.map(np.asarray, t),
                                      device="cpu")


def _adamw_both(cfg_kw, update, mixed=False, steps_=5):
    rng = np.random.default_rng(0)
    pj = _tree(rng, mixed)
    sj = ropt.adamw_init(pj)
    pt = _torch_tree(pj)
    st = opt.adamw_init(pt)
    for _ in range(steps_):
        # gradients of mixed scale, 1e-4 .. 1
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape) * 10.0 ** rng.integers(-4, 1), x.dtype),
            pj)
        pj, sj = ropt.adamw_update(pj, g, sj, ropt.AdamWConfig(**cfg_kw))
        pt, st = update(pt, _torch_tree(g), st, opt.AdamWConfig(**cfg_kw))
    return (pj, sj), (pt, st)


def _pairs(ref, got):
    want = _flat(jax.tree.map(_f32, ref))
    for name, x in _flat(got).items():
        assert str(x.dtype).split(".")[-1] == str(
            _flat(ref)[name].dtype), name
        yield name, _f32(x), want[name]


@pytest.mark.parametrize("update", [opt.adamw_update, opt.adamw_update_],
                         ids=["adamw_update", "adamw_update_"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_bf16_adamw_bit_equal_to_reference(weight_decay, update):
    (pj, sj), (pt, st) = _adamw_both(dict(lr=1e-3, weight_decay=weight_decay),
                                     update)
    for ref, got in ((pj, pt), (sj["mu"], st["mu"]), (sj["nu"], st["nu"])):
        for name, g, w in _pairs(ref, got):
            assert np.array_equal(g, w), name
    assert int(st["step"]) == 5


@pytest.mark.parametrize("mixed", [False, True])
def test_bf16_adamw_with_clipping_matches_reference(mixed):
    (pj, sj), (pt, st) = _adamw_both(dict(lr=1e-3, grad_clip=1.0,
                                          weight_decay=0.1),
                                     opt.adamw_update, mixed)
    for ref, got in ((pj, pt), (sj["mu"], st["mu"]), (sj["nu"], st["nu"])):
        for name, g, w in _pairs(ref, got):
            assert np.max(np.abs(g - w)) <= 2.0 ** -8 * np.max(np.abs(w)), \
                name
    if mixed:  # JAX promotes the clipped gradients, so the moments
        assert all(x.dtype == torch.float32 for x in opt.tree_leaves(st["mu"]))


def test_adamw_update_leaves_its_arguments_and_the_in_place_step_agrees():
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        p = {"w": torch.tensor(rng.normal(size=(8, 8)), dtype=dtype),
             "n": {"b": torch.tensor(rng.normal(size=(8,)), dtype=dtype)}}
        g = opt.tree_map(lambda x: torch.tensor(rng.normal(size=x.shape),
                                            dtype=dtype), p)
        s0 = opt.adamw_init(p)
        before = [x.clone() for x in opt.tree_leaves({"p": p, "g": g, "s": s0})]
        cfg = opt.AdamWConfig(lr=1e-2, grad_clip=0.5, weight_decay=0.1)
        want_p, want_s = opt.adamw_update(p, g, s0, cfg)
        after = opt.tree_leaves({"p": p, "g": g, "s": s0})
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(s0["step"]) == 0 and want_p is not p
        p2, g2, s2 = (opt.tree_map(torch.clone, t) for t in (p, g, s0))
        got_p, got_s = opt.adamw_update_(p2, g2, s2, cfg)
        assert got_p is p2 and got_s is s2 and g2["w"] is None
        want = {"p": want_p, "m": want_s["mu"], "v": want_s["nu"]}
        got = {"p": got_p, "m": got_s["mu"], "v": got_s["nu"]}
        for a, b in zip(opt.tree_leaves(want), opt.tree_leaves(got)):
            assert torch.equal(a, b)
