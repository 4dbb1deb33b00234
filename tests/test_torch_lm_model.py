"""Every architecture of the port's LM (``repro_torch.models.lm``) against
the JAX reference (``repro.models.lm``) at its smoke config in float32:
``forward_hidden``, ``lm_loss``, ``prefill`` and four teacher-forced
``decode_step``s, from the reference's own parameters carried over by
``convert.lm_params_from_jax``.

Tolerance: rtol = atol = 1e-4 relative to the largest reference value
(float32 matmuls in another order; the deepest smoke model is 4 layers).
MoE configs are made dropless (capacity_factor = E/k), as the reference's
own decode test does: the routing groups follow the token count, so a
prefill and a decode step route alike only without drops. The reference is
compiled (``jax.jit``, which it scans under anyway) and computed once per
architecture for the whole module.
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

TOL = 1e-4
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
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _cfgs(arch, **kw):
    ref = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                              dtype="float32", **kw)
    if ref.moe_experts:  # dropless
        ref = dataclasses.replace(
            ref, capacity_factor=float(ref.moe_experts) / ref.moe_top_k)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _inputs(cfg_r, seed=0):
    """Token and stub-modality inputs, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_r.vocab, (B, T)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out["labels"][0, -3:] = -1  # padding
    if cfg_r.family == "vlm":
        out["patches"] = (0.1 * rng.normal(
            size=(B, cfg_r.n_patches, cfg_r.d_model))).astype(np.float32)
    if cfg_r.family == "audio_encdec":
        out["frames"] = (0.1 * rng.normal(
            size=(B, cfg_r.n_frames, cfg_r.d_model))).astype(np.float32)
    return out


def _reference(cfg_r):
    """The reference's results on its own parameters."""
    params, _ = rlm.init_lm(jax.random.PRNGKey(0), cfg_r)
    inp = _inputs(cfg_r)
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["tokens"] = batch["tokens"][:, :PROMPT]
    out = {"params": jax.tree.map(np.asarray, params), "inputs": inp}
    out["hidden"] = np.asarray(jax.jit(
        lambda p, b: rlm.forward_hidden(p, b, cfg_r))(params, batch))
    loss, aux = jax.jit(lambda p, b: rlm.lm_loss(p, b, cfg_r))(params, batch)
    out["loss"], out["n"] = float(loss), int(aux["tokens"])
    logits, cache = jax.jit(lambda p, b: rlm.prefill(
        p, b, cfg_r, max_seq=T + 4))(params, prompt)
    out["prefill"] = np.asarray(logits)
    step = jax.jit(lambda p, c, t: rlm.decode_step(p, c, t, cfg_r))
    out["decode"] = []
    for i in range(STEPS):
        logits, cache = step(params, cache, batch["tokens"][:, PROMPT + i:
                                                           PROMPT + i + 1])
        out["decode"].append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def reference():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _reference(_cfgs(arch)[0])
        return memo[arch]

    return get


def _port(arch, ref):
    _, cfg_t = _cfgs(arch)
    params = convert.lm_params_from_jax(ref["params"], device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["inputs"].items()}
    return cfg_t, params, batch


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_forward_hidden(arch, reference):
    ref = reference(arch)
    cfg, params, batch = _port(arch, ref)
    h = lm.forward_hidden(params, batch, cfg)
    assert tuple(h.shape) == (B, T, cfg.d_model) and h.dtype == torch.float32
    assert _rel(h, ref["hidden"]) <= TOL


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_lm_loss(arch, reference):
    ref = reference(arch)
    cfg, params, batch = _port(arch, ref)
    loss, aux = lm.lm_loss(params, batch, cfg, t_chunk=8)
    assert int(aux["tokens"]) == ref["n"] == B * T - 3
    assert abs(float(loss) - ref["loss"]) <= TOL * abs(ref["loss"])


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_prefill_then_teacher_forced_decode(arch, reference):
    ref = reference(arch)
    cfg, params, batch = _port(arch, ref)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["tokens"] = batch["tokens"][:, :PROMPT]
    logits, cache = lm.prefill(params, prompt, cfg, max_seq=T + 4)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    assert _rel(logits, ref["prefill"]) <= TOL
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    assert int(cache["pos"]) == PROMPT + n_prefix
    for i in range(STEPS):
        logits, cache = lm.decode_step(
            params, cache, batch["tokens"][:, PROMPT + i:PROMPT + i + 1], cfg)
        assert _rel(logits, ref["decode"][i]) <= TOL, f"step {i}"
    assert int(cache["pos"]) == PROMPT + n_prefix + STEPS


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_decode_matches_forward(arch):
    """The port against itself, as the reference's own test: the last
    position's logits through prefill + one decode step equal the scoring
    forward's."""
    _, cfg = _cfgs(arch)
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.tensor(v) for k, v in _inputs(
        dataclasses.replace(cfg)).items()}
    h = lm.forward_hidden(params, batch, cfg)
    want = h[:, -1] @ lm._head_matrix(params, cfg)
    prompt = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = lm.prefill(params, prompt, cfg, max_seq=T + 4)
    got, _ = lm.decode_step(params, cache, batch["tokens"][:, -1:], cfg)
    assert _rel(got, want.numpy()) <= TOL
