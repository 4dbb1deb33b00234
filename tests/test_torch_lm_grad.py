"""Gradients of the port's LM loss (``repro_torch.models.lm.lm_loss`` under
autograd) against the JAX reference's ``jax.value_and_grad(lm_loss)``, for
every architecture at its float32 smoke config, from the reference's own
parameters carried over by ``convert.lm_params_from_jax``.

Tolerances: every leaf's gradient within 1e-4 of the reference's largest
absolute value in that leaf (float32 products in another order, as
``test_torch_lm_model.py``). bfloat16: every leaf's gradient within 2e-2
of the reference's in norm, ||got - ref|| / ||ref|| (a bf16 ulp is 2^-8;
the backward's reductions round in bf16 in another order: the largest
single difference, on ``layers.ln1``, a sum over every token, was 2.1e-2
of that leaf's largest value against the reference compiled and op by op
alike, the largest norm ratio 1.6e-2).
T = 17 with ``t_chunk`` 8 leaves a ragged last chunk, which the reference
pads. MoE configs are dropless, as in ``test_torch_lm_model.py``. The
reference is compiled and computed once per architecture for the module.

The rematerialisation modes are tested in ``test_torch_lm_remat.py``.
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

TOL, TOL_BF16 = 1e-4, 2e-2
B, T, T_CHUNK = 2, 17, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                              dtype=dtype)
    if ref.moe_experts:  # dropless
        ref = dataclasses.replace(
            ref, capacity_factor=float(ref.moe_experts) / ref.moe_top_k)
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _inputs(cfg_r, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_r.vocab, (B, T)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out["labels"][0, -3:] = -1
    if cfg_r.family == "vlm":
        out["patches"] = (0.1 * rng.normal(
            size=(B, cfg_r.n_patches, cfg_r.d_model))).astype(np.float32)
    if cfg_r.family == "audio_encdec":
        out["frames"] = (0.1 * rng.normal(
            size=(B, cfg_r.n_frames, cfg_r.d_model))).astype(np.float32)
    return out


def _reference(cfg_r):
    params, _ = rlm.init_lm(jax.random.PRNGKey(0), cfg_r)
    inp = _inputs(cfg_r)
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: rlm.lm_loss(p, b, cfg_r, t_chunk=T_CHUNK),
        has_aux=True))(params, batch)
    return {"params": jax.tree.map(np.asarray, params), "inputs": inp,
            "loss": float(loss), "n": int(aux["tokens"]),
            "grads": jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)),
                                  grads)}


@pytest.fixture(scope="module")
def reference():
    memo = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in memo:
            memo[arch, dtype] = _reference(_cfgs(arch, dtype)[0])
        return memo[arch, dtype]

    return get


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _port_grads(cfg, params, batch):
    """(loss, n, {path: grad}) by autograd over every leaf."""
    flat = _flat(params)
    for x in flat.values():
        x.requires_grad_(True)
    loss, aux = lm.lm_loss(params, batch, cfg, t_chunk=T_CHUNK)
    names = list(flat)
    gs = torch.autograd.grad(loss, [flat[n] for n in names])
    return loss.item(), int(aux["tokens"]), dict(zip(names, gs))


def _port_inputs(arch, ref, dtype="float32"):
    _, cfg = _cfgs(arch, dtype)
    params = convert.lm_params_from_jax(ref["params"], device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["inputs"].items()}
    return cfg, params, batch


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_gradients_match_reference(arch, reference):
    ref = reference(arch)
    cfg, params, batch = _port_inputs(arch, ref)
    loss, n, grads = _port_grads(cfg, params, batch)
    assert n == ref["n"] == B * T - 3
    assert abs(loss - ref["loss"]) <= TOL * abs(ref["loss"])
    want = _flat(ref["grads"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        assert tuple(g.shape) == w.shape, name
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= TOL * max(float(np.max(np.abs(w))), 1e-12), (name, err)


def test_bf16_gradients_match_reference(reference):
    arch = "codeqwen1.5-7b"
    ref = reference(arch, "bfloat16")
    cfg, params, batch = _port_inputs(arch, ref, "bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    loss, _, grads = _port_grads(cfg, params, batch)
    assert abs(loss - ref["loss"]) <= TOL_BF16 * abs(ref["loss"])
    want = _flat(ref["grads"])
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16, name
        err = float(np.linalg.norm(g.float().numpy() - want[name]))
        assert err <= TOL_BF16 * float(np.linalg.norm(want[name])), (name, err)
