"""Decode on the port's LM against the JAX reference's where its cache is a
ring: a sliding window of 8 under a 13-token prompt (the ring keeps the
prompt's tail) with bf16, int8 and int4 K/V, then four teacher-forced
decode steps that wrap it; and the whole path in bf16 weights.

Tolerances, relative to the largest reference value: 1e-4 in float32;
2e-2 in bf16 (one bf16 step is 2**-8; a few layers of bf16 roundings in
another order). The int8 case holds the port to the reference op by op
(``jax.disable_jit``), for the reason ``test_torch_lm_cache.py`` gives.
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


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_sliding_window_past_the_prompt(kv_bits):
    """A window of 8 under a 13-token prompt: the ring keeps the prompt's
    tail, and 4 decode steps wrap it."""
    cr, ct = _run("h2o-danube-3-4b", kv_bits=kv_bits, op_by_op=kv_bits == 8,
                  swa_window=8)
    kv_pos = ct["layers"]["self"]["kv_pos"]
    assert tuple(kv_pos.shape) == (2, 8)
    np.testing.assert_array_equal(kv_pos.numpy(),
                                  np.asarray(cr["layers"]["self"]["kv_pos"]))
    assert sorted(kv_pos[0].tolist()) == list(range(PROMPT + STEPS - 8,
                                                    PROMPT + STEPS))


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "rwkv6-1.6b"])
def test_bf16_weights(arch):
    _run(arch, dtype="bfloat16", tol=2e-2)


def test_audio_encdec_refuses_a_quantized_cache():
    cfg = dataclasses.replace(configs.smoke_config(
        configs.get("whisper-large-v3")), kv_bits=8)
    params, _ = lm.init_lm(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "frames": torch.zeros((1, cfg.n_frames, cfg.d_model))}
    with pytest.raises(ValueError, match="kv_bits"):
        lm.prefill(params, batch, cfg, max_seq=8)
