"""LM serving on the port against the JAX reference: ``quantize_lm_params``
over every architecture's parameter tree (the same leaves quantized, to
the same values, the same footprint stats), and the decode engine
(``repro_torch.launch.serve.DecodeEngine``) generating the reference's
greedy tokens from the reference's parameters, with and without 4-bit
weights.

Float32 smoke configs for the engines (greedy argmax over logits that agree
within 1e-6 picks the same tokens here); the quantizer runs on the
reference's own bf16 trees and must be bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.api import nn as rnn  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.api import nn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_flat_np(v, path))
        else:
            out[path] = (v.float().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(jnp.asarray(v).astype(jnp.float32)))
    return out


def _changed(before, after):
    return {k for k in before if not np.array_equal(before[k], after[k])}


@pytest.mark.parametrize("min_size", [4096, 64])
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_quantize_lm_params_picks_the_reference_leaves(arch, min_size):
    """At the default min_size the smoke trees give 1 leaf (zamba2: 4); at
    64 the stacked (L, d) norm gains pass it too, as they do at full width
    (codeqwen1.5-7b: lm_head, layers.ln1, layers.ln2)."""
    cfg = rconfigs.smoke_config(rconfigs.get(arch))
    params, _ = rlm.init_lm(jax.random.PRNGKey(0), cfg)
    ref_q, ref_st = rnn.quantize_lm_params(params, 4, min_size=min_size)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu")
    got_q, got_st = nn.quantize_lm_params(tp, 4, min_size=min_size)
    assert got_st == ref_st
    before, ref_after, got_after = (_flat_np(params), _flat_np(ref_q),
                                    _flat_np(got_q))
    picked = _changed(before, got_after)
    assert picked == _changed(before, ref_after)
    if min_size == 4096:
        # the stacked per-layer projections are 3-D and stay as they are
        assert len(picked) == ref_st["n_quantized"]
        assert all("['layers']" not in k for k in picked)
        assert ref_st["n_quantized"] == {"zamba2-7b": 4}.get(arch, 1)
    else:
        # the stacked gains are counted; all ones, their round trip is exact
        assert ref_st["n_quantized"] > len(picked)
    for k in picked:
        np.testing.assert_array_equal(got_after[k], ref_after[k])
    # each leaf keeps its dtype (bf16 weights, the float32 MoE router)
    ref_dtypes = {jax.tree_util.keystr(k): str(v.dtype) for k, v in
                  jax.tree_util.tree_flatten_with_path(ref_q)[0]}
    assert _dtypes(got_q) == ref_dtypes


def _dtypes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_dtypes(v, path))
        else:
            out[path] = str(v.dtype).replace("torch.", "")
    return out


def _engines(arch, wq_bits):
    cfg_r = dataclasses.replace(rconfigs.smoke_config(rconfigs.get(arch)),
                                dtype="float32")
    cfg_t = configs.ModelConfig(**dataclasses.asdict(cfg_r))
    params, _ = rlm.init_lm(jax.random.PRNGKey(0), cfg_r)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu")
    if wq_bits:
        params, _ = rnn.quantize_lm_params(params, wq_bits)
        tp, _ = nn.quantize_lm_params(tp, wq_bits)
    return (rserve.DecodeEngine(cfg_r, params, 2, max_seq=24),
            serve.DecodeEngine(cfg_t, tp, 2, max_seq=24), cfg_r)


@pytest.mark.parametrize("wq_bits", [0, 4])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "rwkv6-1.6b",
                                  "zamba2-7b", "whisper-large-v3",
                                  "internvl2-2b"])
def test_decode_engine_generates_the_reference_tokens(arch, wq_bits):
    ref_engine, engine, cfg = _engines(arch, wq_bits)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32)
    want, ref_stats = ref_engine.generate(prompts, 6)
    got, stats = engine.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    assert set(stats) == set(ref_stats)
    assert stats["tokens_generated"] == 12


def test_decode_engine_stops_at_eos_and_checks_slots():
    _, engine, cfg = _engines("codeqwen1.5-7b", 0)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32)
    full, _ = engine.generate(prompts, 6)
    eos = int(full[1, 2])
    # a slot is done once it has emitted the EOS; decoding stops when all are
    done = np.logical_or.accumulate(full == eos, axis=1).all(axis=0)
    n = int(np.argmax(done)) + 1 if done.any() else 6
    out, st = engine.generate(prompts, 6, eos_id=eos)
    np.testing.assert_array_equal(out, full[:, :n])
    assert st["tokens_generated"] == 2 * n
    with pytest.raises(ValueError, match="batch slots"):
        engine.generate(prompts[:1], 6)
