"""The rematerialisation modes of the port's LM loss
(``repro_torch.models.lm``, ``cfg.remat``) and the split of its stacked
leaves, on the CPU; no JAX (the gradients themselves are held to the
reference in ``test_torch_lm_grad.py``).

``none``, ``dots`` and ``full`` must give bit-equal gradients for every
architecture (float32 smoke configs, MoE dropless): the recomputation runs
the same ops on the same inputs. What each keeps for backward is counted
by storage liveness: every storage an op makes during the forward is held
by a weak reference, and what is still alive once the forward returns is
what autograd keeps for backward (the loss aside). A
``saved_tensors_hooks`` count cannot see into a checkpointed region:
``torch.utils.checkpoint`` installs its own hooks there, which the outer
ones do not see. ``full`` must keep fewer bytes than ``dots``, ``dots``
fewer than ``none``, and none of them a (B, t_chunk, V) float32 chunk of
logits.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, T, T_CHUNK = 2, 17, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(arch, remat="none"):
    """(cfg, params, batch): the float32 smoke config (MoE dropless), its
    parameters drawn on the CPU from seed 0, and numpy inputs from seed 0
    (T = 17 with t_chunk 8: a ragged last chunk)."""
    cfg = dataclasses.replace(configs.smoke_config(configs.get(arch)),
                              dtype="float32", remat=remat)
    if cfg.moe_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.moe_experts) / cfg.moe_top_k)
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -1
    batch = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    if cfg.family == "vlm":
        batch["patches"] = torch.tensor((0.1 * rng.normal(
            size=(B, cfg.n_patches, cfg.d_model))).astype(np.float32))
    if cfg.family == "audio_encdec":
        batch["frames"] = torch.tensor((0.1 * rng.normal(
            size=(B, cfg.n_frames, cfg.d_model))).astype(np.float32))
    for x in lm._leaves(params):
        x.requires_grad_(True)
    return cfg, params, batch


def _grads(cfg, params, batch):
    leaves = list(lm._leaves(params))
    loss, _ = lm.lm_loss(params, batch, cfg, t_chunk=T_CHUNK)
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_remat_modes_give_bit_equal_gradients(arch):
    out = {r: _grads(*_case(arch, r)) for r in ("none", "dots", "full")}
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for g, want in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, want), remat


class _Made(TorchDispatchMode):
    """Weak references to every storage an op makes."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.setdefault(st._cdata, (StorageWeakRef(st),
                                                 st.nbytes(), t.dtype,
                                                 tuple(t.shape)))
        return out


def _kept(fn):
    """(fn's result, [(nbytes, dtype, shape made with)] of the storages it
    made that are still alive after it returns)."""
    rec = _Made()
    with rec:
        out = fn()
    gc.collect()
    return out, [k[1:] for k in rec.made.values() if not k[0].expired()]


def _logits_like(kept, v):
    """Kept float32 storages of a (B, t_chunk, V) chunk of logits (made by
    the head's product as (B * t_chunk, V))."""
    return [k for k in kept if k[1] == torch.float32 and k[2][-1:] == (v,)
            and k[0] == B * T_CHUNK * v * 4]


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "moonshot-v1-16b-a3b",
                                  "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_remat_keeps_fewer_bytes_and_no_logits(arch):
    kept = {}
    for remat in ("none", "dots", "full"):
        cfg, params, batch = _case(arch, remat)
        (loss, _), k = _kept(lambda: lm.lm_loss(params, batch, cfg,
                                                t_chunk=T_CHUNK))
        assert not _logits_like(k, cfg.padded_vocab), (remat, k)
        kept[remat] = sum(n for n, _, _ in k)
        del loss
    assert kept["full"] < kept["dots"] < kept["none"], kept


def test_the_count_sees_logits_outside_a_checkpoint():
    """The liveness count is not blind: one cross-entropy chunk run without
    its checkpoint keeps its float32 logits."""
    v = 512
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(B, T_CHUNK, 64, generator=gen, requires_grad=True)
    head = torch.randn(64, v, generator=gen, requires_grad=True)
    y = torch.randint(0, v, (B, T_CHUNK), generator=gen)
    _, kept = _kept(lambda: lm._ce_chunk(h, y, head, 1e-4))
    assert _logits_like(kept, v)
    _, kept = _kept(lambda: lm.chunked_cross_entropy(h, head, y,
                                                     t_chunk=T_CHUNK))
    assert not _logits_like(kept, v)


def _consumers(root, leaf) -> list[str]:
    """Backward nodes that take ``leaf``'s gradient straight to it."""
    seen, stack, out = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if getattr(nxt, "variable", None) is leaf:
                out.append(type(node).__name__)
            stack.append(nxt)
    return out


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_stacked_leaves_split_once(arch):
    """Each stacked leaf reaches the layers through one unbind (its
    backward one stack), never a select per layer."""
    cfg, params, batch = _case(arch)
    stacked = [x for k in ("layers", "enc_layers") if k in params
               for x in lm._leaves(params[k])]
    loss, _ = lm.lm_loss(params, batch, cfg, t_chunk=T_CHUNK)
    for x in stacked:
        assert _consumers(loss.grad_fn, x) == ["UnbindBackward0"]
