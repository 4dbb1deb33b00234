"""Unified LM assembly for the architecture zoo, as the reference's
``repro.models.lm``.

One functional model covers the families that ``cfg.family`` selects:

  dense / moe / vlm    decoder-only transformer (GQA + RoPE; SWA optional;
                       a MoE FFN in every layer for moe; vlm prepends
                       projected patch embeddings to the tokens: the ViT
                       frontend is a stub, ``batch["patches"]``).
  ssm_rwkv6            RWKV6 (Finch) blocks, attention-free.
  hybrid_mamba2        Mamba2 backbone with one *shared* attention+MLP block
                       applied after every ``cfg.attn_every`` layers (zamba2).
  audio_encdec         whisper-style encoder-decoder; the conv frontend is a
                       stub (``batch["frames"]``); decoder layers carry
                       self- plus cross-attention.

Parameters are the reference's tree: nested dicts of tensors, each
per-layer leaf stacked along a leading layer axis under ``layers`` (and
``enc_layers``), with the same key paths, shapes and dtypes, so that
``api.nn.quantize_lm_params`` picks the same leaves (it takes 2-D leaves
only). Where the reference scans over the layer axis, the port loops over
the layer index in Python.

Training differentiates ``lm_loss`` with autograd. The forward splits each
stacked leaf into its layers once, with ``unbind``, whose backward is one
``stack``: indexing the stack per layer would give each layer a backward
that allocates a zero tensor the size of the whole stack, O(L^2) bytes.
``cfg.remat`` is the reference's rematerialisation (``_remat``), applied
where the reference applies it, when grad is on:

  none   autograd keeps every layer's saved tensors;
  dots   each layer body under ``torch.utils.checkpoint`` with a selective
         policy that saves the outputs of ``aten.mm`` (the weight products,
         no batch dims: JAX's ``dots_with_no_batch_dims_saveable``) and
         recomputes the rest, attention's and the experts' ``bmm`` too;
  full   each layer body under ``torch.utils.checkpoint``: only its inputs
         are kept, the body runs again in backward.

Remat changes no value: the recomputation runs the same ops on the same
inputs. The dense, moe, vlm and rwkv6 layers, whisper's encoder and decoder
layers and every mamba2 layer of the hybrid are remat'd; the hybrid's
shared attention block is not, as in the reference. Each chunk of the
cross-entropy is checkpointed whatever ``cfg.remat`` says, so no
(B, t_chunk, V) float32 logits are kept for backward; on a mesh its
log-sum-exp and label logit run per rank (``_VocabParallelCE``), so that
no storage of it spans the global batch.

Entry points:

  forward_hidden  scoring / training forward -> hidden states at text
                  positions
  lm_loss         forward + chunked cross-entropy; differentiable
  prefill         prompt ingestion -> (last-token logits, decode cache)
  decode_step     one token for every sequence in the batch: O(1) state for
                  ssm/hybrid layers, a ring buffer for SWA layers.

A decode cache is a nested dict of tensors on the model's device that
``prefill`` fills and ``decode_step`` updates in place (the reference
returns a new cache instead; nothing reads the old one). Its ``pos`` is a
0-d int32 tensor on the host, so a step reads it without waiting for the
device.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import (AbstractMesh, current_ctx, is_sharded,
                                       logical_spec, mesh_shape, pspec,
                                       shard_map, sharded, spec_of)
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import (Initializer, constrain, layer_norm,
                                       rms_norm)

__all__ = ["init_lm", "lm_loss", "forward_hidden", "init_decode_cache",
           "prefill", "decode_step", "input_specs", "param_count",
           "split_tree"]


# --------------------------------------------------------------- param utils

def _is_spec(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], torch.Tensor) and isinstance(x[1], tuple))


def split_tree(tree):
    """Tree of (tensor, axes) -> (params tree, axes tree)."""
    if _is_spec(tree):
        return tree
    params, axes = {}, {}
    for k, v in tree.items():
        params[k], axes[k] = split_tree(v)
    return params, axes


def _prefix_axes(axes, name: str = "layers"):
    if isinstance(axes, dict):
        return {k: _prefix_axes(v, name) for k, v in axes.items()}
    return (name,) + axes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree, i):
    """Layer ``i`` of a stacked tree: views, so that writes reach the stack."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, split once with ``unbind``.

    The backward of ``unbind`` is one ``stack`` of the layers' gradients,
    where ``tree[i]`` per layer (``_index``) gives every layer a backward
    that writes its gradient into a zero tensor the size of the stack.
    """
    per: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for i, part in enumerate(parts):
            per[i][k] = part
    return per


def _store(stack: dict, i: int, new: dict) -> None:
    """Write one layer's state into a stacked state, in place."""
    for k, v in new.items():
        stack[k][i].copy_(v)


def param_count(params) -> int:
    return int(sum(x.numel() for x in _leaves(params)))


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -------------------------------------------------------------------- blocks

def _norm(x, p, name):
    if name + "_b" in p:
        return layer_norm(x, p[name], p[name + "_b"])
    return rms_norm(x, p[name])


def _init_norm(ini, cfg, name) -> dict:
    d = cfg.d_model
    p = {name: ini.ones((d,), ("norm",))}
    if cfg.norm == "layer":
        p[name + "_b"] = ini.zeros((d,), ("norm",))
    return p


def _init_tf_block(ini, cfg: ModelConfig, cross: bool = False,
                   use_moe: bool = False):
    p = {}
    p.update(_init_norm(ini, cfg, "ln1"))
    p["attn"] = T.init_attention(ini, cfg)
    if cross:
        p.update(_init_norm(ini, cfg, "lnx"))
        p["xattn"] = T.init_attention(ini, cfg, cross=True)
    p.update(_init_norm(ini, cfg, "ln2"))
    if use_moe:
        p["moe"] = T.init_moe(ini, cfg)
    else:
        p["mlp"] = T.init_mlp(ini, cfg)
    return split_tree(p)


def _tf_block(p, h, cfg: ModelConfig, *, positions=None, cache=None,
              cache_pos=None, enc=None, causal=True, q_chunk=1024):
    """One transformer layer; a cache ({"self"[, "cross"]}) is updated in
    place. Returns h."""
    a, _ = T.attention(p["attn"], _norm(h, p, "ln1"), cfg,
                       positions=positions,
                       cache=None if cache is None else cache["self"],
                       cache_pos=cache_pos, causal=causal, q_chunk=q_chunk)
    h = h + a
    if "xattn" in p:
        xa, _ = T.attention(
            p["xattn"], _norm(h, p, "lnx"), cfg, kv_src=enc,
            cache=None if cache is None else cache["cross"],
            use_rope=False, causal=False, q_chunk=q_chunk)
        h = h + xa
    f_in = _norm(h, p, "ln2")
    f = T.moe(p["moe"], f_in, cfg) if "moe" in p else T.mlp(p["mlp"], f_in, cfg)
    return constrain(h + f, "batch", None, None)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products with no batch dims (``x @ W``
    reaches here as ``aten.mm``, a batched einsum as ``aten.bmm``)."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _checkpoint(fn, policy=None):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant; ``policy``: a
    selective one). The recomputation in backward runs in the shard context
    the forward ran in, so on a mesh it takes the same per-rank paths."""
    def run(*args, **kwargs):
        ctx = current_ctx()

        def contexts():
            fwd, rec = (create_selective_checkpoint_contexts(policy)
                        if policy is not None else
                        (contextlib.nullcontext(), contextlib.nullcontext()))
            if ctx is not None:
                rec = _both(rec, sharded(*ctx))
            return fwd, rec

        return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                          **kwargs)

    return run


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the rematerialisation ``cfg.remat`` names, as the
    reference's ``_remat`` (any value but none and dots means full). With
    grad off nothing is saved, so ``fn`` runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return _checkpoint(fn, _dots_policy if cfg.remat == "dots" else None)


# ---------------------------------------------------------------------- init

def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None):
    """Returns (params, axes) trees on ``device`` (None means the card).

    The weights are drawn on the device, from ``generator`` (a generator of
    that device; None means one seeded with 0), so a full-width model is
    never drawn on the host. A seed therefore gives different weights on
    the CPU and on the card, and neither is the reference's draw: compare
    against the reference through ``convert.lm_params_from_jax``. On
    ``device="meta"`` nothing is drawn: the tree of shapes and dtypes, the
    reference's ``jax.eval_shape(init_lm)``.
    """
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = _dtype(cfg)
    d, v, n_l = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    ini = Initializer(generator, dt, dev)
    tree: dict[str, Any] = {
        "embed": ini.normal((v, d), ("vocab", "embed"), scale=0.02),
    }
    tree.update(_init_norm(ini, cfg, "ln_f"))
    if not cfg.tie_embeddings:
        tree["lm_head"] = ini.normal((d, v), ("embed", "vocab"))
    params, axes = split_tree(tree)

    def stacked(n, tree_fn):
        p, a = tree_fn(Initializer(generator, dt, dev, lead=(n,)))
        return p, _prefix_axes(a)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        params["layers"], axes["layers"] = stacked(
            n_l, lambda i: _init_tf_block(i, cfg, use_moe=(fam == "moe")))
        if fam == "vlm":
            p2, a2 = split_tree(
                {"patch_proj": ini.normal((d, d), ("embed", "embed2"))})
            params.update(p2)
            axes.update(a2)
    elif fam == "ssm_rwkv6":
        params["layers"], axes["layers"] = stacked(
            n_l, lambda i: split_tree(S.init_rwkv6_block(i, cfg)))
    elif fam == "hybrid_mamba2":
        params["layers"], axes["layers"] = stacked(
            n_l, lambda i: split_tree(S.init_mamba2_block(i, cfg)))
        # ONE shared attention block
        params["shared_attn"], axes["shared_attn"] = _init_tf_block(ini, cfg)
    elif fam == "audio_encdec":
        params["enc_layers"], axes["enc_layers"] = stacked(
            cfg.enc_layers, lambda i: _init_tf_block(i, cfg))
        params["layers"], axes["layers"] = stacked(
            n_l, lambda i: _init_tf_block(i, cfg, cross=True))
        t2 = {"frame_proj": ini.normal((d, d), ("embed", "embed2"))}
        t2.update(_init_norm(ini, cfg, "ln_enc"))
        p2, a2 = split_tree(t2)
        params.update(p2)
        axes.update(a2)
    else:
        raise ValueError(f"unknown family {fam!r}")
    return params, axes


# ------------------------------------------------------------------- forward

def _embed_tokens(params, tokens):
    table = params["embed"]
    ctx = current_ctx()
    if ctx is not None and is_sharded(table) and \
            not isinstance(ctx[0], AbstractMesh):
        h = _embed_sharded(table, tokens, *ctx)
    else:
        h = table[tokens]
    return constrain(h, "batch", None, None)


def _axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, major to minor."""
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _rank_along(mesh, axes) -> int:
    """This rank's shard index along ``axes`` (major to minor, as the shard
    order)."""
    rank = 0
    for a in axes:
        rank = rank * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return rank


def _embed_sharded(table, tokens, mesh, rules):
    """The lookup as a per-rank function on a mesh: each rank looks up its
    batch rows in its slice of the vocabulary (tokens outside it give 0)
    and the slices are summed over the vocabulary's axis, exactly (one
    term of each sum is not 0). DTensor's own index op cannot take a
    batch split over two mesh axes in older releases."""
    t_spec = logical_spec(mesh, rules, ("batch", None), tokens.shape)
    e_spec = logical_spec(mesh, rules, ("vocab", None), table.shape)
    v_axes = _axes_of(e_spec[0])
    rank = _rank_along(mesh, v_axes)

    def local(tab, toks):
        if not v_axes:
            return tab[toks]
        v_loc = tab.shape[0]
        lo = rank * v_loc
        hit = (toks >= lo) & (toks < lo + v_loc)
        rows = tab[(toks - lo).clamp(0, v_loc - 1)]
        return rows * hit[..., None].to(rows.dtype)

    out_spec = pspec(*t_spec, None)
    return shard_map(local, mesh, in_specs=(e_spec, t_spec),
                     out_specs=out_spec, sum_over=v_axes)(table, tokens)


def _encode_frames(params, frames, cfg):
    """Whisper encoder over stub frame embeddings (B, F, D)."""
    dt = _dtype(cfg)
    h = frames.to(dt) @ params["frame_proj"].to(dt)
    # the residual stream's layout, as every block's output has it: left
    # split over "model" along d, the first block's products would split
    # their rows over both mesh axes, unevenly at 1500 frames
    h = constrain(h, "batch", None, None)
    block = _remat(_tf_block, cfg)
    for p_l in _unbind(params["enc_layers"], cfg.enc_layers):
        h = block(p_l, h, cfg, causal=False)
    return _norm(h, params, "ln_enc")


def _positions(b, t, device, start: int = 0):
    return torch.arange(start, start + t, device=device)[None].expand(b, t)


def _with_patches(params, batch, h):
    patches = batch["patches"].to(h.dtype) @ params["patch_proj"].to(h.dtype)
    return torch.cat([patches, h], dim=1), patches.shape[1]


def _hybrid_groups(cfg: ModelConfig):
    a = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % a:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {a}")
    return cfg.n_layers // a, a


def forward_hidden(params, batch, cfg: ModelConfig, q_chunk: int = 1024):
    """Scoring / training forward -> hidden states at *text* positions
    (B,T,D); each layer under ``cfg.remat`` when grad is on."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    h = _embed_tokens(params, tokens)
    fam = cfg.family
    n_prefix = 0
    if fam == "vlm":
        h, n_prefix = _with_patches(params, batch, h)
    if fam in ("dense", "moe", "vlm"):
        positions = _positions(b, h.shape[1], h.device)
        block = _remat(_tf_block, cfg)
        for p_l in _unbind(params["layers"], cfg.n_layers):
            h = block(p_l, h, cfg, positions=positions, q_chunk=q_chunk)
    elif fam == "ssm_rwkv6":
        block = _remat(S.rwkv6_block, cfg)
        for p_l in _unbind(params["layers"], cfg.n_layers):
            h = block(p_l, h, cfg)
    elif fam == "hybrid_mamba2":
        g, a = _hybrid_groups(cfg)
        positions = _positions(b, t, h.device)
        layers = _unbind(params["layers"], cfg.n_layers)
        block = _remat(S.mamba2_block, cfg)
        for gi in range(g):
            for j in range(a):
                h = block(layers[gi * a + j], h, cfg)
            # the shared block is not remat'd (reference lm.py:301-318)
            h = _tf_block(params["shared_attn"], h, cfg, positions=positions,
                          q_chunk=q_chunk)
    elif fam == "audio_encdec":
        enc = _encode_frames(params, batch["frames"], cfg)
        positions = _positions(b, t, h.device)
        block = _remat(_tf_block, cfg)
        for p_l in _unbind(params["layers"], cfg.n_layers):
            h = block(p_l, h, cfg, positions=positions, enc=enc,
                      q_chunk=q_chunk)
    else:
        raise ValueError(fam)
    h = _norm(h, params, "ln_f")
    return h[:, n_prefix:] if n_prefix else h


def _head_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


class _VocabParallelCE(torch.autograd.Function):
    """(log-sum-exp, label logit) of each row of DTensor logits, (B, T, 1)
    each, computed per rank with the gradient in the logits' own layout.

    Left to DTensor, the logsumexp of logits split over the vocabulary
    gathers them (each rank's rows at the whole vocabulary, after a
    redistribution through the global batch), and the gather's backward is
    ``grad.new_zeros(logits.shape).scatter_add(...)`` whose zeros are
    replicated: the global (B, t_chunk, V) on every rank. Here each rank
    takes the log-sum-exp of its slice of the vocabulary and its label's
    logit where the label lies in it (0 elsewhere); one all-gather over
    the vocabulary's axes brings every slice's pair, whose log-sum-exp
    and sum are the row's (one term of the sum is not 0). The backward is
    each rank's own: ``g_lse * exp(x - lse)`` (logsumexp's), plus
    ``g_ll`` at the labels in its slice.
    """

    @staticmethod
    def forward(logits, idx):
        mesh, spec, axes, lo, _ = _vocab_slice(logits)
        groups = [mesh.get_group(a) for a in axes]

        def local(x, i):
            lse = torch.logsumexp(x, dim=-1, keepdim=True)
            ll = _label_logit(x, i, lo, bool(axes))
            if not groups:
                return lse, ll
            both = torch.stack([lse, ll], dim=-1)  # (b, t, 1, 2)
            for g in groups:
                both = all_gather(both, g, axis=2)
            return (torch.logsumexp(both[..., 0], dim=-1, keepdim=True),
                    both[..., 1].sum(-1, keepdim=True))

        rows = pspec(*spec[:-1], None)
        return shard_map(local, mesh, in_specs=(spec, rows),
                         out_specs=(rows, rows))(logits, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, idx = inputs
        ctx.save_for_backward(logits, idx, output[0])

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        logits, idx, lse = ctx.saved_tensors
        mesh, spec, axes, lo, v_loc = _vocab_slice(logits)

        def local(x, i, lse, g_lse, g_ll):
            grad = g_lse * (x - lse).exp()
            if axes:
                g_ll = torch.where((i >= lo) & (i < lo + v_loc), g_ll, 0.0)
                i = (i - lo).clamp(0, v_loc - 1)
            return grad.scatter_add_(-1, i, g_ll)

        rows = pspec(*spec[:-1], None)
        return shard_map(local, mesh, in_specs=(spec, rows, rows, rows, rows),
                         out_specs=spec)(logits, idx, lse, g_lse, g_ll), None


def _vocab_slice(logits):
    """(mesh, spec, the vocabulary's mesh axes, first row, rows) of this
    rank's slice of DTensor logits."""
    mesh, spec = logits.device_mesh, spec_of(logits)
    axes = _axes_of(spec[-1])
    v_loc = logits.to_local().shape[-1]
    return mesh, spec, axes, _rank_along(mesh, axes) * v_loc, v_loc


def _label_logit(x, i, lo: int, split: bool):
    """x at the labels ``i`` (B, T, 1); on a slice of the vocabulary from
    row ``lo``, 0 where the label lies outside it."""
    if not split:
        return torch.gather(x, -1, i)
    v_loc = x.shape[-1]
    got = torch.gather(x, -1, (i - lo).clamp(0, v_loc - 1))
    return torch.where((i >= lo) & (i < lo + v_loc), got, 0.0)


def _ce_chunk(h_i, y_i, head, z_loss: float):
    """(sum of the chunk's token losses, its count of valid labels)."""
    logits = (h_i @ head.to(h_i.dtype)).to(torch.float32)
    logits = constrain(logits, "batch", None, "vocab_act")
    idx = y_i.clamp(min=0)[..., None].long()
    if is_sharded(logits):
        lse, ll = _VocabParallelCE.apply(logits, idx)
    else:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        ll = torch.gather(logits, -1, idx)
    nll = (lse - ll)[..., 0]
    lse = lse[..., 0]
    if z_loss:
        nll = nll + z_loss * lse.square()
    valid = y_i >= 0
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def chunked_cross_entropy(h, head, labels, t_chunk: int = 512,
                          z_loss: float = 1e-4):
    """CE over (B,T,D) hidden x (D,V) head, a chunk of T at a time, never
    holding the whole (B,T,V) logits.

    With grad on, each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body): its (B, t_chunk, V)
    float32 logits are recomputed in backward, not kept. The reference pads
    T to a multiple of ``t_chunk`` with labels -1, which add nothing to the
    sum or the count; the port takes a shorter last chunk instead, the
    same sum.
    """
    chunk = _ce_chunk
    if torch.is_grad_enabled():
        chunk = _checkpoint(_ce_chunk)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, h.shape[1], t_chunk):
        s_i, n_i = chunk(h[:, i:i + t_chunk], labels[:, i:i + t_chunk], head,
                         z_loss)
        loss_sum = loss_sum + s_i
        n = n + n_i
    n = n.clamp(min=1)
    return loss_sum / n, n


def lm_loss(params, batch, cfg: ModelConfig, q_chunk: int = 1024,
            t_chunk: int = 512):
    h = forward_hidden(params, batch, cfg, q_chunk=q_chunk)
    loss, n = chunked_cross_entropy(h, _head_matrix(params, cfg),
                                    batch["labels"], t_chunk=t_chunk)
    return loss, {"tokens": n}


# -------------------------------------------------------------------- decode

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Returns (cache, axes). The cache covers ``max_seq`` total positions,
    on ``device`` (None means the card); ``pos`` stays on the host."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    fam = cfg.family
    kv_axes = ("cache_batch", "cache_seq", "kv_heads", None)

    def attn_cache(n_stack, seq):
        c = T.init_attn_cache(cfg, batch, seq, dtype=dt, device=dev,
                              lead=(n_stack,))
        ax = {"k": kv_axes, "v": kv_axes}
        if "k_s" in c:
            ax["k_s"] = kv_axes[:c["k_s"].ndim - 1]
            ax["v_s"] = kv_axes[:c["v_s"].ndim - 1]
        if "kv_pos" in c:
            ax["kv_pos"] = ("cache_seq",)
        return c, _prefix_axes(ax)

    pos = torch.zeros((), dtype=torch.int32)
    if fam in ("dense", "moe", "vlm"):
        seq = max_seq + (cfg.n_patches if fam == "vlm" else 0)
        c, ax = attn_cache(cfg.n_layers, seq)
        return ({"layers": {"self": c}, "pos": pos},
                {"layers": {"self": ax}, "pos": ()})
    if fam == "ssm_rwkv6":
        c = S.rwkv6_state(cfg, batch, device=dev, lead=(cfg.n_layers,))
        ax = {"s": ("layers", "cache_batch", "heads", None, None),
              "x_t": ("layers", "cache_batch", None),
              "x_c": ("layers", "cache_batch", None)}
        return {"layers": c, "pos": pos}, {"layers": ax, "pos": ()}
    if fam == "hybrid_mamba2":
        g, _ = _hybrid_groups(cfg)
        c = S.mamba2_state(cfg, batch, device=dev, lead=(cfg.n_layers,))
        m_ax = {"s": ("layers", "cache_batch", "heads", None, None),
                "conv": ("layers", "cache_batch", None, "mlp")}
        ac, aax = attn_cache(g, max_seq)
        return ({"mamba": c, "attn": {"self": ac}, "pos": pos},
                {"mamba": m_ax, "attn": {"self": aax}, "pos": ()})
    if fam == "audio_encdec":
        sc, sax = attn_cache(cfg.n_layers, max_seq)
        xc, xax = attn_cache(cfg.n_layers, cfg.n_frames)
        return ({"layers": {"self": sc, "cross": xc}, "pos": pos},
                {"layers": {"self": sax, "cross": xax}, "pos": ()})
    raise ValueError(fam)


def _logits(params, h, cfg):
    h = _norm(h, params, "ln_f")
    logits = (h[:, -1] @ _head_matrix(params, cfg).to(h.dtype)).to(torch.float32)
    return constrain(logits, "batch", "vocab_act")


def prefill(params, batch, cfg: ModelConfig, max_seq: int,
            q_chunk: int = 1024, cache: dict | None = None):
    """Prompt ingestion. Returns (last-token logits (B,V) float32, cache).

    ``cache``: a fresh cache of ``init_decode_cache``'s tree to fill (on a
    mesh, distributed by ``launch.steps.cache_shardings``); None makes one.
    """
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = params["embed"].device
    if cache is None:
        cache, _ = init_decode_cache(cfg, b, max_seq, device=dev)
    h = _embed_tokens(params, tokens)
    fam = cfg.family
    if fam == "vlm":
        h, _ = _with_patches(params, batch, h)
    tt = h.shape[1]
    positions = _positions(b, tt, dev)

    if fam in ("dense", "moe", "vlm"):
        for l in range(cfg.n_layers):
            h = _tf_block(_index(params["layers"], l), h, cfg,
                          positions=positions,
                          cache={"self": _index(cache["layers"]["self"], l)},
                          cache_pos=0, q_chunk=q_chunk)
    elif fam == "ssm_rwkv6":
        for l in range(cfg.n_layers):
            h, st = S._rwkv_block(_index(params["layers"], l), h, cfg, 32)
            _store(cache["layers"], l, st)
    elif fam == "hybrid_mamba2":
        g, a = _hybrid_groups(cfg)
        for gi in range(g):
            for j in range(a):
                h, st = S._mamba_block(_index(params["layers"], gi * a + j), h,
                                       cfg, 128)
                _store(cache["mamba"], gi * a + j, st)
            h = _tf_block(params["shared_attn"], h, cfg, positions=positions,
                          cache={"self": _index(cache["attn"]["self"], gi)},
                          cache_pos=0, q_chunk=q_chunk)
    elif fam == "audio_encdec":
        if cfg.kv_bits:
            # the reference's prefill fails here too: its cross cache has
            # scales that cross_kv does not give
            raise ValueError("audio_encdec keeps its cross-attention K/V "
                             "unquantized: kv_bits must be 0")
        enc = _encode_frames(params, batch["frames"], cfg)
        for l in range(cfg.n_layers):
            p_l = _index(params["layers"], l)
            cross = _index(cache["layers"]["cross"], l)
            for k, v in T.cross_kv(p_l["xattn"], enc, cfg).items():
                cross[k].copy_(v)
            h = _tf_block(p_l, h, cfg, positions=positions,
                          cache={"self": _index(cache["layers"]["self"], l),
                                 "cross": cross},
                          cache_pos=0, q_chunk=q_chunk)
    else:
        raise ValueError(fam)
    cache["pos"] = torch.tensor(tt, dtype=torch.int32)
    return _logits(params, h, cfg), cache


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One token for each sequence. tokens (B, 1) -> (logits (B,V) float32,
    cache); the cache is updated in place."""
    b = tokens.shape[0]
    pos = int(cache["pos"])  # absolute position in the (prefix + text) sequence
    h = _embed_tokens(params, tokens)
    positions = _positions(b, 1, h.device, start=pos)
    fam = cfg.family

    if fam in ("dense", "moe", "vlm"):
        for l in range(cfg.n_layers):
            h = _tf_block(_index(params["layers"], l), h, cfg,
                          positions=positions,
                          cache={"self": _index(cache["layers"]["self"], l)},
                          cache_pos=pos)
    elif fam == "ssm_rwkv6":
        h1 = h[:, 0]
        for l in range(cfg.n_layers):
            h1, st = S.rwkv6_block_step(_index(params["layers"], l), h1,
                                        _index(cache["layers"], l), cfg)
            _store(cache["layers"], l, st)
        h = h1[:, None]
    elif fam == "hybrid_mamba2":
        g, a = _hybrid_groups(cfg)
        h1 = h[:, 0]
        for gi in range(g):
            for j in range(a):
                l = gi * a + j
                h1, st = S.mamba2_block_step(_index(params["layers"], l), h1,
                                             _index(cache["mamba"], l), cfg)
                _store(cache["mamba"], l, st)
            h1 = _tf_block(params["shared_attn"], h1[:, None], cfg,
                           positions=positions,
                           cache={"self": _index(cache["attn"]["self"], gi)},
                           cache_pos=pos)[:, 0]
        h = h1[:, None]
    elif fam == "audio_encdec":
        for l in range(cfg.n_layers):
            h = _tf_block(_index(params["layers"], l), h, cfg,
                          positions=positions,
                          cache={"self": _index(cache["layers"]["self"], l),
                                 "cross": _index(cache["layers"]["cross"], l)},
                          cache_pos=pos)
    else:
        raise ValueError(fam)
    cache["pos"] = torch.tensor(pos + 1, dtype=torch.int32)
    return _logits(params, h, cfg), cache


# --------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape, max_seq: int | None = None):
    """Tensors on the ``meta`` device for every model input of (cfg, shape),
    where the reference gives ``jax.ShapeDtypeStruct``s.

    train  -> {"tokens","labels"[,"patches"/"frames"]}
    prefill-> {"tokens"[,"patches"/"frames"]}
    decode -> ({"tokens"}, cache)   (the cache covers shape.seq)
    """
    b, t = shape.batch, shape.seq
    dt = _dtype(cfg)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def extras(batch):
        e = {}
        if cfg.family == "vlm":
            e["patches"] = spec((batch, cfg.n_patches, cfg.d_model), dt)
        if cfg.family == "audio_encdec":
            e["frames"] = spec((batch, cfg.n_frames, cfg.d_model), dt)
        return e

    if shape.kind == "train":
        return {"tokens": spec((b, t), torch.int32),
                "labels": spec((b, t), torch.int32), **extras(b)}
    if shape.kind == "prefill":
        return {"tokens": spec((b, t), torch.int32), **extras(b)}
    # decode: one new token against a cache covering t positions
    cache, _ = init_decode_cache(cfg, b, t, device="meta")
    return {"tokens": spec((b, 1), torch.int32)}, cache
