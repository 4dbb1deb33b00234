"""Step-function factories shared by the launchers, as the reference's
``repro.launch.steps``.

Everything here is mesh-agnostic: callers pick a mesh and logical rules and
get step functions plus matching sharding trees (``NamedSharding``: a spec
and its DTensor placements per leaf) for params, optimizer state, batches
and decode caches. The step is a plain function over the nested parameter
dict, with no jit: on a mesh its leaves are DTensors, and the same code runs
sharded under ``shard_ctx`` (``sharded``). The abstract trees are tensors on
the ``meta`` device, where the reference has ``jax.eval_shape``'s
ShapeDtypeStructs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import (NamedSharding, axis_size, mesh_shape,
                                       pspec)
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

__all__ = ["abstract_params", "abstract_opt_state", "abstract_cache",
           "loss_and_grads", "accumulated_grads", "make_train_step",
           "make_prefill_fn", "make_decode_fn", "count_params",
           "param_shardings", "opt_shardings", "batch_shardings",
           "cache_shardings", "distribute", "sharded", "lower_cell"]


def abstract_params(cfg: ModelConfig):
    """(params tree, logical-axes tree) on ``meta``: no allocation."""
    return lm.init_lm(cfg, device="meta")


def abstract_opt_state(params_shapes) -> dict:
    return opt.adamw_init(params_shapes)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """(cache tree, axes tree) on ``meta`` (``pos`` is a host int32)."""
    return lm.init_decode_cache(cfg, batch, max_seq, device="meta")


def count_params(params_shapes) -> int:
    return lm.param_count(params_shapes)


# ------------------------------------------------------------------ sharding

def _map_axes(fn, axes, *rest):
    """``fn`` over the leaves of an axes tree (tuples) and trees like it."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], *(r[k] for r in rest)) for k in axes}
    return fn(axes, *rest)


def _divisible_spec(mesh, rules, a, shape) -> list:
    spec = [rules.get(n) if n else None for n in a]
    for i in range(len(spec)):
        if spec[i] is not None and shape[i] % axis_size(mesh, spec[i]) != 0:
            spec[i] = None
    return spec


def param_shardings(mesh, rules, axes_tree, shapes_tree=None):
    """Logical axes -> NamedSharding; with shapes, drops mesh axes that do
    not divide a dim (e.g. a 1-head reduced config on a >1 'model' axis)."""
    if shapes_tree is None:
        return _map_axes(lambda a: shd.named_sharding(mesh, a, rules),
                         axes_tree)
    return _map_axes(
        lambda a, leaf: NamedSharding(
            mesh, pspec(*_divisible_spec(mesh, rules, a, leaf.shape))),
        axes_tree, shapes_tree)


def opt_shardings(mesh, rules, axes_tree, shapes_tree=None):
    p = param_shardings(mesh, rules, axes_tree, shapes_tree)
    return {"mu": p, "nu": p, "step": NamedSharding(mesh, pspec())}


def batch_shardings(cfg: ModelConfig, mesh, rules):
    dp = rules.get("batch")
    tok = NamedSharding(mesh, pspec(dp, None))
    out = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        out["patches"] = NamedSharding(mesh, pspec(dp, None, None))
    if cfg.family == "audio_encdec":
        out["frames"] = NamedSharding(mesh, pspec(dp, None, None))
    return out


def cache_shardings(mesh, rules, cache_axes, cache_shapes):
    """Shape-aware cache shardings.

    Drops mesh axes that do not divide a dim (e.g. GQA kv_heads=8 on a
    16-way 'model' axis), then, for KV caches that lost their 'model'
    shard, moves 'model' onto the sequence dim instead (split-KV: the
    softmax's sums over the sharded context are cheap, and the cache stays
    sharded over every device).
    """
    n_model = mesh_shape(mesh).get("model", 1)

    def one(a, leaf):
        if a == ():
            return NamedSharding(mesh, pspec())
        shape = leaf.shape
        spec = _divisible_spec(mesh, rules, a, shape)
        used: set = set()
        for ax in spec:
            if ax:
                used.update([ax] if isinstance(ax, str) else ax)
        if "model" not in used and n_model > 1 and "cache_seq" in a:
            i = a.index("cache_seq")
            cur = spec[i]
            cand = tuple(cur) if isinstance(cur, (tuple, list)) else \
                ((cur,) if cur else ())
            cand = cand + ("model",)
            if shape[i] % axis_size(mesh, cand) == 0:
                spec[i] = cand if len(cand) > 1 else cand[0]
        return NamedSharding(mesh, pspec(*spec))

    return _map_axes(one, cache_axes, cache_shapes)


def distribute(tree, shardings):
    """Each leaf of ``tree`` as a DTensor of its sharding (the reference's
    ``jax.device_put(tree, shardings)``). Every rank passes the same global
    tree; each keeps its own shard, with no communication; a DTensor leaf
    is redistributed where its placements differ. A 0-d leaf (the
    optimizer's step count, a cache's host ``pos``) stays a plain tensor:
    ``sharded`` takes it as replicated where it meets DTensors."""
    def one(x, sh):
        if x.ndim == 0:
            return x.full_tensor() if hasattr(x, "full_tensor") else x
        if tuple(getattr(x, "placements", ())) == sh.placements:
            return x
        return sh.distribute(x)

    return opt.tree_map(one, tree, shardings)


sharded = shd.sharded


# --------------------------------------------------------------------- steps

def loss_and_grads(params, batch, cfg: ModelConfig, q_chunk: int = 1024,
                   t_chunk: int = 512):
    """(loss, aux, grads): ``lm.lm_loss`` and its gradient for every leaf
    of ``params`` (a tree like it), by autograd; ``params`` is untouched
    (the reference's ``jax.value_and_grad(lm.lm_loss, has_aux=True)``).

    On a mesh each gradient comes back laid out as its parameter, as the
    reference's does: autograd leaves a DTensor gradient a partial sum
    over the ranks, which is reduced here."""
    with torch.enable_grad():
        leaves = opt.tree_leaves(params)
        tree = opt.tree_map(lambda x: x.detach().requires_grad_(), params)
        loss, aux = lm.lm_loss(tree, batch, cfg, q_chunk=q_chunk,
                               t_chunk=t_chunk)
        grads = torch.autograd.grad(loss, opt.tree_leaves(tree),
                                    allow_unused=True, materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if shd.is_sharded(g) and g.placements != p.placements else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), aux, opt.tree_unflatten(params, grads)


def accumulated_grads(params, batch, cfg: ModelConfig, q_chunk: int = 1024,
                      t_chunk: int = 512, n_micro: int = 1):
    """(loss, tokens, grads) of the train step before its update: with
    ``n_micro > 1`` the mean over microbatches as ``make_train_step``
    describes."""
    if n_micro == 1:
        loss, aux, grads = loss_and_grads(params, batch, cfg, q_chunk,
                                          t_chunk)
        return loss, aux["tokens"], grads
    grads = opt.tree_map(torch.zeros_like, params)
    loss = 0.0
    for i in range(n_micro):
        b_i = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
               for k, v in batch.items()}
        l_i, _, g_i = loss_and_grads(params, b_i, cfg, q_chunk, t_chunk)
        opt.tree_map(lambda acc, g: acc.add_(g), grads, g_i)
        loss = loss + l_i
        del g_i
    opt.tree_map(lambda g: g.div_(n_micro), grads)
    tokens = torch.tensor(batch["tokens"].numel(), dtype=torch.int32,
                          device=loss.device)
    return loss / n_micro, tokens, grads


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    q_chunk: int = 1024, t_chunk: int = 512,
                    n_micro: int = 1):
    """``train_step(params, ostate, batch) -> (params, ostate, metrics)``:
    the loss and its gradients by autograd (``lm.lm_loss`` under
    ``cfg.remat``), then one AdamW step; ``metrics`` holds ``loss`` and
    ``tokens``, 0-d tensors on the device.

    The step updates ``params`` and ``ostate`` in place
    (``optimizer.adamw_update_``) and returns the same dicts: each leaf is
    replaced as soon as it is computed, so the caller's old leaves are
    freed one at a time. This is the port's counterpart of the reference's
    ``donate_argnums=(0, 1)``: the caller must not read the trees it passed
    in as they were.

    ``n_micro > 1`` splits the batch along dim 0 into ``n_micro``
    microbatches run one after the other, and sums their gradients in the
    parameters' dtype from zeros before dividing by ``n_micro``, as the
    reference's scan does. Its ``tokens`` is then ``batch["tokens"]``'s
    element count, not the count of valid labels (the reference's quirk,
    kept).
    """

    def train_step(params, ostate, batch):
        loss, tokens, grads = accumulated_grads(params, batch, cfg, q_chunk,
                                                t_chunk, n_micro)
        params, ostate = opt.adamw_update_(params, grads, ostate, ocfg)
        return params, ostate, {"loss": loss, "tokens": tokens}

    return train_step


def make_prefill_fn(cfg: ModelConfig, max_seq: int, q_chunk: int = 1024):
    @torch.no_grad()
    def prefill_fn(params, batch):
        return lm.prefill(params, batch, cfg, max_seq=max_seq,
                          q_chunk=q_chunk)

    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    @torch.no_grad()
    def decode_fn(params, cache, tokens):
        return lm.decode_step(params, cache, tokens, cfg)

    return decode_fn


# ------------------------------------------------------------ cell entry point

def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               q_chunk: int = 1024, t_chunk: int = 512, donate: bool = True,
               zero3: bool = False, n_micro: int = 1):
    """The right step for (cfg, shape) on ``mesh``, ready to run.

    Returns ``(step_fn, inputs, meta)``: ``step_fn(*inputs)`` runs one
    train step, prefill or decode step under ``sharded(mesh, rules)`` on
    DTensor parameters, optimizer state, batch and cache distributed by
    the sharding functions above. The inputs are abstract (``meta``) when
    the mesh lives on a dry run's fake group: the step then computes shapes
    and issues its collectives without data. ``donate`` is the reference's
    flag; the port's train step always updates its trees in place.
    """
    multi_pod = "pod" in shd.mesh_axis_names(mesh)
    cp = shape.name == "long_500k"
    mode = "train" if shape.kind == "train" else "serve"
    rules = shd.make_rules(mode, multi_pod=multi_pod, context_parallel=cp,
                           zero3=zero3)
    p_shapes, p_axes = abstract_params(cfg)
    p_sh = param_shardings(mesh, rules, p_axes, p_shapes)
    meta = {"n_params": count_params(p_shapes), "mode": mode, "rules_cp": cp}
    params = distribute(p_shapes, p_sh)

    if shape.kind == "train":
        o_shapes = abstract_opt_state(p_shapes)
        ostate = distribute(o_shapes, opt_shardings(mesh, rules, p_axes,
                                                    p_shapes))
        batch = lm.input_specs(cfg, shape)
        b_sh = batch_shardings(cfg, mesh, rules)
        batch = distribute(batch, {k: b_sh[k] for k in batch})
        step = make_train_step(cfg, opt.AdamWConfig(lr=1e-4),
                               q_chunk=q_chunk, t_chunk=t_chunk,
                               n_micro=n_micro)
        inputs = (params, ostate, batch)
    elif shape.kind == "prefill":
        batch = lm.input_specs(cfg, shape)
        b_sh = batch_shardings(cfg, mesh, rules)
        batch = distribute(batch, {k: b_sh[k] for k in batch})
        c_shapes, c_axes = abstract_cache(cfg, shape.batch, shape.seq)
        cache = distribute(c_shapes, cache_shardings(mesh, rules, c_axes,
                                                     c_shapes))

        def step(params, batch):
            return lm.prefill(params, batch, cfg, max_seq=shape.seq,
                              q_chunk=q_chunk, cache=cache)

        inputs = (params, batch)
    else:  # decode
        tok_spec, c_shapes = lm.input_specs(cfg, shape)
        _, c_axes = abstract_cache(cfg, shape.batch, shape.seq)
        cache = distribute(c_shapes, cache_shardings(mesh, rules, c_axes,
                                                     c_shapes))
        tokens = NamedSharding(mesh, pspec(rules.get("batch"), None)
                               ).distribute(tok_spec["tokens"])
        step = make_decode_fn(cfg)
        inputs = (params, cache, tokens)

    def step_fn(*args):
        with sharded(mesh, rules):
            return step(*args)

    return step_fn, inputs, meta
