"""Step-function factories shared by the launchers, as the reference's
``repro.launch.steps``.

The reference's factories return jit-able functions plus NamedSharding
trees for a mesh. The port runs on one card without a jit: the step is a
plain function over the nested parameter dict, and the sharding functions
(``param_shardings``, ``opt_shardings``, ``batch_shardings``,
``cache_shardings``) and ``lower_cell`` come with the multi-card work.
The abstract trees are tensors on the ``meta`` device, where the reference
has ``jax.eval_shape``'s ShapeDtypeStructs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

__all__ = ["abstract_params", "abstract_opt_state", "abstract_cache",
           "loss_and_grads", "make_train_step", "make_prefill_fn",
           "make_decode_fn", "count_params"]


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


# --------------------------------------------------------------------- steps

def loss_and_grads(params, batch, cfg: ModelConfig, q_chunk: int = 1024,
                   t_chunk: int = 512):
    """(loss, aux, grads): ``lm.lm_loss`` and its gradient for every leaf
    of ``params`` (a tree like it), by autograd; ``params`` is untouched
    (the reference's ``jax.value_and_grad(lm.lm_loss, has_aux=True)``)."""
    with torch.enable_grad():
        tree = opt.tree_map(lambda x: x.detach().requires_grad_(), params)
        loss, aux = lm.lm_loss(tree, batch, cfg, q_chunk=q_chunk,
                               t_chunk=t_chunk)
        grads = torch.autograd.grad(loss, opt.tree_leaves(tree),
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), aux, opt.tree_unflatten(params, grads)


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
        if n_micro == 1:
            loss, aux, grads = loss_and_grads(params, batch, cfg, q_chunk,
                                              t_chunk)
            tokens = aux["tokens"]
        else:
            grads = opt.tree_map(torch.zeros_like, params)
            loss = 0.0
            for i in range(n_micro):
                b_i = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                    *v.shape[1:])[i]
                       for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(params, b_i, cfg, q_chunk,
                                             t_chunk)
                opt.tree_map(lambda acc, g: acc.add_(g), grads, g_i)
                loss = loss + l_i
                del g_i
            opt.tree_map(lambda g: g.div_(n_micro), grads)
            loss = loss / n_micro
            tokens = torch.tensor(batch["tokens"].numel(), dtype=torch.int32,
                                  device=loss.device)
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
