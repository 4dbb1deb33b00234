"""GNN training loop: QAT on batched subgraphs (Cluster-GCN style).

Masked cross-entropy over train nodes; accuracy on the complement. Two
training paths share the loop and the parameter dict:

  path="fake"           QAT: fp32 GEMMs over fake-quantized tensors (STE).
  path="int_bitserial"  the integer path: ``models.gnn.forward_int``'s
                        bit-serial GEMMs over per-batch cached
                        ``IntBatchArtifacts`` (no per-step dense adjacency),
                        optional quantized and stochastically rounded
                        backward (grad_bits/stochastic) and error-feedback
                        gradient compression (grad_compress_bits).

Every batch is padded into one (n_nodes, e_cap) shape bucket, and on the
int path every batch's artifacts share one (P, E_rem) bucket. Stochastic
rounding draws from one generator on the training device, seeded with
``seed + 0x5eed``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.batching import SubgraphBatch, batch_iterator
from repro_torch.graph.sparse import sparse_to_dense
from repro_torch.models import gnn
from repro_torch.train import optimizer as opt

__all__ = ["TrainConfig", "train", "evaluate", "loss_fn", "train_step",
           "train_step_int", "make_device_batch", "prepare_batches"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    lr: float = 1e-2
    weight_decay: float = 1e-4
    qat: bool = True
    log_every: int = 25
    seed: int = 0
    path: str = "fake"           # "fake" | "int_bitserial"
    grad_bits: int = 0           # int path: quantize backward GEMMs too
    stochastic: bool = False     # int path: stochastic rounding
    grad_compress_bits: int = 0  # error-feedback grad compression (0 = off)
    backend: str | None = None   # api backend override for the int path


def make_device_batch(batch: SubgraphBatch, device=None) -> dict:
    """Host batch -> device tensors (dense adjacency path).

    ``device=None`` means the card (``device.resolve_device``).
    """
    dev = resolve_device(device)
    edges = torch.as_tensor(batch.edges, device=dev)
    adj = sparse_to_dense(edges, batch.n_nodes)
    deg = torch.sum(adj, dim=1, keepdim=True).to(torch.float32)
    inv_deg = 1.0 / (deg + 1.0)  # +1: self loop
    return {
        "adj": adj,
        "inv_deg": inv_deg,
        "x": torch.as_tensor(batch.features, device=dev),
        "y": torch.as_tensor(batch.labels, device=dev),
        "mask": torch.as_tensor(batch.train_mask, device=dev),
    }


def loss_fn(params, dbatch, cfg: gnn.GNNConfig, qat: bool,
            path: str = "fake", grad_bits: int = 0, stochastic: bool = False,
            generator=None, backend=None):
    """(masked mean cross-entropy, accuracy) over the batch's train nodes."""
    if path == "int_bitserial":
        logits = gnn.forward(params, dbatch["art"], None, None, cfg,
                             path="int_bitserial", grad_bits=grad_bits,
                             stochastic=stochastic, generator=generator,
                             backend=backend)
    else:
        logits = gnn.forward(params, dbatch["adj"], dbatch["x"],
                             dbatch["inv_deg"], cfg, path="fp32_dense",
                             fake_bits=qat)
    y = dbatch["y"]
    valid = (y >= 0) & dbatch["mask"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, y.clamp(min=0).to(torch.int64)[:, None],
                              dim=-1)[:, 0]
    n = torch.clamp(torch.sum(valid), min=1)
    loss = -torch.sum(torch.where(valid, ll, 0.0)) / n
    acc = torch.sum(torch.where(valid, torch.argmax(logits, -1) == y, 0)) / n
    return loss, acc


def _grads(loss, params) -> dict:
    """d loss / d params as a dict like params (zeros where unused)."""
    names = [(l, k) for l in params for k in params[l]]
    gs = torch.autograd.grad(loss, [params[l][k] for l, k in names],
                             allow_unused=True, materialize_grads=True)
    out: dict = {l: {} for l in params}
    for (l, k), g in zip(names, gs):
        out[l][k] = g
    return out


def _with_grad(params) -> dict:
    return {l: {k: v.detach().requires_grad_() for k, v in p.items()}
            for l, p in params.items()}


def train_step(params, ostate, dbatch, cfg: gnn.GNNConfig,
               ocfg: opt.AdamWConfig, qat: bool):
    """One fake-quant (or fp32) step -> (params, ostate, loss, acc)."""
    p = _with_grad(params)
    loss, acc = loss_fn(p, dbatch, cfg, qat)
    params, ostate = opt.adamw_update(params, _grads(loss, p), ostate, ocfg)
    return params, ostate, loss.detach(), acc


def train_step_int(params, ostate, cstate, dbatch, generator,
                   cfg: gnn.GNNConfig, ocfg: opt.AdamWConfig, grad_bits: int,
                   stochastic: bool, compress_bits: int, backend):
    """One integer-path step -> (params, ostate, cstate, loss, acc)."""
    p = _with_grad(params)
    loss, acc = loss_fn(p, dbatch, cfg, False, "int_bitserial", grad_bits,
                        stochastic, generator if stochastic else None, backend)
    grads = _grads(loss, p)
    if compress_bits:
        # per-tensor error feedback: this step's quantization residual is
        # added back next step
        q, scales, cstate = opt.compress_grads(grads, cstate, compress_bits)
        grads = opt.decompress_grads(q, scales)
    params, ostate = opt.adamw_update(params, grads, ostate, ocfg)
    return params, ostate, cstate, loss.detach(), acc


def prepare_batches(data, parts, batch_size: int = 4, tile: int = 128):
    """Training batches padded into ONE (n_nodes, e_cap) shape bucket."""
    from repro_torch.graph.batching import make_batches

    batches = make_batches(data, parts, batch_size, tile=tile)
    e_cap = max(b.edges.shape[1] for b in batches)
    n_cap = max(b.n_nodes for b in batches)
    return make_batches(data, parts, batch_size, tile=n_cap,
                        pad_edges_to=e_cap)


def train(data, parts, cfg: gnn.GNNConfig, tcfg: TrainConfig,
          batch_size: int = 4, tile: int = 128, callback=None, *,
          device=None):
    """Train for ``tcfg.steps`` steps -> (params, optimizer state, history).

    The weights start from ``gnn.init_params`` with a CPU generator seeded
    with ``tcfg.seed``, on ``device`` (None means the card). ``history``
    holds {"step", "loss", "acc", "elapsed_s"} every ``log_every`` steps
    and at the last.
    """
    dev = resolve_device(device)
    batches = prepare_batches(data, parts, batch_size, tile=tile)
    params = gnn.init_params(
        cfg, generator=torch.Generator().manual_seed(tcfg.seed), device=dev)
    ocfg = opt.AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                           grad_clip=1.0)
    ostate = opt.adamw_init(params)
    use_int = tcfg.path == "int_bitserial"
    cstate = (opt.compression_init(params) if tcfg.grad_compress_bits
              else None)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed + 0x5eed)
    if use_int:
        from repro_torch.train import intpath

        # shared caps: every batch's artifacts have one shape
        bp, rp = intpath.batch_caps(batches)
        cache = intpath.ArtifactCache(cfg.x_bits, block_pad=bp, rem_pad=rp,
                                      device=dev)
        dev_batches: dict[int, dict] = {}
    history = []
    t0 = time.time()
    for step, batch in batch_iterator(batches, epochs=None, seed=tcfg.seed):
        if step >= tcfg.steps:
            break
        if use_int:
            # artifacts, labels and masks are built once per BATCH: the
            # steady-state step moves nothing from the host
            dbatch = dev_batches.get(id(batch))
            if dbatch is None:
                dbatch = {"art": cache.get(batch),
                          "y": torch.as_tensor(batch.labels, device=dev),
                          "mask": torch.as_tensor(batch.train_mask, device=dev)}
                dev_batches[id(batch)] = dbatch
            params, ostate, cstate, loss, acc = train_step_int(
                params, ostate, cstate, dbatch, gen, cfg, ocfg,
                tcfg.grad_bits, tcfg.stochastic, tcfg.grad_compress_bits,
                tcfg.backend)
        else:
            dbatch = make_device_batch(batch, device=dev)
            params, ostate, loss, acc = train_step(params, ostate, dbatch, cfg,
                                                   ocfg, tcfg.qat)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            rec = {"step": step, "loss": float(loss), "acc": float(acc),
                   "elapsed_s": time.time() - t0}
            history.append(rec)
            if callback:
                callback(rec, params, ostate)
    return params, ostate, history


@torch.no_grad()
def evaluate(params, data, parts, cfg: gnn.GNNConfig, batch_size: int = 4,
             tile: int = 128, path: str = "fp32_dense", qat: bool = False,
             device=None):
    """Test accuracy over all batches (mask = test nodes).

    ``path="int_bitserial"`` evaluates through the integer training forward
    (deterministic rounding); other paths use the fp32 forward with
    ``fake_bits=qat``. ``device=None`` means the card.
    """
    from repro_torch.graph.batching import make_batches

    dev = resolve_device(device)
    batches = make_batches(data, parts, batch_size, tile=tile, shuffle=False)
    if path == "int_bitserial":
        from repro_torch.train import intpath

        bp, rp = intpath.batch_caps(batches)
    correct = total = 0
    for b in batches:
        db = make_device_batch(b, device=dev)
        if path == "int_bitserial":
            art = intpath.build_artifacts(b, cfg.x_bits, block_pad=bp,
                                          rem_pad=rp, device=dev)
            logits = gnn.forward_int(params, art, cfg)
        else:
            logits = gnn.forward(params, db["adj"], db["x"], db["inv_deg"],
                                 cfg, path="fp32_dense", fake_bits=qat)
        y = db["y"].cpu().numpy()
        test = (y >= 0) & ~db["mask"].cpu().numpy()
        pred = torch.argmax(logits, -1).cpu().numpy()
        correct += int(((pred == y) & test).sum())
        total += int(test.sum())
    return correct / max(total, 1)
