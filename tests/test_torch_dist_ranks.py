"""The port's dist layer on 4 gloo ranks (a (2, 2) ``("data", "model")``
mesh), against the reference and the port's unsharded path in this process.

One session of 4 spawned ranks (a ``file://`` rendezvous in ``tmp_path``, no
TCP port, one torch thread a rank, a join timeout of 120 s) runs every case
and writes each rank's results; the tests read them:

- ``compressed_psum_mean`` over the 4 ranks against the reference's under
  ``jax.vmap(axis_name="data")``, op by op, on the same ``default_rng``
  inputs, at 8 and 4 bits, 20 rounds of error feedback: mean and residual
  bit-equal;
- codeqwen1.5-7b smoke (float32) ``loss_and_grads`` with DTensor
  parameters under the train rules: the loss within 1e-5 of the port's
  unsharded loss and 1e-4 of the reference's on the same parameters, and
  every gradient leaf within 1e-5 of the unsharded one, relative to the
  leaf's norm and, element by element, to its largest element; the same
  gradients with ``remat`` "full" and "dots", whose recomputation in
  backward runs in the forward's shard context;
- ``optimizer.compress_grads`` (``launch/train.py --grad-compress-bits``)
  on those sharded gradients: the int8 values, scales and residuals
  bit-equal to the unsharded compression of the gathered gradients (each
  leaf's scale is its global max-abs);
- minitron-8b smoke, zero3 rules, ``n_micro`` 2: the step's accumulated
  gradients (``accumulated_grads``) leaf by leaf against the unsharded
  ones at the same 1e-5, and one ``make_train_step`` step (clip 1.0,
  weight decay 0.1): its loss within 1e-5 of the unsharded step's, and its
  updated parameters within 1e-6 (relative to each leaf's largest element)
  of AdamW applied, unsharded, to the gathered sharded gradients. The
  parameters are not held to the unsharded step's: one Adam step moves an
  element by about lr whatever its gradient's size, so elements whose
  gradient is at float noise land up to 2 lr apart.

The gradient checks see the sharded backward: the partial sums that the
per-rank attention core and the vocab-parallel embedding hand back
(``shard_map``'s gradient placements), zero3's reduce-scatters and the
accumulation over DTensor microbatches. With the data-axis sum of
``shard_map``'s gradients dropped (``distinct`` false for "data", so an
input replicated over "data" keeps each rank's own gradient; a mutation
run on a copy of the package), both gradient tests fail on the embedding
(its largest element off by 0.31 of 0.52 for codeqwen, 0.35 of 0.43 for
minitron), and so does the MoE test's router gradient; the loss tests
still pass.
- minitron-8b smoke (float32, 4 heads) prefill and 3 decode steps with
  DTensor parameters and cache under the serve rules, with 2 kv heads (they
  split over "model" as the query heads do: the grouped product, K/V not
  repeated) and with 1 (it does not divide "model", so
  ``cache_shardings`` moves "model" onto the cache's sequence: split-KV,
  each rank attends over its own positions and the softmax's max and sum
  are reduced): logits within 1e-5 of the unsharded decode, relative to
  their largest element; under split-KV the cache stays sequence-sharded
  and no decode step gathers it (no all-gather a step as large as one
  layer's K cache);
- olmoe-1b-7b smoke: ``moe`` through the expert-parallel branch (its
  ``use_sm`` true, taken once), output and the gradients of a weighted sum
  within 1e-5 of the single-device ``moe``;
- the GNN int forward under ``shard_ctx`` on the CPU's plain version: logits
  bit-equal to the forward without a context;
- three smoke-width LMs the dry run's open cells stand for, float32, each
  with DTensor parameters: a whisper-shaped encoder-decoder with 3 heads and
  3 kv heads (the 2-way "model" axis does not divide them, as 16 does not
  divide whisper-large-v3's 20: the heads stay replicated, the projections'
  columns do not, and the gradient of the heads' flatten comes back split
  over "model"), rwkv6 at d_model 128 (2 heads of 64, split over "model")
  and zamba2 (2 mamba heads split over "model"; its fused ``in_proj`` split
  over "model" at a width whose z/x/B/C/dt slices do not fall on the shard
  boundary, split per rank by ``split_along``). The chunked scans run per
  rank (``ssm._scan``), at a sequence of 160: 5 chunks for rwkv6, 2 for
  mamba2, the last padded. Under the train rules the loss within 1e-5 of the
  unsharded port's and every gradient leaf within 1e-5 of it (the
  whisper-shaped case) or 5e-5 (rwkv6, zamba2: see below), and one train
  step: its loss within 1e-5 of the unsharded step's, its parameters within
  1e-6 of AdamW applied, unsharded, to the gathered sharded gradients (as
  for minitron above); under the serve rules the prefill's logits within
  1e-5 of the unsharded prefill's, relative to their largest element, and
  for rwkv6 and zamba2 three decode steps after it (``gla_step`` and
  ``ssd_step`` run per rank through ``ssm._scan``), each step's logits
  within 1e-5 of the unsharded steps'. The two scan models' gradients sit at
  float32 noise near 1e-5 of their largest element: unsharded, in one
  process, their gradients move by up to 1.4e-5 (zamba2) and 3e-6 (rwkv6)
  when only the scan's backward summation order changes (the loop over
  chunks against the chunk-batched form, whose forward was bit-equal), and
  the sharded ones came 0.4-2.5e-5 from the unsharded ones over seeds 7-11
  at sequences 64, 96 and 160 (codeqwen's and the whisper-shaped case's stay
  near 1e-6). ``test_scan_models_gradient_noise`` measures the first figure;
- ``dist.sharding.split_along`` in the smoke zamba2's in_proj segments:
  a product split over "model" by columns (the shard boundary inside a
  segment), and ``split_product``, whose weight is put in grouped order
  before the product, each piece and the gradient of a weighted sum of the
  pieces bit-equal to the plain slices' and nothing but all-to-alls
  issued, each rank holding its own shard of every piece; ``join_along``
  of the pieces bit-equal to the whole; segments that "model" does not
  divide, bit-equal through DTensor's gathered slices;
- ``dist.sharding.write_along`` into a cache split along its sequence
  over "model" (and its positions), each rank writing the positions it
  holds: a slice across the shards and inside one, a ring index that
  wraps, a position one rank holds, bit-equal to the unsharded write;
- the DTensor ops one sharded rwkv6 layer dispatches, forward and
  backward (a ``TorchDispatchMode`` counting the dispatches that take a
  DTensor): the same count at sequences of 64 and 128 (2 and 4 chunks),
  where the layer with its scan run as DTensor ops (``_scan`` bypassed)
  dispatches more at 128 than at 64.

The child processes import no JAX: the module imports it only inside the
tests.
"""
import dataclasses
import multiprocessing
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

WORLD = 4
TIMEOUT_S = 120
CPSUM_BITS = (8, 4)
ROUNDS = 20
GRAD_RTOL = 1e-5
REMATS = ("full", "dots")
PARAM_RTOL = 1e-6
# rwkv6 and zamba2: the float32 noise of their own backward (docstring)
SCAN_GRAD_RTOL = 5e-5
LM_CASES = ("uneven_heads", "rwkv6", "zamba2")
LM_RUN = dict(batch=4, seq=160, prompt=24, decode=3)
# the scan models' decode steps (models/ssm.py gla_step, ssd_step) run per
# rank on a mesh
DECODE_FAMILIES = ("ssm_rwkv6", "hybrid_mamba2")
OP_SEQS = (64, 128)


def _opt():
    from repro_torch.train import optimizer as opt

    return opt.AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


def _smoke(arch, **kw):
    from repro_torch import configs
    from repro_torch.configs.base import smoke_config

    return dataclasses.replace(smoke_config(configs.get(arch)),
                               dtype="float32", **kw)


def _lm_config(name):
    if name == "uneven_heads":
        return _smoke("whisper-large-v3", n_heads=3, n_kv_heads=3)
    if name == "rwkv6":
        return _smoke("rwkv6-1.6b", d_model=128)
    return _smoke("zamba2-7b")


def _lm_batch(cfg):
    from repro_torch.train import data

    return data.batch_for_arch(cfg, 0, 0, LM_RUN["batch"], LM_RUN["seq"],
                               device="cpu")


def _decode_after_prompt(batch):
    """The tokens that follow the prompt, one a decode step."""
    n = LM_RUN["prompt"]
    return batch["tokens"][:, n:n + LM_RUN["decode"]]


def _prefill_batch(batch):
    return {k: v[:, :LM_RUN["prompt"]] if k == "tokens" else v
            for k, v in batch.items() if k != "labels"}


class _DTensorOps(TorchDispatchMode):
    """Counts the ops dispatched with a DTensor among their arguments (a
    per-rank function's own ops take plain tensors)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.dist.sharding import is_sharded

        self.n += any(map(is_sharded, tree_leaves((args, kwargs))))
        return func(*args, **(kwargs or {}))


def _rwkv_layer_ops(mesh, seq, per_rank=True):
    """DTensor dispatches of one rwkv6 layer's forward and backward on the
    mesh, at ``seq`` (``per_rank`` False: the scan as DTensor ops)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models import ssm as S

    cfg = _lm_config("rwkv6")
    params, axes = lm.init_lm(cfg, torch.Generator().manual_seed(5),
                              device="cpu")
    p = {k: v[0] for k, v in params["layers"].items()}
    a = {k: v[1:] for k, v in axes["layers"].items()}
    rules = shd.make_rules("train")
    p = steps.distribute(p, steps.param_shardings(mesh, rules, a, p))
    p = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = torch.randn((LM_RUN["batch"], seq, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    x = shd.NamedSharding(mesh, shd.pspec("data", None, None)).distribute(x)
    scan = S._scan
    if not per_rank:
        S._scan = lambda plain, per_rank_fn, args, names, state_at: \
            plain(*args)
    try:
        with steps.sharded(mesh, rules), _DTensorOps() as ops:
            S.rwkv6_block(p, x.requires_grad_(), cfg).sum().backward()
    finally:
        S._scan = scan
    return ops.n


def _cpsum_inputs():
    """Each rank's gradient, the same every round (as the reference's
    error-feedback test)."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(WORLD, 16, 64)) * 3).astype(np.float32)


def _moe_inputs(cfg):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(8, 32, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _gnn_setup():
    """A small proteins batch's int-path artifacts and GCN parameters."""
    from repro_torch import configs
    from repro_torch.graph import partition
    from repro_torch.graph.datasets import load
    from repro_torch.models import gnn
    from repro_torch.train import intpath, trainer

    data = load("proteins", scale=0.01, seed=0)
    parts = partition.partition(data.csr, 8)
    cfg = dataclasses.replace(configs.get("qgtc-gcn"),
                              in_dim=data.features.shape[1],
                              n_classes=int(data.labels.max()) + 1)
    batches = trainer.prepare_batches(data, parts, batch_size=4)
    bp, rp = intpath.batch_caps(batches)
    art = intpath.ArtifactCache(cfg.x_bits, block_pad=bp, rem_pad=rp,
                                device="cpu").get(batches[0])
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params, art


def _rank_main(rank, store_dir, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/rdv",
                            rank=rank, world_size=WORLD)
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import gnn, lm
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt

    out = {}
    xs = torch.from_numpy(_cpsum_inputs())
    for nbits in CPSUM_BITS:
        err, got = None, []
        for r in range(ROUNDS):
            mean, err = collectives.compressed_psum_mean(xs[rank], None,
                                                         nbits=nbits, err=err)
            got.append((mean, err))
        out[f"cpsum{nbits}"] = got

    mesh = make_local_mesh(model=2, device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 2,
                                                          "model": 2}

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def on_mesh(cfg, params, axes, batch, rules):
        p = steps.distribute(params, steps.param_shardings(mesh, rules, axes,
                                                           params))
        b_sh = steps.batch_shardings(cfg, mesh, rules)
        return p, steps.distribute(batch, {k: b_sh[k] for k in batch})

    def gathered(tree):
        return opt.tree_map(lambda t: full(t).detach(), tree)

    # codeqwen: the loss and its gradients with DTensor parameters
    cq = cases["codeqwen"]
    rules = shd.make_rules("train")
    p, b = on_mesh(cq["cfg"], cq["params"], cq["axes"], cq["batch"], rules)
    with steps.sharded(mesh, rules):
        loss, _, grads = steps.loss_and_grads(p, b, cq["cfg"])
    out["codeqwen_loss"] = full(loss).item()
    out["codeqwen_grads"] = gathered(grads)
    for remat in REMATS:  # the recomputation in backward on the mesh
        with steps.sharded(mesh, rules):
            _, _, g = steps.loss_and_grads(
                p, b, dataclasses.replace(cq["cfg"], remat=remat))
        out[f"codeqwen_grads_{remat}"] = gathered(g)
    # the launcher's --grad-compress-bits on DTensor gradients
    with steps.sharded(mesh, rules):
        q, scales, cst = opt.compress_grads(grads, opt.compression_init(grads),
                                            nbits=8)
    out["compressed"] = (gathered(q), gathered(scales),
                         gathered(cst.residual))

    # minitron: zero3 with 2 microbatches, the gradients and one step
    mt = cases["minitron"]
    rules = shd.make_rules("train", zero3=True)
    p, b = on_mesh(mt["cfg"], mt["params"], mt["axes"], mt["batch"], rules)
    with steps.sharded(mesh, rules):
        _, _, grads = steps.accumulated_grads(p, b, mt["cfg"], n_micro=2)
    grads = gathered(grads)
    out["minitron_grads"] = grads
    plain = gathered(p)
    out["minitron_params_from_grads"], _ = opt.adamw_update(
        plain, grads, opt.adamw_init(plain), _opt())
    step = steps.make_train_step(mt["cfg"], _opt(), n_micro=2)
    with steps.sharded(mesh, rules):
        p, ostate, metrics = step(p, opt.adamw_init(p), b)
    out["minitron_loss"] = full(metrics["loss"]).item()
    out["minitron_params"] = gathered(p)

    # minitron decode: GQA without repeat, and split-KV
    for name, case in cases["decode"].items():
        out[f"decode_{name}"] = _decode_on_mesh(mesh, shd.make_rules("serve"),
                                                case)

    # olmoe: the expert-parallel moe and its gradients
    mo = cases["olmoe"]
    rules = shd.make_rules("train")
    taken = []
    ep = T._moe_expert_parallel

    def counted(*a, **kw):
        taken.append(1)
        return ep(*a, **kw)

    T._moe_expert_parallel = counted
    try:
        p = steps.distribute(mo["params"], steps.param_shardings(
            mesh, rules, mo["axes"], mo["params"]))
        p = opt.tree_map(lambda t: t.detach().requires_grad_(), p)
        x_sh = shd.NamedSharding(mesh, shd.pspec("data", None, None))
        x = x_sh.distribute(mo["x"]).detach().requires_grad_()
        w = x_sh.distribute(mo["w"])
        with steps.sharded(mesh, rules):
            y = T.moe(p, x, mo["cfg"])
            (y * w).sum().backward()
    finally:
        T._moe_expert_parallel = ep
    out["moe_taken"] = len(taken)
    out["moe_out"] = full(y).detach()
    out["moe_grads"] = {"x": full(x.grad),
                        **{k: full(v.grad) for k, v in p.items()}}

    # the GNN int forward under a context, on the plain version
    cfg, params, art = _gnn_setup()
    with torch.no_grad():
        want = gnn.forward_int(params, art, cfg)
        with shd.shard_ctx(mesh, shd.make_rules("train")):
            got = gnn.forward_int(params, art, cfg)
    out["gnn"] = (want, got)

    out["write_along"] = _write_along_on_mesh(mesh)
    out["split_along"] = _split_along_on_mesh(mesh)

    # the dry run's open cells at smoke width: uneven heads and the scans
    for name in LM_CASES:
        out[f"lm_{name}"] = _lm_on_mesh(mesh, cases["lm"][name], on_mesh,
                                        gathered)
    # the DTensor ops of a sharded rwkv6 layer against the sequence
    out["rwkv_ops"] = {seq: _rwkv_layer_ops(mesh, seq) for seq in OP_SEQS}
    out["rwkv_ops_dtensor_scan"] = {
        seq: _rwkv_layer_ops(mesh, seq, per_rank=False) for seq in OP_SEQS}

    # a DTensor never reaches a kernel: every wrapper asks kernel_device
    from repro_torch.kernels import _build

    a = torch.zeros((1, 8, 1), dtype=torch.int32)
    a_d = shd.NamedSharding(mesh, shd.pspec(None, "data", None)).distribute(a)
    try:
        _build.kernel_device(a_d, a)
        out["dtensor_refused"] = False
    except TypeError as e:
        out["dtensor_refused"] = "DTensor" in str(e)

    torch.save(out, f"{store_dir}/rank{rank}.pt")
    dist.destroy_process_group()


# dist.sharding.write_along on a (B, S, H, D) cache split over "data" by
# rows and over "model" along its S = 16 positions (8 a rank), and on its
# (S,) positions: a slice across the two shards, a slice inside one, a ring
# index that wraps, and one position that only one "model" rank holds
WRITES = {"slice": slice(5, 12), "slice_in_one": slice(9, 11),
          "ring": [14, 15, 0, 1, 2], "one": [9]}


def _write_along_on_mesh(mesh) -> dict:
    """Each write into a sharded cache, gathered, beside the same write
    into the unsharded cache."""
    from repro_torch.dist import sharding as shd

    g = torch.Generator().manual_seed(5)
    base = torch.randn((4, 16, 4, 2), generator=g)
    pos = torch.arange(16, dtype=torch.int32)
    cache_sh = shd.NamedSharding(mesh, shd.pspec("data", "model", None, None))
    src_sh = shd.NamedSharding(mesh, shd.pspec("data", None, "model", None))
    rules = shd.make_rules("serve", context_parallel=True)
    out = {}
    for name, index in WRITES.items():
        t = len(range(16)[index]) if isinstance(index, slice) else len(index)
        if not isinstance(index, slice):
            index = torch.tensor(index)
        src = torch.randn((4, t, 4, 2), generator=g)
        new_pos = torch.arange(100, 100 + t, dtype=torch.int32)
        want, want_pos = base.clone(), pos.clone()
        shd.write_along(want, 1, index, src)
        shd.write_along(want_pos, 0, index, new_pos)
        cache = cache_sh.distribute(base.clone())
        kv_pos = shd.NamedSharding(mesh, shd.pspec("model")).distribute(
            pos.clone())
        with torch.no_grad(), shd.sharded(mesh, rules):
            shd.write_along(cache, 1, index, src_sh.distribute(src))
            shd.write_along(kv_pos, 0, index, new_pos)
        out[name] = dict(got=cache.full_tensor(), want=want,
                         got_pos=kv_pos.full_tensor(), want_pos=want_pos,
                         spec=tuple(shd.spec_of(cache)),
                         changed=not torch.equal(want, base))
    return out


# dist.sharding.split_along in the smoke zamba2's in_proj segments (z, x,
# B, C, dt: 128, 128, 8, 8, 2, 137 columns a rank on the 2-way "model"
# axis, the shard boundary inside x): a (4, 6, 274) product split over
# "data" by rows and over "model" by columns; split_product of (4, 6, 16)
# rows split over "data" by a (16, 274) weight split over "model", the
# weight moved into grouped order and the product split without moving,
# as the Mamba-2 block's in_proj; and segments that "model" does not
# divide (127, 129, 9, 7, 2), which DTensor slices after gathering
SEGMENTS = (128, 128, 8, 8, 2)
SPLITS = {"product": ((4, 6, 274), ("data", None, "model"), SEGMENTS),
          "weight": ((16, 274), (None, "model"), SEGMENTS),
          "uneven": ((4, 6, 274), ("data", None, "model"), (127, 129, 9, 7,
                                                             2))}
ROWS = ((4, 6, 16), ("data", None, None))


def _split_along_on_mesh(mesh) -> dict:
    """Each case's pieces, the gradient of a weighted sum of them and
    ``join_along`` of the pieces, gathered, beside the plain slices' and
    their gradient; the collectives of the split and join."""
    from repro_torch.dist import sharding as shd
    from repro_torch.perf import roofline

    def put(t, spec):
        return shd.NamedSharding(mesh, shd.pspec(*spec)).distribute(t)

    rules = shd.make_rules("train")
    out = {}
    for name, (shape, spec, sizes) in SPLITS.items():
        g = torch.Generator().manual_seed(11)
        if name == "weight":
            # small integers: every product and gradient exact in any
            # order of summation
            def draw(*shape):
                return torch.randint(-4, 5, shape, generator=g).float()
            rows = draw(*ROWS[0])
        else:
            def draw(*shape):
                return torch.randn(shape, generator=g)
            rows = None
        x = draw(*shape)
        xp = x.clone().requires_grad_()
        whole = xp if rows is None else rows @ xp
        ws = [draw(*whole.shape[:-1], s) for s in sizes]
        want = whole.split(sizes, -1)
        sum((a * w).sum() for a, w in zip(want, ws)).backward()
        xd = put(x, spec).requires_grad_()
        with shd.sharded(mesh, rules), \
                roofline.record_collectives() as rec:
            if rows is None:
                got = shd.split_along(xd, -1, sizes)
            else:
                got = shd.split_product(put(rows, ROWS[1]), xd, sizes)
            joined = shd.join_along(got, -1)
        with shd.sharded(mesh, rules):
            sum((a * w).sum() for a, w in zip(got, ws)).backward()
        out[name] = dict(
            got=[t.full_tensor() for t in got],
            want=[t.detach() for t in want], grad=xd.grad.full_tensor(),
            want_grad=xp.grad, joined=joined.full_tensor(),
            whole=whole.detach(),
            specs=[tuple(shd.spec_of(t)) for t in got],
            ops=sorted({op for op, _, _ in rec}))
    return out


def _lm_on_mesh(mesh, case, on_mesh, gathered):
    """Prefill logits under the serve rules, then the loss, the gradients
    and one train step under the train rules, with DTensor parameters."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt

    cfg, batch = case["cfg"], case["batch"]
    res = {}
    rules = shd.make_rules("serve")
    pre = _prefill_batch(batch)
    p, b = on_mesh(cfg, opt.tree_map(torch.clone, case["params"]),
                   case["axes"], pre, rules)
    c_shapes, c_axes = lm.init_decode_cache(cfg, LM_RUN["batch"],
                                            LM_RUN["seq"], device="cpu")
    cache = steps.distribute(c_shapes, steps.cache_shardings(
        mesh, rules, c_axes, c_shapes))
    toks = shd.NamedSharding(mesh, shd.pspec(rules["batch"], None)) \
        .distribute(_decode_after_prompt(batch))
    with torch.no_grad(), steps.sharded(mesh, rules):
        logits, cache = lm.prefill(p, b, cfg, max_seq=LM_RUN["seq"],
                                   cache=cache)
        res["prefill"] = logits.full_tensor()
        if case["cfg"].family in DECODE_FAMILIES:
            res["decode"] = []
            for i in range(LM_RUN["decode"]):
                logits, cache = lm.decode_step(p, cache, toks[:, i:i + 1],
                                               cfg)
                res["decode"].append(logits.full_tensor())

    rules = shd.make_rules("train")
    p, b = on_mesh(cfg, opt.tree_map(torch.clone, case["params"]),
                   case["axes"], batch, rules)
    with steps.sharded(mesh, rules):
        loss, _, grads = steps.loss_and_grads(p, b, cfg)
    res["loss"] = loss.full_tensor().item()
    res["grads"] = gathered(grads)
    plain = gathered(p)
    res["params_from_grads"], _ = opt.adamw_update(
        plain, res["grads"], opt.adamw_init(plain), _opt())
    step = steps.make_train_step(cfg, _opt())
    with steps.sharded(mesh, rules):
        p, _, metrics = step(p, opt.adamw_init(p), b)
    res["step_loss"] = metrics["loss"].full_tensor().item()
    res["params"] = gathered(p)
    return res


DECODE = dict(batch=4, prompt=8, max_seq=16, steps=3)


def _decode_tokens(cfg):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, size=(DECODE["batch"],
                                            DECODE["prompt"]
                                            + DECODE["steps"]))
    return torch.from_numpy(toks.astype(np.int32))


def _decode(params, cfg, cache=None):
    """Prefill's logits and each decode step's, and the cache."""
    from repro_torch.models import lm

    toks = _decode_tokens(cfg)
    p = DECODE["prompt"]
    logits, cache = lm.prefill(params, {"tokens": toks[:, :p]}, cfg,
                               max_seq=DECODE["max_seq"], cache=cache)
    out = [logits]
    for i in range(DECODE["steps"]):
        logits, cache = lm.decode_step(params, cache, toks[:, p + i:p + i + 1],
                                       cfg)
        out.append(logits)
    return out, cache


def _decode_on_mesh(mesh, rules, case):
    """``_decode`` with DTensor parameters and cache: the logits, the
    cache's K spec and each decode step's all-gather result bytes."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.perf import roofline

    cfg = case["cfg"]
    p = steps.distribute(case["params"], steps.param_shardings(
        mesh, rules, case["axes"], case["params"]))
    c_shapes, c_axes = lm.init_decode_cache(cfg, DECODE["batch"],
                                            DECODE["max_seq"], device="cpu")
    cache = steps.distribute(c_shapes, steps.cache_shardings(
        mesh, rules, c_axes, c_shapes))
    tok_sh = shd.NamedSharding(mesh, shd.pspec(rules["batch"], None))
    toks = tok_sh.distribute(_decode_tokens(cfg))
    n = DECODE["prompt"]
    with torch.no_grad(), steps.sharded(mesh, rules):
        logits, cache = lm.prefill(p, {"tokens": toks[:, :n]}, cfg,
                                   max_seq=DECODE["max_seq"], cache=cache)
        out, gathers = [logits.full_tensor()], []
        for i in range(DECODE["steps"]):
            with roofline.record_collectives() as rec:
                logits, cache = lm.decode_step(
                    p, cache, toks[:, n + i:n + i + 1], cfg)
            out.append(logits.full_tensor())
            gathers.append([b for op, b, _ in rec if op == "all-gather"])
    k = cache["layers"]["self"]["k"]
    return {"logits": out, "k_spec": tuple(shd.spec_of(k)),
            "k_layer_bytes": k[0].numel() * k.element_size(),
            "gathers": gathers}


def _cases():
    """Parameters and inputs for the ranks, from seeds, with the
    reference's codeqwen loss and the port's unsharded results."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    cases, want = {}, {}
    cfg = _smoke("codeqwen1.5-7b")
    jcfg = jconfigs.ModelConfig(**dataclasses.asdict(cfg))
    jparams, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    _, axes = lm.init_lm(cfg, device="meta")
    batch = data.batch_for_arch(cfg, 0, 0, 8, 32, device="cpu")
    jloss, _ = jax.jit(lambda p, b: jlm.lm_loss(p, b, jcfg))(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    loss, _, want["codeqwen_grads"] = steps.loss_and_grads(params, batch, cfg)
    want["codeqwen"] = loss.item()
    want["codeqwen_ref"] = float(jloss)
    cases["codeqwen"] = dict(cfg=cfg, params=params, axes=axes, batch=batch)

    cfg = _smoke("minitron-8b")
    params, axes = lm.init_lm(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    batch = data.batch_for_arch(cfg, 0, 0, 8, 32, device="cpu")
    cases["minitron"] = dict(cfg=cfg, params=opt.tree_map(torch.clone, params),
                             axes=axes, batch=batch)
    _, _, want["minitron_grads"] = steps.accumulated_grads(params, batch, cfg,
                                                          n_micro=2)
    step = steps.make_train_step(cfg, _opt(), n_micro=2)
    _, _, m = step(params, opt.adamw_init(params), batch)
    want["minitron"] = m["loss"].item()

    cases["decode"], want["decode"] = {}, {}
    for name, n_kv in (("gqa", 2), ("split_kv", 1)):
        cfg = _smoke("minitron-8b", n_kv_heads=n_kv)
        params, axes = lm.init_lm(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
        cases["decode"][name] = dict(cfg=cfg, params=params, axes=axes)
        with torch.no_grad():
            want["decode"][name], _ = _decode(params, cfg)

    cases["lm"], want["lm"] = {}, {}
    for seed, name in enumerate(LM_CASES, start=7):
        cfg = _lm_config(name)
        params, axes = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu")
        batch = _lm_batch(cfg)
        cases["lm"][name] = dict(cfg=cfg, params=params, axes=axes,
                                 batch=batch)
        with torch.no_grad():
            logits, cache = lm.prefill(params, _prefill_batch(batch), cfg,
                                       max_seq=LM_RUN["seq"])
            toks, decoded = _decode_after_prompt(batch), []
            for i in range(LM_RUN["decode"] if cfg.family in DECODE_FAMILIES
                           else 0):
                out, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                            cfg)
                decoded.append(out)
        loss, _, grads = steps.loss_and_grads(params, batch, cfg)
        step = steps.make_train_step(cfg, _opt())
        _, _, m = step(opt.tree_map(torch.clone, params),
                       opt.adamw_init(params), batch)
        want["lm"][name] = dict(prefill=logits, decode=decoded,
                                loss=loss.item(), grads=grads,
                                step_loss=m["loss"].item())

    cfg = _smoke("olmoe-1b-7b")
    params, axes = lm.init_lm(cfg, torch.Generator().manual_seed(2),
                              device="cpu")
    mp = {k: v[0].clone() for k, v in params["layers"]["moe"].items()}
    max_ = {k: v[1:] for k, v in axes["layers"]["moe"].items()}
    x, w = _moe_inputs(cfg)
    cases["olmoe"] = dict(cfg=cfg, params=mp, axes=max_, x=x, w=w)
    p = opt.tree_map(lambda t: t.clone().requires_grad_(), mp)
    xg = x.clone().requires_grad_()
    y = T.moe(p, xg, cfg)
    (y * w).sum().backward()
    want["moe_out"] = y.detach()
    want["moe_grads"] = {"x": xg.grad, **{k: v.grad for k, v in p.items()}}
    return cases, want


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    store = tmp_path_factory.mktemp("ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, want = _cases()
    finally:
        torch.set_num_threads(threads)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(store), cases))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    got = [torch.load(pathlib.Path(store) / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return got, want


@pytest.mark.parametrize("nbits", CPSUM_BITS)
def test_compressed_psum_mean_is_bit_equal_to_the_reference(session, nbits):
    import jax
    import jax.numpy as jnp

    from repro.dist.collectives import compressed_psum_mean as jcpsum

    got, _ = session
    xs = _cpsum_inputs()
    # op by op: jitted, XLA contracts the residual v - q * scale into one
    # fma, which rounds once where both packages' ops round twice
    fn = jax.vmap(lambda x, e: jcpsum(x, "data", nbits=nbits, err=e),
                  axis_name="data")
    err = jnp.zeros(xs.shape, jnp.float32)
    acc_q = np.zeros(xs.shape[1:], np.float64)
    for r in range(ROUNDS):
        mean, err = fn(jnp.asarray(xs), err)
        mean, res = np.asarray(mean), np.asarray(err)
        for rank in range(WORLD):
            m, e = got[rank][f"cpsum{nbits}"][r]
            np.testing.assert_array_equal(m.numpy(), mean[rank])
            np.testing.assert_array_equal(e.numpy(), res[rank])
        acc_q += got[0][f"cpsum{nbits}"][r][0].numpy()
    # error feedback keeps the accumulated stream unbiased: the reference's
    # bound for its 8-bit test, scaled by the quantization step at 4 bits
    acc_f = ROUNDS * xs.astype(np.float64).mean(axis=0)
    rel = np.linalg.norm(acc_q - acc_f) / np.linalg.norm(acc_f)
    assert rel < 1e-3 * 127 / ((1 << (nbits - 1)) - 1), rel


def _close_leaves(got, want, rtol, *, norm=True):
    """Leaf by leaf: ``|got - want|`` within ``rtol`` of the leaf's largest
    element and (``norm``) ``||got - want||`` within ``rtol`` of its
    norm."""
    from repro_torch.dist.checkpoint import _leaves

    a_l, b_l = _leaves(got), _leaves(want)
    assert len(a_l) == len(b_l)
    for i, (a, b) in enumerate(zip(a_l, b_l)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        d = (a - b).abs()
        assert d.max() <= rtol * b.abs().max(), (i, d.max(), b.abs().max())
        if norm:
            assert d.norm() <= rtol * b.norm(), (i, d.norm(), b.norm())


def test_sharded_codeqwen_loss_matches_unsharded_and_reference(session):
    got, want = session
    for rank in range(WORLD):
        loss = got[rank]["codeqwen_loss"]
        assert abs(loss - want["codeqwen"]) <= 1e-5 * abs(want["codeqwen"])
        assert abs(loss - want["codeqwen_ref"]) <= \
            1e-4 * abs(want["codeqwen_ref"])


@pytest.mark.parametrize("remat", ("none",) + REMATS)
def test_sharded_codeqwen_gradients_match_unsharded(session, remat):
    got, want = session
    key = "codeqwen_grads" + ("" if remat == "none" else f"_{remat}")
    for rank in range(WORLD):
        _close_leaves(got[rank][key], want["codeqwen_grads"], GRAD_RTOL)


def test_sharded_gradient_compression_is_bit_equal(session):
    from repro_torch.dist.checkpoint import _leaves
    from repro_torch.train import optimizer as opt

    got, _ = session
    for rank in range(WORLD):
        grads = got[rank]["codeqwen_grads"]
        q, s, cst = opt.compress_grads(grads, opt.compression_init(grads),
                                       nbits=8)
        for a, b in zip(_leaves(got[rank]["compressed"]),
                        _leaves((q, s, cst.residual)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_zero3_microbatched_gradients_match_unsharded(session):
    got, want = session
    for rank in range(WORLD):
        _close_leaves(got[rank]["minitron_grads"], want["minitron_grads"],
                      GRAD_RTOL)


def test_zero3_microbatched_step_matches_the_unsharded_step(session):
    got, want = session
    for rank in range(WORLD):
        loss = got[rank]["minitron_loss"]
        assert abs(loss - want["minitron"]) <= 1e-5 * abs(want["minitron"])
        # the sharded update is AdamW (clip, decay) on the sharded grads
        _close_leaves(got[rank]["minitron_params"],
                      got[rank]["minitron_params_from_grads"], PARAM_RTOL,
                      norm=False)


@pytest.mark.parametrize("case", ["gqa", "split_kv"])
def test_sharded_decode_matches_unsharded(session, case):
    got, want = session
    for rank in range(WORLD):
        d = got[rank][f"decode_{case}"]
        for a, b in zip(d["logits"], want["decode"][case], strict=True):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
        if case == "split_kv":
            # (layers, batch, seq, kv heads, head dim): seq over "model"
            assert d["k_spec"] == (None, "data", "model", None, None)
            assert all(b < d["k_layer_bytes"] for g in d["gathers"]
                       for b in g), d["gathers"]


@pytest.mark.parametrize("name", list(WRITES))
def test_write_along_a_sharded_sequence_is_bit_equal(session, name):
    got, _ = session
    for rank in range(WORLD):
        r = got[rank]["write_along"][name]
        assert r["spec"] == ("data", "model", None, None)
        assert torch.equal(r["got"], r["want"])
        assert torch.equal(r["got_pos"], r["want_pos"])
        assert r["changed"]  # a write that changes nothing tests nothing


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_along_is_bit_equal_to_the_plain_slices(session, name):
    got, _ = session
    sizes = SPLITS[name][2]
    for rank in range(WORLD):
        r = got[rank]["split_along"][name]
        assert len(r["got"]) == len(sizes)
        for a, b in zip(r["got"], r["want"], strict=True):
            assert torch.equal(a, b)
        assert torch.equal(r["grad"], r["want_grad"])
        assert torch.equal(r["joined"], r["whole"])
        if name == "uneven":
            continue
        # each rank holds its own shard of every piece, laid out as the
        # product, and nothing is gathered: all-to-alls move them (the
        # weight's before the product) and join them back
        assert r["specs"] == [SPLITS["product"][1]] * len(sizes)
        assert r["ops"] == ["all-to-all"], r["ops"]


def test_expert_parallel_moe_matches_single_device(session):
    got, want = session
    scale = want["moe_out"].abs().max()
    for rank in range(WORLD):
        assert got[rank]["moe_taken"] == 1
        assert (got[rank]["moe_out"] - want["moe_out"]).abs().max() \
            <= 1e-5 * scale
        for k, g in want["moe_grads"].items():
            assert (got[rank]["moe_grads"][k] - g).abs().max() <= \
                1e-5 * g.abs().max(), k


def test_gnn_int_forward_under_a_context_is_bit_equal(session):
    got, _ = session
    for rank in range(WORLD):
        want, under = got[rank]["gnn"]
        assert torch.equal(want, under)
        assert got[rank]["dtensor_refused"]
    assert torch.equal(got[0]["gnn"][0], got[WORLD - 1]["gnn"][0])


@pytest.mark.parametrize("name", LM_CASES)
def test_sharded_lm_loss_gradients_and_step_match_unsharded(session, name):
    got, want = session
    w = want["lm"][name]
    for rank in range(WORLD):
        g = got[rank][f"lm_{name}"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
        _close_leaves(g["grads"], w["grads"], GRAD_RTOL
                      if name == "uneven_heads" else SCAN_GRAD_RTOL)
        assert abs(g["step_loss"] - w["step_loss"]) <= \
            1e-5 * abs(w["step_loss"])
        _close_leaves(g["params"], g["params_from_grads"], PARAM_RTOL,
                      norm=False)


@pytest.mark.parametrize("name", LM_CASES)
def test_sharded_lm_prefill_matches_unsharded(session, name):
    got, want = session
    b = want["lm"][name]["prefill"]
    for rank in range(WORLD):
        a = got[rank][f"lm_{name}"]["prefill"]
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("name", ("rwkv6", "zamba2"))
def test_sharded_scan_decode_steps_match_unsharded(session, name):
    got, want = session
    steps_want = want["lm"][name]["decode"]
    assert len(steps_want) == LM_RUN["decode"]
    for rank in range(WORLD):
        for a, b in zip(got[rank][f"lm_{name}"]["decode"], steps_want,
                        strict=True):
            assert a.shape == b.shape and torch.isfinite(a).all()
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("name", ("rwkv6", "zamba2"))
def test_scan_models_gradient_noise(name, monkeypatch):
    """Unsharded, one process: the gradients with the scan's loop form
    against those with its chunk-batched form (the per-rank one). The
    forwards agree to float32 rounding (bit-equal on the CPU measured);
    the backward's summation order differs, and the gradients move by
    float32 noise near 1e-5 of a leaf's largest element, below the bound
    the sharded gradients are held to."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models import ssm as S

    seed = 7 + LM_CASES.index(name)
    cfg = _lm_config(name)
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    batch = _lm_batch(cfg)
    with torch.no_grad():
        h = lm.forward_hidden(params, batch, cfg)
    _, _, loop = steps.loss_and_grads(params, batch, cfg)
    monkeypatch.setattr(S, "_scan", lambda plain, per_rank, args, names,
                        state_at: per_rank(*args))
    with torch.no_grad():
        d = (lm.forward_hidden(params, batch, cfg) - h).abs().max()
    assert d <= 1e-6 * h.abs().max()
    _, _, batched = steps.loss_and_grads(params, batch, cfg)
    _close_leaves(batched, loop, SCAN_GRAD_RTOL)


def test_sharded_rwkv6_layer_ops_do_not_grow_with_the_sequence(session):
    got, _ = session
    short, long_ = OP_SEQS
    for rank in range(WORLD):
        ops = got[rank]["rwkv_ops"]
        assert ops[short] == ops[long_] > 0, ops
        # the count sees the scan: run as DTensor ops it grows with it
        bare = got[rank]["rwkv_ops_dtensor_scan"]
        assert bare[long_] > bare[short] > ops[short], (bare, ops)


def test_the_ranks_import_no_jax():
    # the ranks import this module: its top level imports no JAX
    src = pathlib.Path(__file__).read_text()
    head = src[:src.index("def _smoke")]
    assert "import jax" not in head and "from repro." not in head
