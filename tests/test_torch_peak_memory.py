"""``perf.roofline.PeakMemory``, the dry run's per-device peak, on the CPU (no
JAX).

- Hand-computed peaks: a chain of ops, views and in-place ops (no bytes), a
  ``del``, a replaced leaf (its old storage's death frees its bytes), an
  autograd backward and a checkpointed block.
- The same step on ``meta`` and on real CPU tensors reads the same peak:
  train, prefill and decode of one smoke config per family.
- On a fake 16x16 group (a subprocess running this file): DTensor's own
  redistributions reach the memory and the collective records; and the
  cross-entropy's forward and backward allocate no storage spanning the
  global batch (each at most the rank's batch shard, the full vocabulary),
  where DTensor's gather backward made a (global batch, t_chunk, vocab)
  float32 zero tensor on every rank.
"""
import gc
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.perf.roofline import PeakMemory, record_collectives  # noqa: E402

N = 1024
U = 4 * N  # bytes of one float32 vector of N


def test_chain_views_in_place_and_del():
    x = torch.ones(N)  # resident before the window: not counted
    with PeakMemory() as m:
        a = x * 2                     # +U                      U
        v, t = a[1:], a.view(32, 32).t()  # views: nothing
        a.add_(1)                     # in place: nothing
        v.mul_(3)
        b = a + x                     # +U                      2U
        del a, v, t                   # a's storage dies: -U    U
        c = b * b                     # +U                      2U
        s = c.sum()                   # +4                      2U + 4
        live = m.live
    assert (m.peak_bytes, live) == (2 * U + 4, 2 * U + 4)
    # element 0 is outside the view: (2 + 1 + 1)^2; the rest (3 * 3 + 1)^2
    assert float(s) == 16 + (N - 1) * 100
    top = {r["op"]: (r["bytes"], r["count"]) for r in m.top()}
    assert top == {"aten.add.Tensor": (U, 1), "aten.mul.Tensor": (U, 1),
                   "aten.sum.default": (4, 1)}


def test_a_replaced_resident_leaf_frees_its_bytes():
    # the optimizer's in-place update: the new leaf is allocated, the old
    # one (an argument, never counted) dies when it leaves the tree
    tree = {"w": torch.ones(N), "b": torch.ones(N)}
    with PeakMemory() as m:
        for k in tree:
            tree[k] = tree[k] * 0.5   # +U, then the old leaf: -U
        live = m.live
    assert (m.peak_bytes, live) == (U, 0)


def test_autograd_backward():
    w = torch.randn(N, requires_grad=True)
    with PeakMemory() as m:
        y = (w * w).sum()   # w*w (U) dies once sum has it: y (4)
        y.backward()        # seed 1.0 (4); MulBackward: grad*w for each
        #                     input (2U); the engine adds them (+U)
        live = m.live
    assert m.peak_bytes == 3 * U + 8
    assert live == U + 4    # w.grad (the sum) and y
    assert torch.equal(w.grad, 2 * w.detach())


@pytest.mark.parametrize("ckpt", [False, True])
def test_checkpointed_block(ckpt):
    from torch.utils.checkpoint import checkpoint

    def block(x):
        return (x * 2).sin() * 3

    x = torch.randn(N, requires_grad=True)
    with PeakMemory() as m:
        out = (checkpoint(block, x, use_reentrant=False) if ckpt
               else block(x))
        # kept for backward without checkpoint: sin's input x*2 (U) and
        # the output (U); with it, the output alone
        kept = m.live
        out.sum().backward()
    assert kept == (U if ckpt else 2 * U)
    # backward: the sum's seed (4, the sum itself 4); the scalar product's
    # gradient (U), cos (U) and the product by it (U) beside the kept
    # output, x*2 (kept, or recomputed with sin and the product, of which
    # only x*2 stays live), and the output; the sum and seed bytes
    assert m.peak_bytes == 5 * U + 8


FAMILIES = ("codeqwen1.5-7b", "olmoe-1b-7b", "internvl2-2b", "rwkv6-1.6b",
            "zamba2-7b", "whisper-large-v3")


def _family_step(arch, kind, device):
    """The step's peak on ``device`` for ``arch``'s smoke config."""
    from repro_torch import configs
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    gc.collect()  # no garbage of an earlier test dies inside the window
    cfg = smoke_config(configs.get(arch))
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params, _ = lm.init_lm(cfg, gen, device=device)
    batch = {k: v.to(device) for k, v in
             data.batch_for_arch(cfg, 0, 0, 2, 16, device="cpu").items()}
    if kind == "train":
        step = steps.make_train_step(cfg, opt.AdamWConfig(lr=1e-3,
                                                          grad_clip=1.0))
        ostate = opt.adamw_init(params)
        with PeakMemory() as m:
            step(params, ostate, batch)
        return m.peak_bytes, m.top()
    prefill = steps.make_prefill_fn(cfg, max_seq=24)
    if kind == "prefill":
        with PeakMemory() as m:
            prefill(params, batch)
        return m.peak_bytes, m.top()
    _, cache = prefill(params, batch)
    decode = steps.make_decode_fn(cfg)
    tokens = batch["tokens"][:, -1:]
    with PeakMemory() as m:
        decode(params, cache, tokens)
    return m.peak_bytes, m.top()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_reads_the_peak_of_real_tensors(arch, kind):
    # a first step in a process fills caches of scalars (tens of bytes)
    _family_step(arch, kind, "cpu")
    cpu = _family_step(arch, kind, "cpu")
    meta = _family_step(arch, kind, "meta")
    assert cpu[0] > 0
    assert meta == cpu


# ---------------------------------------------------------------- fake group

def _on_fake_group():
    """Run in a subprocess: prints one JSON line of what the tests below
    check, on a fake 16x16 group of 256 ranks."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import configs
    from repro_torch.configs.base import smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    from repro_torch.perf import roofline

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = make_production_mesh()
    out = {}

    # an operand DTensor redistributes inside the op's own dispatch: an
    # all-gather of b's rows over "data" for the product
    def dt(shape, place):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 place, src_data_rank=None)

    a = dt((1024, 64), [Shard(1), Replicate()])
    b = dt((1024, 32), [Shard(1), Replicate()])
    peak = PeakMemory()
    with record_collectives(memory=peak) as recs:
        c = a.T @ b
    out["dispatch"] = {"records": recs, "peak": peak.peak_bytes,
                       "top": peak.top(), "out_local": list(
                           c.to_local().shape)}

    # the cross-entropy of a vocabulary split over "model", batch over
    # "data", forward and backward, every allocation it makes
    cfg = dataclasses.replace(smoke_config(configs.get("codeqwen1.5-7b")),
                              vocab=4096)
    B, T, D, V, t_chunk = 32, 16, cfg.d_model, cfg.padded_vocab, 8
    rules = shd.make_rules("train")
    seen = []
    watch = roofline.PeakMemory._watch

    def logged(self, st, nbytes, info):
        if nbytes:
            seen.append([str(info[0]), list(info[1]), str(info[2]), nbytes])
        return watch(self, st, nbytes, info)

    roofline.PeakMemory._watch = logged
    with shd.sharded(mesh, rules):
        h = shd.NamedSharding(mesh, shd.pspec("data", None, None)).distribute(
            torch.empty((B, T, D), device="meta")).requires_grad_()
        head = shd.NamedSharding(mesh, shd.pspec(None, "model")).distribute(
            torch.empty((D, V), device="meta")).requires_grad_()
        labels = shd.NamedSharding(mesh, shd.pspec("data", None)).distribute(
            torch.zeros((B, T), dtype=torch.int32, device="meta"))
        with PeakMemory():
            loss, _ = lm.chunked_cross_entropy(h, head, labels,
                                               t_chunk=t_chunk)
            loss.backward()
        out["ce"] = {"B": B, "t_chunk": t_chunk, "V": V, "shards": 16,
                     "head_grad_local": list(head.grad.to_local().shape),
                     "allocations": seen}
    roofline.PeakMemory._watch = watch
    dist.destroy_process_group()
    print(json.dumps(out))


@pytest.fixture(scope="module")
def fake_group():
    done = subprocess.run([sys.executable, __file__], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_dtensor_dispatch_temporaries_reach_the_memory(fake_group):
    r = fake_group["dispatch"]
    # a: (1024, 64) columns split over 16 "data" ranks -> local (1024, 4),
    # b: local (1024, 2); a.T @ b (64, 32) comes out split by rows, (4, 32)
    # a rank: DTensor gathers the (64, 32) float32 product inside the
    # dispatch (on a CPU mesh its column-to-row move is an all-gather and
    # a local chunk), and the recorder records that all-gather
    assert r["records"] == [["all-gather", 64 * 32 * 4, 16]]
    assert r["out_local"] == [4, 32]
    gathered = [t for t in r["top"] if "all_gather" in t["op"]]
    assert gathered, r["top"]
    # the gathered operand is live beside the product's local rows
    assert r["peak"] >= gathered[0]["bytes"] + 4 * 32 * 4


def test_cross_entropy_allocates_no_global_batch(fake_group):
    r = fake_group["ce"]
    b_loc = r["B"] // r["shards"]
    assert r["allocations"]
    v_loc = r["V"] // r["shards"]
    for op, shape, dtype, nbytes in r["allocations"]:
        # no (global batch, t_chunk, a slice of the vocabulary or all of it)
        assert not (len(shape) == 3 and shape[0] == r["B"]
                    and shape[-1] >= v_loc), (op, shape)
        # each at most the rank's batch shard of the chunk's logits
        assert nbytes <= b_loc * r["t_chunk"] * r["V"] * 4, (op, shape)
    # the head's gradient comes back in its own layout: its vocabulary
    # slice (D = 64 rows)
    assert r["head_grad_local"] == [64, v_loc]


if __name__ == "__main__":
    _on_fake_group()
