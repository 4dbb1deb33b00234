"""Quickstart: the QGTC public API on PyTorch, the paper's §5 tour.

  1. quantize float tensors to any bitwidth -> BitTensor (3D-stacked packed),
     and the same packing through the ``bitpack`` engine op
  2. exact any-bitwidth matmul by 1-bit composition (bitMM2Int /
     bitMM2Bit), the requantizing epilogue fused into the GEMM too
  3. engine selection through the ``repro_torch.api`` registry: the same
     call runs on torch_dot (integer matmul), popcount (bit-serial oracle)
     or cuda (the hand-written kernels), each exact
  4. an ExecutionPolicy tuning zero-tile jumping on a sparse adjacency

It runs on the card unless ``--device cpu`` is given; without a card it
raises. On CPU tensors the cuda engine runs its kernels' plain versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import api
from repro_torch.core import bitops, bittensor as bt
from repro_torch.core.zerotile import occupancy_stats, tile_occupancy
from repro_torch.device import resolve_device


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.cpu().to(torch.int64)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The integer matmul on the host (the card has no int64 matmul)."""
    return _host(a) @ _host(b)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default: the card) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # --- 1. any-bitwidth quantization into the bit-Tensor type --------------
    x = torch.randn((64, 256), generator=gen, device=dev)   # activations
    w = torch.randn((256, 32), generator=gen, device=dev)   # weights
    tx = bt.to_bit(x, nbits=3, pack_axis=1)   # 3-bit, packed along K (Fig. 4b)
    tw = bt.to_bit(w, nbits=2, pack_axis=0)   # 2-bit, packed along K (Fig. 4c)
    print(f"x: fp32 {tx.logical_nbytes_fp32}B -> 3-bit packed {tx.nbytes}B "
          f"({tx.logical_nbytes_fp32 / tx.nbytes:.1f}x smaller)")
    # the same quantize-and-pack in one engine op (the bitpack kernel)
    packed = api.bitpack(x, tx.qp.scale, tx.qp.zero, nbits=3)
    assert torch.equal(packed, tx.data)
    print("bitpack == to_bit: exact")

    # --- 2. exact integer matmul by 1-bit composition (paper Eq. 5/6) -------
    prod = bt.bitmm2int(tx, tw)               # == quantize(x) @ quantize(w)
    ref = _int_mm(bt.to_val(tx), bt.to_val(tw))
    assert torch.equal(_host(prod), ref)
    print("bitmm2int == integer matmul: exact")

    # low-bit output for the next layer (inter-layer fusion contract, §4.5)
    nxt = bt.bitmm2bit(tx, tw, out_bits=4)
    print(f"bitmm2bit -> {nxt.nbits}-bit BitTensor, shape {nxt.shape}")
    # the requantize inside the GEMM's epilogue: within one level of it
    fused = bt.bitmm2bit(tx, tw, out_bits=4, out_qp=nxt.qp,
                         policy=api.ExecutionPolicy(fused_requantize=True))
    gap = (bt.to_val(fused) - bt.to_val(nxt)).abs().max().item()
    assert gap <= 1, gap
    print(f"bitmm2bit, fused epilogue: within {gap} level of the unfused")

    # --- 3. pick the execution engine through the registry ------------------
    print(f"registered backends: {api.list_backends()}")
    for name in api.list_backends():          # every engine: identical int32s
        with api.use(name):
            got = bt.bitmm2int(tx, tw)
        assert torch.equal(_host(got), ref), name
    print(f"{' == '.join(api.list_backends())}: exact")
    # a per-call override beats the context:
    with api.use("torch_dot"):
        got = bt.bitmm2int(tx, tw, backend="cuda")
    assert torch.equal(_host(got), ref)

    # --- 4. an ExecutionPolicy tunes zero-tile jumping (paper §4.3) ---------
    # block-diagonal adjacency: the structure batched METIS subgraphs produce
    adj = torch.zeros((256, 256), dtype=torch.int32, device=dev)
    for i in range(2):
        blk = slice(i * 128, (i + 1) * 128)
        adj[blk, blk] = (torch.rand((128, 128), generator=gen, device=dev)
                         < 0.05).to(torch.int32)
    feat = torch.randint(0, 2, (256, 64), generator=gen, device=dev,
                         dtype=torch.int32)                  # binary features
    ap = bitops.pack_a(adj, 1)[0]
    fp = bitops.pack_b(feat, 1)[0]
    skip = api.ExecutionPolicy(jump="compact")               # skip zero tiles
    out = api.bgemm(ap, fp, backend="cuda", policy=skip)
    assert torch.equal(_host(out), _int_mm(adj, feat))
    app = bitops.pad_to(bitops.pad_to(ap, 0, skip.block_m), 1, skip.block_w)
    st = occupancy_stats(tile_occupancy(app, skip.block_m, skip.block_w))
    print(f"zero-tile jumping: skipped {st['skip_ratio']:.0%} of "
          f"{st['tiles_total']} TC tiles, result exact")
    print("OK")
    return {"fp32_bytes": tx.logical_nbytes_fp32, "packed_bytes": tx.nbytes,
            "x": x.cpu(), "w": w.cpu(), "adj": adj.cpu(),
            "skip_ratio": st["skip_ratio"], "tiles_total": st["tiles_total"]}


if __name__ == "__main__":
    main()
