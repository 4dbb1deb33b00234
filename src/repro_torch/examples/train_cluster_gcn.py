"""End-to-end example: quantization-aware training of Cluster-GCN on a
Table-1-style graph, then deployment through the integer QGTC path.

The full paper pipeline on the port: partition -> batch -> QAT train ->
quantize -> serve with packed transfers + zero-tile accounting, on the
card (``--device cpu`` for the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_cluster_gcn \\
          [--steps 200] [--device cpu]
      (add --int-path to train through the integer bitserial kernels)
"""
import argparse
import json
import time

from repro_torch.device import resolve_device
from repro_torch.graph import batching, datasets, partition
from repro_torch.models import gnn
from repro_torch.serve.engine import GNNServer
from repro_torch.train import trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-arxiv")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--int-path", action="store_true",
                    help="train through the integer bitserial forward "
                         "(path='int_bitserial') instead of fake-quant QAT")
    ap.add_argument("--grad-bits", type=int, default=0,
                    help="int path: also quantize backward GEMMs")
    ap.add_argument("--stochastic", action="store_true",
                    help="int path: stochastic rounding of activations/grads")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"# loading {args.dataset} (scale={args.scale})")
    data = datasets.load(args.dataset, scale=args.scale)
    print(f"#   |V|={data.csr.n} |E|={data.csr.e} dim={data.features.shape[1]} "
          f"classes={data.n_classes}")

    print(f"# partitioning into {args.parts} subgraphs (METIS-substitute)")
    parts = partition.partition(data.csr, args.parts)
    cut = partition.edge_cut(data.csr, parts)
    rcut = partition.edge_cut(
        data.csr, partition.random_partition(data.csr.n, args.parts))
    print(f"#   edge cut {cut} vs random {rcut} ({rcut / max(cut,1):.1f}x better)")

    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes,
                                  x_bits=args.bits, w_bits=args.bits)
    mode = "integer bitserial" if args.int_path else "QAT (fake-quant)"
    print(f"# {mode} training: 3-layer GCN, 16 hidden, {args.bits}-bit, on {dev}")
    tcfg = trainer.TrainConfig(
        steps=args.steps, log_every=max(args.steps // 8, 1),
        path="int_bitserial" if args.int_path else "fake",
        grad_bits=args.grad_bits, stochastic=args.stochastic)
    t_train = time.time()
    params, _, hist = trainer.train(data, parts, cfg, tcfg, batch_size=4,
                                    device=dev)
    t_train = time.time() - t_train
    for rec in hist:
        print(f"#   {json.dumps(rec)}")
    print(f"#   {t_train:.1f}s total, {t_train / max(args.steps, 1) * 1e3:.2f}"
          f" ms/step")

    acc_fp = trainer.evaluate(params, data, parts, cfg, qat=True, device=dev)
    print(f"# QAT test accuracy: {acc_fp:.4f}")

    print("# quantizing weights and serving through the integer QGTC path")
    qparams = gnn.quantize_params(params, cfg)
    server = GNNServer(qparams, cfg, feat_bits=args.bits, devices=[dev])
    correct = total = 0
    for b in batching.make_batches(data, parts, 4, shuffle=False):
        preds = server.infer_batch(b)
        y = b.labels[:b.n_valid]
        test = ~b.train_mask[:b.n_valid] & (y >= 0)
        correct += int(((preds == y) & test).sum())
        total += int(test.sum())
    acc_int = correct / max(total, 1)
    print(f"# integer-path test accuracy: {acc_int:.4f}")
    st = server.stats
    print(f"# serving stats: {st.batches} batches, {st.nodes} nodes, "
          f"zero-tile skip ratio {st.zero_tile_skip_ratio:.1%}, "
          f"packed transfer {st.transfer_bytes / 1e6:.2f} MB, "
          f"p50 {st.p50_s * 1e3:.1f} ms / p95 {st.p95_s * 1e3:.1f} ms, "
          f"{st.nodes_per_s:.0f} nodes/s")
    print("OK")
    return {"history": hist, "qat_acc": acc_fp, "int_acc": acc_int,
            "serve": st.summary()}


if __name__ == "__main__":
    main()
