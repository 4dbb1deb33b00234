"""The paper's own workloads: Cluster-GCN and Batched GIN (QGTC §6.1).

3-layer GCN with 16 hidden / 3-layer GIN with 64 hidden, any-bitwidth
quantized per GNNConfig; datasets per Table 1 (graph/datasets.py).
"""
from repro_torch.models.gnn import GNNConfig

GNN_CONFIGS = {
    "qgtc-gcn": GNNConfig(model="gcn", in_dim=128, hidden=16, n_classes=40,
                          layers=3, x_bits=8, w_bits=8),
    "qgtc-gin": GNNConfig(model="gin", in_dim=128, hidden=64, n_classes=40,
                          layers=3, x_bits=8, w_bits=8),
}
