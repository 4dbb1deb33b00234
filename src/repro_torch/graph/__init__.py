"""Graph substrate: datasets, partitioning, subgraph batching (paper §4.1)."""
