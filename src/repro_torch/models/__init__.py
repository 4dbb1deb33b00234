"""Models: the paper's Cluster-GCN and GIN."""
