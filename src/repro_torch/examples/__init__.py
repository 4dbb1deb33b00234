"""Runnable examples of the port (the reference's ``examples/``), kept in
the package: ``python -m repro_torch.examples.train_cluster_gcn``."""
