"""Launchers (the reference's ``repro.launch``): ``serve`` in its GNN mode."""
