"""Launchers (the reference's ``repro.launch``): ``serve`` in its GNN mode
and ``sweep`` (a policy grid measured into a tuning table)."""
