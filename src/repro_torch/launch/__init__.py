"""Launchers (the reference's ``repro.launch``): ``serve`` in its GNN mode,
``sweep`` (a policy grid measured into a tuning table) and ``lint`` (the
contract lint and the trace checker)."""
