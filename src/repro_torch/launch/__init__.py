"""Launchers (the reference's ``repro.launch``): ``train`` (LM and GNN
training with checkpoints, resume and failure injection) over ``steps``
(the train step and the prefill / decode factories), ``serve`` (LM decode
and GNN continuous batching), ``sweep`` (a policy grid measured into a
tuning table) and ``lint`` (the contract lint and the trace checker)."""
