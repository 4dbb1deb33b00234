"""The paper-figure suites on the port (the reference's ``benchmarks/``).

Each suite keeps the reference's defaults, emitted names and ``derived``
columns, runs on the ``cuda`` engine wherever the reference names
``pallas`` or ``xla_dot``, and takes ``device=`` (``None``: the card) and
size arguments. Run them all with ``python -m repro_torch.benchmarks.run``.
They live inside the package, apart from the reference's ``benchmarks/``.
"""
