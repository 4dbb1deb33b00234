"""Measurement helpers of the port (the reference's ``repro.perf``)."""
