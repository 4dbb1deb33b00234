"""Quantizers, bit-plane packing and zero-tile artifacts (paper §3, §4.2, §4.3)."""
