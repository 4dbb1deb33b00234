"""Deterministic, counter-addressed synthetic LM data, as the reference's
``repro.train.data``.

A batch is a pure function of (seed, step): no file offsets, no iterator
state, so a job restarted at step N regenerates the batches N, N+1, ...
that the dead job would have seen.

The stream is a learnable synthetic language: each sequence follows an
affine recurrence ``tok[t+1] = (a * tok[t] + c) % V`` with V = min(vocab,
256) and (a, c) one of four "dialects", drawn per sequence. The draws come
from a ``torch.Generator`` seeded from (seed, step) on the host, so they
are the same on every device; they are not the reference's tokens (JAX's
threefry stream is not reproduced), only its dialects and recurrence.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["synthetic_batch", "batch_for_arch"]

_DIALECTS_A = (5, 13, 29, 37)
_DIALECTS_C = (7, 11, 3, 17)


def _generator(*words: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def synthetic_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
                    device=None):
    """(tokens, labels), int32 (batch, seq), for ``step`` on ``device``
    (None means the card); pure in (seed, step)."""
    gen = _generator(0, int(seed), int(step))
    v = min(vocab, 256)  # small working set => fast learnability
    start = torch.randint(0, v, (batch,), generator=gen)
    dial = torch.randint(0, len(_DIALECTS_A), (batch,), generator=gen)
    a = torch.tensor(_DIALECTS_A)[dial]
    c = torch.tensor(_DIALECTS_C)[dial]
    toks = torch.empty((batch, seq + 1), dtype=torch.int64)
    toks[:, 0] = start
    for i in range(seq):
        toks[:, i + 1] = (a * toks[:, i] + c) % v
    dev = resolve_device(device)
    tokens = toks[:, :-1].to(torch.int32).to(dev)
    labels = toks[:, 1:].to(torch.int32).to(dev)
    return tokens, labels


def batch_for_arch(cfg, seed: int, step: int, batch: int, seq: int,
                   device=None) -> dict:
    """Full input dict for any arch, the stub modality tensors included
    (bf16 patches for vlm, frames for audio_encdec, 0.1 x a normal draw)."""
    tokens, labels = synthetic_batch(seed, step, batch=batch, seq=seq,
                                     vocab=cfg.vocab, device=device)
    out = {"tokens": tokens, "labels": labels}
    gen = _generator(1, int(seed), int(step))
    if cfg.family == "vlm":
        out["patches"] = (0.1 * torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=gen,
            dtype=torch.bfloat16)).to(tokens.device)
    if cfg.family == "audio_encdec":
        out["frames"] = (0.1 * torch.randn(
            (batch, cfg.n_frames, cfg.d_model), generator=gen,
            dtype=torch.bfloat16)).to(tokens.device)
    return out
