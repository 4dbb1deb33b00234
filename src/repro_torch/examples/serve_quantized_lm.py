"""Serve a small LM with batched requests through the decode engine,
comparing bf16 weights with QGTC weight-only 4-bit quantization (the
paper's bit compression applied to the memory-bound decode path).

Weight quantization goes through ``repro_torch.api.nn.quantize_lm_params``,
the same registry-dispatched pipeline ``repro_torch.launch.serve
--wq-bits`` uses; the per-layer matmul primitive is
``repro_torch.api.nn.wq_linear``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized_lm \\
          [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import api, configs
from repro_torch.api import nn as qnn
from repro_torch.core.qgemm import weight_quantize
from repro_torch.device import resolve_device
from repro_torch.launch.serve import DecodeEngine
from repro_torch.models import lm
from repro_torch.train import data as data_lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.smoke_config(configs.get("codeqwen1.5-7b"))
    cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, d_ff=256)
    params, _ = lm.init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    # --- QGTC weight-only quantization of every 2-D projection -------------
    params_q, st = qnn.quantize_lm_params(params, nbits=4)
    print(f"# weight-only 4-bit: {st['n_quantized']} projections, "
          f"{st['bytes_fp16'] / 1e6:.1f} MB bf16 -> "
          f"{st['bytes_packed'] / 1e6:.1f} MB packed "
          f"({st['ratio']:.1f}x smaller in memory)")

    # the per-layer primitive dispatches through the engine registry
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.normal(size=(4, 128)), dtype=torch.float32,
                      device=dev)
    wq = weight_quantize(torch.tensor(rng.normal(size=(128, 64)),
                                      dtype=torch.float32, device=dev), 4)
    y = qnn.wq_linear(xs, wq, out_dtype=torch.float32)
    print(f"# wq_linear through {api.current()[0].name}: {tuple(y.shape)}")

    engine_fp = DecodeEngine(cfg, params, batch_slots=4, max_seq=64)
    engine_q4 = DecodeEngine(cfg, params_q, batch_slots=4, max_seq=64)
    toks, _ = data_lib.synthetic_batch(0, 0, batch=4, seq=24,
                                       vocab=cfg.vocab, device="cpu")
    out_fp, st_fp = engine_fp.generate(toks.numpy(), max_new=12)
    out_q4, st_q4 = engine_q4.generate(toks.numpy(), max_new=12)
    agree = float((out_fp == out_q4).mean())
    print(f"# bf16 engine: {st_fp}")
    print(f"# w4 engine:   {st_q4}")
    print(f"# greedy token agreement bf16 vs w4: {agree:.2%} "
          f"(random-init model: any overlap indicates consistent decode)")
    print("OK")
    return {"n_quantized": st["n_quantized"], "agreement": agree,
            "bf16": st_fp, "w4": st_q4}


if __name__ == "__main__":
    main()
