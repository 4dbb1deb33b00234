"""End-to-end example: train a ~100M-parameter LM for a few hundred steps on
the deterministic synthetic stream, with checkpoints.

Uses the codeqwen1.5 family scaled to ~100M (``--arch`` picks any
architecture; its dims are overridden to hit the parameter budget),
through ``launch.steps.make_train_step`` on the card (``--device cpu`` for
the CPU). A checkpoint every 100 steps under ``--ckpt-dir``. Each step's
wall time ends in a read of the loss to the host and feeds the straggler
watchdog, whose p50 is printed at the end (the reference passes it the
time since the loop began instead).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m \\
          [--steps 300] [--small] [--smoke] [--device cpu]
"""
import argparse
import dataclasses
import json
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.elastic import StragglerWatchdog
from repro_torch.launch import steps as step_lib
from repro_torch.models import lm
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="~27M variant for quick CPU runs")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: ~27M dims, a handful of steps")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.small = True
    # --smoke only changes the DEFAULTS; explicit flags always win
    smoke = args.smoke
    args.steps = args.steps if args.steps is not None else (3 if smoke else 300)
    args.batch = args.batch if args.batch is not None else (2 if smoke else 8)
    args.seq = args.seq if args.seq is not None else (32 if smoke else 256)

    base = configs.get(args.arch)
    # ~100M-parameter variant of the same family (--small: ~27M)
    dims = (dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=4,
                 d_ff=1536, vocab=8192) if args.small else
            dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                 d_ff=2816, vocab=16384))
    cfg = dataclasses.replace(
        base, **dims, d_head=64, remat="none",
        moe_experts=8 if base.moe_experts else 0,
        moe_top_k=2 if base.moe_top_k else 0,
        enc_layers=2 if base.enc_layers else 0,
        n_frames=64 if base.n_frames else 0,
        n_patches=16 if base.n_patches else 0,
        attn_every=2 if base.attn_every else 0,
        ssm_state=16 if base.ssm_state else 0)

    params, _ = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n = lm.param_count(params)
    print(f"# {args.arch} ~100M variant: {n / 1e6:.1f}M params on {dev}")
    ostate = opt.adamw_init(params)
    ocfg = opt.AdamWConfig(lr=args.lr, grad_clip=1.0)
    step_fn = step_lib.make_train_step(cfg, ocfg, q_chunk=256, t_chunk=128)
    watchdog = StragglerWatchdog()
    losses = []
    t_loop = time.perf_counter()
    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = data_lib.batch_for_arch(cfg, 0, step, args.batch, args.seq,
                                        device=dev)
        params, ostate, metrics = step_fn(params, ostate, batch)
        losses.append(metrics["loss"].item())
        watchdog.observe(step, time.perf_counter() - t0)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            rec = {"step": step, "loss": round(losses[-1], 4),
                   "elapsed_s": round(time.perf_counter() - t_loop, 1)}
            print(f"# {json.dumps(rec)}", flush=True)
        if args.ckpt_dir and (step + 1) % 100 == 0:
            ckpt.save(args.ckpt_dir, step + 1, (params, ostate))
    total = time.perf_counter() - t_loop
    print(f"# done in {total:.1f}s; p50 step {watchdog.p50:.3f}s")
    print("OK")
    return {"params": n, "losses": losses, "p50_s": watchdog.p50,
            "seconds": total, "device": str(dev)}


if __name__ == "__main__":
    main()
