"""Dispatch-level checker for the port's execution contracts.

The lint rules catch what the source shows; this module checks what the
ops actually run. The port has no jaxprs, and ``torch.fx``/``torch.export``
cannot follow the kernels' ctypes launches or their data-dependent tile
grids, so each op runs once on small concrete inputs under a recording
``TorchDispatchMode``, and every aten op it saw is inspected:

  * **Integer purity.** Every registered engine's ``bgemm``,
    ``bitserial_mm`` (bits 1..8 plus 1x8 and 8x1), jump ``mask``,
    ``tiles=`` compact and sgt paths, and ``tiles=`` stripped on engines
    without the capability: no aten op touches a float tensor, except pure
    data movement. The fused §4.5 path is float by design in its
    epilogue; there no float GEMM may run (``mm``, ``addmm``, ``bmm``,
    ``matmul``, ``linear``, convolutions, ``_scaled_mm``), float ops come
    only from the elementwise epilogue's allowlist, and the output is an
    integer.
  * **The ``tiles=`` contract.** A device-tensor ``s_max`` raises
    TypeError; an unknown tag raises ValueError.
  * **The kernels ran.** On the card a hand-written kernel is a ctypes
    call the dispatch mode cannot see, so for the ``cuda`` engine each
    integer op must also have moved the launch counters
    (``kernels/_build.py LAUNCHES``).
  * **The int training step.** ``models.gnn.forward_int`` over synthetic
    ``IntBatchArtifacts`` and its backward with ``grad_bits = nbits``, on
    every engine at 4 and 8 bits: no float GEMM.
  * **Policy sites.** Every literal ``ExecutionPolicy`` site the lint
    collects is constructed again; dynamic sites are counted.

The entry points run on the card unless ``device="cpu"`` is passed
(there the ``cuda`` engine runs each kernel's plain version), and raise
without a card otherwise. ``python -m repro_torch.analysis.trace``, or
``python -m repro_torch.launch.lint --trace``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.device import resolve_device

__all__ = ["run_trace_checks", "check_backend", "check_policy_sites",
           "check_train_path", "record_ops", "float_ops", "main"]

# aten ops that move or build tensors without float arithmetic
DATA_MOVEMENT = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "scalar_tensor", "fill", "fill_",
    "zero_", "copy_", "_to_copy", "clone", "contiguous", "view",
    "_unsafe_view", "_reshape_alias", "reshape", "as_strided", "expand",
    "permute", "transpose", "t", "slice", "select", "narrow", "index",
    "index_select", "gather", "cat", "stack", "constant_pad_nd", "squeeze",
    "unsqueeze", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "split", "split_with_sizes", "unbind", "repeat", "flatten", "unflatten",
    "_local_scalar_dense", "set_", "resize_",
}
# the reference's _EPILOGUE_OK (analysis/trace.py) in aten spelling: data
# movement plus the §4.5 epilogue's elementwise rescale and requantize
EPILOGUE_OK = DATA_MOVEMENT | {
    "mul", "add", "sub", "rsub", "div", "maximum", "minimum", "max", "min",
    "clamp", "clamp_min", "clamp_max", "floor", "ceil", "sign", "abs", "neg",
    "relu", "ge", "gt", "le", "lt", "eq", "ne", "where", "masked_fill",
    "scatter", "index_put",
}
# GEMMs that must never run in float on an integer path
GEMM_OPS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear",
            "mv", "addmv", "dot", "vdot", "convolution", "_convolution",
            "_scaled_mm"}


def _is_float(x) -> bool:
    return (isinstance(x, torch.Tensor)
            and (x.dtype.is_floating_point or x.dtype.is_complex))


class _Recorder(TorchDispatchMode):
    """Records ``(aten op name, touches a float tensor)`` per op run."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, bool]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen, _ = tree_flatten((args, kwargs, out))
        self.ops.append((func.overloadpacket.__name__,
                         any(_is_float(x) for x in seen)))
        return out


def record_ops(fn, *args):
    """``(fn(*args), [(aten op, touches float)])``."""
    rec = _Recorder()
    with rec:
        out = fn(*args)
    return out, rec.ops


def float_ops(ops) -> list[str]:
    """Names of the recorded ops that touched a float tensor."""
    return [name for name, flt in ops if flt]


def _purity_failures(ops, out, label, *, fused: bool) -> list:
    fails = []
    for name in float_ops(ops):
        if not fused:
            if name not in DATA_MOVEMENT:
                fails.append(f"{label}: float op {name!r} in a non-fused "
                             f"integer path")
        elif name in GEMM_OPS:
            fails.append(f"{label}: {name!r} runs in float: the GEMM itself "
                         f"must stay integer even on the fused path")
        elif name not in EPILOGUE_OK:
            fails.append(f"{label}: float op {name!r} outside the "
                         f"elementwise §4.5 epilogue allowlist")
    if _is_float(out):
        fails.append(f"{label}: float output dtype {out.dtype}: every "
                     f"bitserial/bgemm path returns integers")
    return sorted(set(fails))


def _launch_counts() -> dict:
    # lint: allow[api-dispatch-bypass] — reads the launch counters only
    from repro_torch.kernels import _build
    return dict(_build.LAUNCHES)


# ------------------------------------------------------------ the harness

def _operands(m, k, n, s, t, dev):
    from repro_torch.core import bitops
    rng = np.random.default_rng(s * 8 + t)
    a = torch.as_tensor(rng.integers(0, 1 << s, (m, k)).astype(np.int32),
                        device=dev)
    b = torch.as_tensor(rng.integers(0, 1 << t, (k, n)).astype(np.int32),
                        device=dev)
    return bitops.pack_a(a, s), bitops.pack_b(b, t)


def check_backend(be, *, device=None, bits=range(1, 9),
                  shape=(16, 256, 128), log=lambda *_: None) -> tuple:
    """Run one engine's ops across bit widths under the recorder; returns
    ``(checks_run, failures)``."""
    from repro_torch import api
    from repro_torch.api.backends import CudaBackend
    from repro_torch.api.policy import DEFAULT_POLICY
    from repro_torch.core import zerotile
    from repro_torch.kernels import sgt as sgt_lib

    dev = resolve_device(device)
    be = api.get_backend(be)
    pol = DEFAULT_POLICY  # explicit: dispatch never consults a table
    m, k, n = shape
    launches = dev.type == "cuda" and isinstance(be, CudaBackend)
    checks, fails = 0, []

    def run(label, fn, *args, fused=False):
        nonlocal checks
        checks += 1
        before = sum(_launch_counts().values())
        try:
            out, ops = record_ops(fn, *args)
        except Exception as e:  # the op itself must not fail
            fails.append(f"{label}: failed: {type(e).__name__}: {e}")
            return
        fails.extend(_purity_failures(ops, out, label, fused=fused))
        if launches and sum(_launch_counts().values()) == before:
            fails.append(f"{label}: no kernel launched on the cuda engine")

    def expect(label, exc, fn, *args):
        nonlocal checks
        checks += 1
        try:
            fn(*args)
        except exc:
            return
        except Exception as e:
            fails.append(f"{label}: expected {exc.__name__}, got "
                         f"{type(e).__name__}: {e}")
            return
        fails.append(f"{label}: expected {exc.__name__}, ran cleanly")

    # --- bgemm: the 1-bit kernel
    ap1, bp1 = _operands(m, k, n, 1, 1, dev)
    if be.supports("bgemm"):
        run(f"{be.name}:bgemm",
            lambda a, b: api.bgemm(a, b, backend=be, policy=pol),
            ap1[0], bp1[0])

    # --- bitserial across the bit widths, plus the asymmetric corners
    pairs = [(b, b) for b in bits] + [(1, 8), (8, 1)]
    for s, t in sorted(set(pairs)):
        if not be.supports("bitserial_mm", s=s, t=t):
            continue
        ap, bp = _operands(m, k, n, s, t, dev)
        run(f"{be.name}:bitserial_mm:{s}x{t}b",
            lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                 policy=pol),
            ap, bp)

    # --- the fused §4.5 epilogue: float allowed there, gated
    alpha = torch.full((m, 1), 0.01, dtype=torch.float32, device=dev)
    beta = torch.zeros((1, n), dtype=torch.float32, device=dev)
    for s in bits:
        if not be.supports("bitserial_fused", s=s, t=s):
            continue
        ap, bp = _operands(m, k, n, s, s, dev)
        run(f"{be.name}:bitserial_fused:{s}b",
            lambda a, b, al, bt: api.bitserial_fused(
                a, b, al, bt, out_bits=4, backend=be, policy=pol),
            ap, bp, alpha, beta, fused=True)

    # --- zero-tile jumping and the tiles= contract
    ap, bp = _operands(m, k, n, 2, 2, dev)
    compact = zerotile.compact_artifacts(ap, pol.block_m, pol.block_w)
    if be.supports("bitserial_jump"):
        run(f"{be.name}:bitserial_mm:jump=mask",
            lambda a, b: api.bitserial_mm_packed(
                a, b, backend=be, policy=pol.replace(jump="mask")),
            ap, bp)
        run(f"{be.name}:bitserial_mm:tiles=compact",
            lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                 policy=pol, tiles=compact),
            ap, bp)
        # s_max sizes the kernel's K loop: a device scalar must be refused
        bad = (compact[0], compact[1],
               torch.tensor(compact[2], dtype=torch.int32, device=dev))
        expect(f"{be.name}:tiles:s_max-device-scalar", TypeError,
               lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                    policy=pol, tiles=bad),
               ap, bp)
        bogus = (compact[0], compact[1], compact[2], "bogus")
        expect(f"{be.name}:tiles:unknown-tag", ValueError,
               lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                    policy=pol, tiles=bogus),
               ap, bp)
    else:
        # dispatch strips tiles for an engine without the capability: the
        # call runs and stays integer
        run(f"{be.name}:bitserial_mm:tiles-stripped",
            lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                 policy=pol, tiles=compact),
            ap, bp)
    if be.supports("bitserial_sgt"):
        sgt_tiles = sgt_lib.sgt_artifacts(ap, pol.block_m)
        run(f"{be.name}:bitserial_mm:tiles=sgt",
            lambda a, b: api.bitserial_mm_packed(a, b, backend=be,
                                                 policy=pol, tiles=sgt_tiles),
            ap, bp)
    log(f"[trace] {be.name} on {dev.type}: {checks} checks, "
        f"{len(fails)} failures")
    return checks, fails


def check_policy_sites(paths=None, rel_root=None) -> tuple:
    """Construct again every ExecutionPolicy site the lint can see;
    returns ``(sites, dynamic, failures)`` with file:line context."""
    from repro_torch.analysis.rules import policy_sites

    sites = policy_sites.collect_sites(paths, rel_root)
    dynamic, fails = 0, []
    for s in sites:
        if s["kwargs"] is None:
            dynamic += 1
            continue
        try:
            policy_sites.build(s["kind"], s["kwargs"])
        except (TypeError, ValueError) as e:
            fails.append(f"{s['path']}:{s['line']}: invalid "
                         f"ExecutionPolicy: {e}")
    return len(sites), dynamic, fails


def _train_artifacts(nbits, dev, bcount=2, p=32, d=32):
    """Synthetic IntBatchArtifacts, as the reference's check builds them."""
    from repro_torch.core.quantize import QuantParams
    from repro_torch.train.intpath import IntBatchArtifacts

    n = bcount * p
    rng = np.random.default_rng(0)
    adj_blocks = rng.integers(0, 2, (bcount, p, p)).astype(np.int32)
    rem = -np.ones(16, np.int32)
    rem[:4] = [0, 1, p, p + 1]
    deg = adj_blocks.sum(axis=2).reshape(n, 1).astype(np.float32)

    def put(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return IntBatchArtifacts(
        adjb=put(adj_blocks),
        row_idx=put(np.arange(n, dtype=np.int32).reshape(bcount, p)),
        rem_src=put(rem), rem_dst=put(rem), deg=put(deg), deg_in=put(deg),
        inv_deg=put(1.0 / (deg + 1.0)),
        xq=put(rng.integers(0, 1 << nbits, (n, d)).astype(np.int32)),
        qpx=QuantParams(nbits=nbits, scale=put(0.1, torch.float32),
                        zero=put(0.0, torch.float32)),
        tiles=None, s_maxes=None)


def _train_ops(params, art, cfg, backend, grad_bits):
    """The aten ops of the int forward, or with ``grad_bits`` of the
    forward and its backward (which may run on autograd's own thread:
    the recorder must still see it)."""
    from repro_torch.models import gnn

    if grad_bits is None:
        return record_ops(lambda: gnn.forward_int(params, art, cfg,
                                                  backend=backend))[1]
    leaves = {l: {k: v.detach().requires_grad_() for k, v in p.items()}
              for l, p in params.items()}
    out, ops = record_ops(lambda: gnn.forward_int(
        leaves, art, cfg, backend=backend, grad_bits=grad_bits))
    _, back = record_ops(lambda: torch.sum(out).backward())
    if not back:
        raise RuntimeError("the recorder saw no backward op")
    return ops + back


def check_train_path(*, device=None, bits=(4, 8), backends=None,
                     log=lambda *_: None) -> tuple:
    """Show that the int training step runs no float GEMM.

    Runs ``models.gnn.forward_int`` over synthetic IntBatchArtifacts, and
    its backward with ``grad_bits = nbits`` (so the backward GEMMs are
    bit-serial too), on every registered engine, and fails on any GEMM
    over float tensors: the feature and weight GEMMs and both halves of
    the blocked aggregation must run on integers. Float is expected, and
    allowed, in the affine corrections, the requantize epilogues and the
    loss; the int path's claim is about its GEMMs.
    """
    from repro_torch import api
    from repro_torch.models import gnn

    dev = resolve_device(device)
    names = api.list_backends() if backends is None else list(backends)
    checks, fails = 0, []
    for nbits in bits:
        art = _train_artifacts(nbits, dev)
        cfg = gnn.GNNConfig.paper_gcn(art.xq.shape[1], 10, x_bits=nbits,
                                      w_bits=nbits)
        params = gnn.init_params(cfg, generator=torch.Generator()
                                 .manual_seed(0), device=dev)
        for name in names:
            for label, grad_bits in (
                    (f"train:{name}:forward_int:{nbits}b", None),
                    (f"train:{name}:grad:{nbits}b", nbits)):
                checks += 1
                try:
                    ops = _train_ops(params, art, cfg, name, grad_bits)
                except Exception as e:
                    fails.append(f"{label}: failed: {type(e).__name__}: {e}")
                    continue
                fails.extend(
                    f"{label}: {op!r} runs in float: the int training path "
                    f"must keep every GEMM integer"
                    for op in float_ops(ops) if op in GEMM_OPS)
    fails = sorted(set(fails))
    log(f"[trace] train path on {dev.type}: {checks} checks, "
        f"{len(fails)} failures")
    return checks, fails


def run_trace_checks(backends=None, *, device=None, bits=range(1, 9),
                     shape=(16, 256, 128), log=print) -> dict:
    """Every registered engine x op x bit width, the policy sites and the
    int training step; returns a JSON-able report, with the kernel
    launches the checks made (``launches``, by kernel)."""
    from repro_torch import api

    dev = resolve_device(device)
    if backends is None:
        backends = api.list_backends()
    before = _launch_counts()
    report = {"device": str(dev), "backends": [], "checks": 0,
              "failures": []}
    for be in backends:
        checks, fails = check_backend(be, device=dev, bits=bits, shape=shape,
                                      log=log)
        report["backends"].append(str(getattr(be, "name", be)))
        report["checks"] += checks
        report["failures"].extend(fails)
    n_sites, dynamic, site_fails = check_policy_sites()
    report["policy_sites"] = {"total": n_sites, "dynamic": dynamic,
                              "validated": n_sites - dynamic}
    report["checks"] += n_sites - dynamic
    report["failures"].extend(site_fails)
    log(f"[trace] policy sites: {n_sites - dynamic} validated, "
        f"{dynamic} dynamic")
    t_checks, t_fails = check_train_path(device=dev, log=log)
    report["train_path"] = {"checks": t_checks, "failures": len(t_fails)}
    report["checks"] += t_checks
    report["failures"].extend(t_fails)
    after = _launch_counts()
    report["launches"] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dispatch-level checker: integer purity, tiles= "
                    "contract, kernel launches, the int training step, "
                    "policy-site grid validity")
    ap.add_argument("--backends", nargs="*", default=None,
                    help="engine names (default: all registered)")
    ap.add_argument("--max-bits", type=int, default=8,
                    help="check 1..N bit operands (default 8)")
    ap.add_argument("--device", default=None,
                    help="where the operands live: the card unless 'cpu'")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    log = (lambda *_: None) if args.json else print
    report = run_trace_checks(args.backends, device=args.device,
                              bits=range(1, args.max_bits + 1), log=log)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for f in report["failures"]:
            print(f"[trace] FAIL {f}")
        print(f"[trace] {report['checks']} checks over "
              f"{', '.join(report['backends'])} on {report['device']}: "
              f"{len(report['failures'])} failures")
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
