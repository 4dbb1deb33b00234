"""The port's package boundary and contracts.

- No module of ``src/repro_torch``, and neither ``chip_smoke.py`` nor
  ``compare_kernels.py``, imports JAX or the JAX package ``repro``.
- Entry points run on the card unless the caller asks for the CPU: without
  a card they raise.
- ``resolve`` raises for an engine named with ``backend=`` that cannot
  run the op, and otherwise falls back to the first registered engine
  that can, with one warning.
- The ``tiles=`` contract: a non-int ``s_max`` is a TypeError, an unknown
  tag a ValueError, and tiles > occupancy > recompute.
"""
import ast
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.analysis import trace  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.api.backend import Backend, UnsupportedOpError  # noqa: E402
from repro_torch.benchmarks import fig9b_transfer, run  # noqa: E402
from repro_torch.convert import adamw_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import bitops, zerotile  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.graph import batching, datasets, packing, partition  # noqa: E402
from repro_torch.kernels import bitserial, ops  # noqa: E402
from repro_torch.launch import lint  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import intpath, trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py", ROOT / "compare_kernels.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_leaves_jax_unloaded():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__") for p in PACKAGE_FILES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            + f"{sorted(FORBIDDEN)!r}))\n"
            # importing builds no kernel: that waits for the first launch
            + "print(repro_torch.kernels._build._lib)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, env=env)
    assert out.stdout.split() == ["[]", "None"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_told_cpu(no_card):
    cfg = gnn.GNNConfig.paper_gcn(8, 3)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.init_params(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"layer0": {"w": np.zeros((2, 2))}})
    data = datasets.load("ogbn-arxiv", scale=0.002, seed=0)
    b = batching.make_batches(data, partition.partition(data.csr, 2), 1)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.make_device_batch(b)
    transfers = (packing.transfer_dense, packing.transfer_sparse,
                 packing.transfer_packed, packing.transfer_packed_feats)
    for transfer in transfers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            transfer(b)
    # every figure suite and the runner, before any work
    for _, suite in run.SUITES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            suite()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig9b_transfer.run({"batch": b})
    # training: the trainer, its evaluation, the int path's artifacts and
    # the optimizer state carried from the reference
    parts = partition.partition(data.csr, 2)
    tcfg = trainer.TrainConfig(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(data, parts, cfg, tcfg, batch_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.evaluate({}, data, parts, cfg, batch_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        intpath.build_artifacts(b, 8)
    state = {"mu": {"layer0": {"w": np.zeros(2)}},
             "nu": {"layer0": {"w": np.zeros(2)}}, "step": np.int32(0)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adamw_state_from_jax(state)
    # the trace checker and the lint's --trace, before any work
    for entry in (lambda: trace.check_backend("torch_dot"),
                  trace.check_train_path, trace.run_trace_checks,
                  lambda: trace.main([]),
                  lambda: lint.main(["--trace"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    # asked for the CPU, every entry point works there
    assert resolve_device("cpu").type == "cpu"
    params = gnn.init_params(cfg, generator=gen, device="cpu")
    assert all(v.device.type == "cpu" for p in params.values() for v in p.values())
    assert trainer.make_device_batch(b, device="cpu")["adj"].device.type == "cpu"
    for transfer in transfers:
        out = transfer(b, device="cpu")
        assert out[0].device.type == "cpu"
    assert params_from_jax({"layer0": {"w": np.zeros((2, 2))}},
                           device="cpu")["layer0"]["w"].dtype == torch.float32
    assert intpath.build_artifacts(b, 8, device="cpu").adjb.device.type == "cpu"
    assert adamw_state_from_jax(state, device="cpu")["step"].device.type == "cpu"
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
    trained, _, _ = trainer.train(data, parts, cfg, tcfg, batch_size=1,
                                  device="cpu")
    assert trained["layer0"]["w"].device.type == "cpu"


def test_kernel_wrapper_takes_cpu_or_cuda_only():
    a = torch.zeros((1, 8, 4), dtype=torch.int32)
    b = torch.zeros((1, 4, 5), dtype=torch.int32)
    before = bitserial.LAUNCHES["bitserial_gemm"]
    assert not bool(bitserial.bitserial_gemm(a, b, block_m=8, block_n=32,
                                             block_w=4).any())
    # the plain version on the CPU is no launch
    assert bitserial.LAUNCHES["bitserial_gemm"] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        bitserial.bitserial_gemm(a.to("meta"), b.to("meta"), block_m=8,
                                 block_n=32, block_w=4)


class _NoOps(Backend):
    name = "test-no-ops"


def test_resolve_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(registry, "_warned_fallbacks", set())
    be = _NoOps()
    with pytest.raises(UnsupportedOpError, match="test-no-ops"):
        api.resolve("bitserial_mm", backend=be)
    with pytest.raises(UnsupportedOpError, match="s=9"):
        api.resolve("bitserial_mm", backend="cuda", s=9)
    with pytest.raises(UnsupportedOpError, match="s=33"):
        api.resolve("bitserial_mm", backend="popcount", s=33)
    x = torch.ones((4, 4), dtype=torch.int32)
    with pytest.raises(UnsupportedOpError):
        api.bitserial_mm(x, x, 1, 1, backend=be)
    # the context engine falls back, by capability, to the first
    # registered engine that takes the op, as the reference's does
    with api.use("cuda"), pytest.warns(RuntimeWarning, match="falling back to 'torch_dot'"):
        assert api.resolve("bitserial_mm", s=9)[0].name == "torch_dot"
    with api.use("cuda"), warnings.catch_warnings():
        warnings.simplefilter("error")  # once per (engine, op, fallback)
        assert torch.equal(api.bitserial_mm(x, x, 9, 1),
                           api.bitserial_mm(x, x, 9, 1, backend="torch_dot"))
    # no engine takes 33 bits: nothing to fall back to
    with pytest.raises(UnsupportedOpError, match="no registered backend.*s=33"):
        api.resolve("bitserial_mm", s=33)
    with pytest.raises(KeyError, match="unknown backend"):
        api.bitserial_mm(x, x, 1, 1, backend="pallas")
    assert api.current()[0].name == api.DEFAULT_BACKEND == "cuda"


def _packed(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (16, 256)).astype(np.int32)
    b = rng.integers(0, 4, (256, 5)).astype(np.int32)
    return (a, b, bitops.pack_a(torch.as_tensor(a), 1),
            bitops.pack_b(torch.as_tensor(b), 2))


def test_tiles_contract_errors():
    _, _, ta, tb = _packed()
    idx, cnt, s_max = zerotile.compact_artifacts(ta, 8, 4)
    with pytest.raises(TypeError, match="host int"):
        ops.bitserial_gemm(ta, tb, tiles=(idx, cnt, torch.tensor(s_max)))
    with pytest.raises(TypeError, match="host int"):
        ops.bitserial_gemm(ta, tb, tiles=(idx, cnt, float(s_max), "sgt"))
    with pytest.raises(ValueError, match="kind"):
        ops.bitserial_gemm(ta, tb, tiles=(idx, cnt, s_max, "bogus"))


def test_tiles_beat_occupancy_beat_recompute():
    a, b, ta, tb = _packed(1)
    exact = a.astype(np.int64) @ b
    idx, cnt, s_max = zerotile.compact_artifacts(ta, 8, 4)
    empty = torch.zeros((2, 2), dtype=torch.int32)
    # tiles win over an occupancy map that would drop every tile
    got = ops.bitserial_gemm(ta, tb, tiles=(idx, cnt, s_max), occupancy=empty,
                             jump="mask")
    np.testing.assert_array_equal(got.numpy(), exact)
    # a given occupancy wins over recomputing one from ``jump``
    for jump in ("mask", "compact"):
        got = ops.bitserial_gemm(ta, tb, occupancy=empty, jump=jump)
        assert not bool(got.any()), jump
    # an engine without the jump capability never sees the tiles
    dropped = (idx, torch.zeros_like(cnt), s_max)
    np.testing.assert_array_equal(
        api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), 1, 2,
                         backend="popcount", tiles=dropped).numpy(), exact)
    assert not bool(api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), 1, 2,
                                     tiles=dropped).any())


def test_kernel_engine_rejects_what_it_cannot_run():
    a, b, ta, tb = _packed()
    # mode="mxu" is served: on CPU tensors by the plain version, which
    # gives the 'vpu' int32 and a @ b
    mxu = ops.bitserial_gemm(ta, tb, mode="mxu")
    assert torch.equal(mxu, ops.bitserial_gemm(ta, tb, mode="vpu"))
    np.testing.assert_array_equal(mxu.numpy(), a.astype(np.int64) @ b)
    vpu_1bit = ops.bgemm(ta[0], tb[0], mode="vpu")
    np.testing.assert_array_equal(vpu_1bit.numpy(),
                                  a.astype(np.int64) @ (b & 1))
    for mxu_1bit in (ops.bgemm(ta[0], tb[0], mode="mxu"),
                     api.bgemm(ta[0], tb[0],
                               policy=api.ExecutionPolicy(mode="mxu"))):
        assert torch.equal(mxu_1bit, vpu_1bit)
    # an unknown mode is still refused, on any device
    with pytest.raises(ValueError, match="mode"):
        ops.bgemm(ta[0], tb[0], mode="simd")
    # reuse=False is no longer refused: one bgemm pass per plane pair,
    # equal to the one-kernel reuse=True product (CPU tensors: plain versions)
    no_reuse = api.bitserial_mm_packed(ta, tb,
                                       policy=api.ExecutionPolicy(reuse=False))
    assert torch.equal(no_reuse, api.bitserial_mm_packed(ta, tb))
    np.testing.assert_array_equal(no_reuse.numpy(), a.astype(np.int64) @ b)


@pytest.mark.parametrize("kw", [dict(block_m=3, block_n=5),
                                dict(block_m=8, block_n=256),
                                dict(block_w=0),
                                dict(block_m=32, block_n=32, block_w=128),
                                dict(jump="skip"), dict(mode="simd")])
def test_policy_rejects_tiles_the_kernel_cannot_take(kw):
    with pytest.raises(ValueError):
        api.ExecutionPolicy(**kw)
