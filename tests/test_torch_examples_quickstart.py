"""The port's quickstart (``repro_torch.examples.quickstart``) on the CPU.

It must end in ``OK``, and the numbers it prints must be the reference's on
the same inputs: the 3-bit BitTensor's fp32 and packed bytes (and its packed
words, bit for bit) from ``repro.core.bittensor.to_bit``, and the zero-tile
jumping's skip ratio and tile count on the same block-diagonal adjacency
from ``repro.core.bitops`` and ``repro.core.zerotile`` under the
reference's own ``ExecutionPolicy(jump="compact")`` tile. The reference's
interpret-mode GEMMs are not run. Without a card the quickstart raises.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def run():
    import contextlib
    import io

    from repro_torch.examples import quickstart

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = quickstart.main(["--device", "cpu"])
    return buf.getvalue(), res


def test_quickstart_ends_in_ok(run):
    out, _ = run
    lines = out.strip().splitlines()
    assert lines[-1] == "OK"
    assert "torch_dot == popcount == cuda: exact" in lines
    assert "bitpack == to_bit: exact" in lines


def test_quickstart_bytes_are_the_references(run):
    import jax.numpy as jnp

    from repro.core import bittensor as jbt

    out, res = run
    jx = jbt.to_bit(jnp.asarray(res["x"].numpy()), nbits=3, pack_axis=1)
    assert (res["fp32_bytes"], res["packed_bytes"]) == \
        (jx.logical_nbytes_fp32, jx.nbytes)
    assert (f"x: fp32 {jx.logical_nbytes_fp32}B -> 3-bit packed "
            f"{jx.nbytes}B") in out
    from repro_torch.core import bittensor as bt

    tx = bt.to_bit(res["x"], nbits=3, pack_axis=1)
    np.testing.assert_array_equal(tx.data.numpy().view(np.uint32),
                                  np.asarray(jx.data))


def test_quickstart_tile_skip_is_the_references(run):
    import jax.numpy as jnp

    from repro.api import ExecutionPolicy
    from repro.core import bitops
    from repro.core.zerotile import occupancy_stats, tile_occupancy

    out, res = run
    skip = ExecutionPolicy(jump="compact")
    ap = bitops.pack_a(jnp.asarray(res["adj"].numpy()), 1)[0]
    app = bitops.pad_to(bitops.pad_to(ap, 0, skip.block_m), 1, skip.block_w)
    st = occupancy_stats(tile_occupancy(app, skip.block_m, skip.block_w))
    assert res["tiles_total"] == st["tiles_total"]
    assert res["skip_ratio"] == pytest.approx(st["skip_ratio"], abs=0)
    assert (f"skipped {st['skip_ratio']:.0%} of {st['tiles_total']} TC "
            f"tiles") in out
    # block-diagonal: at least the two off-diagonal blocks' tiles skip
    assert st["skip_ratio"] >= 0.5


def test_quickstart_cli_on_the_cpu_and_without_a_card():
    cmd = [sys.executable, "-m", "repro_torch.examples.quickstart"]
    done = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "OK"
    if not torch.cuda.is_available():
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode != 0
        assert "no CUDA device" in done.stderr
        assert "OK" not in done.stdout
