"""repro_torch — the QGTC system ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference ``repro``, with the same
subpackage and module names so that each module's counterpart is easy to
find. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.

The slices ported so far are quantized Cluster-GCN / GIN inference
(``models.gnn.forward_qgtc``) over Cluster-GCN subgraph batches, and the
paper's §5 Tensor API (``core.bittensor``: ``to_bit``, ``bitmm2int``,
``bitmm2bit``) with the ``api`` ops beneath it. Hand-written sm_90a CUDA
kernels in ``csrc/`` carry them: the bit-serial GEMM and its fused
requantize epilogue, the 1-bit GEMM (each in the dense, mask, compact and
sgt schedules) and the quantize-and-pack kernel. Beside them: Cluster-GCN
training, continuous-batching GNN serving, policy tuning, the contract lint,
and LM serving over the ten architectures of ``configs`` (``models.lm``,
``launch.serve --arch``), which runs on PyTorch's own ops as the reference's
runs on XLA's.

Entry points that create tensors take ``device=``; ``None`` means the
card, and raises when there is none (``device.resolve_device``).
"""
