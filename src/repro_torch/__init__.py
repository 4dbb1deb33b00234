"""repro_torch — the QGTC system ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference ``repro``, with the same
subpackage and module names so that each module's counterpart is easy to
find. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.

The slice ported so far is quantized Cluster-GCN / GIN inference
(``models.gnn.forward_qgtc``) over Cluster-GCN subgraph batches, through
one hand-written sm_90a CUDA kernel (``csrc/bitserial.cu``) that runs the
bit-serial GEMM in its dense, mask, compact and sgt schedules.

Entry points that create tensors take ``device=``; ``None`` means the
card, and raises when there is none (``device.resolve_device``).
"""
