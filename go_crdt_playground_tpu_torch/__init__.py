"""PyTorch/CUDA port of the batched CRDT replica engine.

Batches of AWSet and δ-AWSet replicas packed into tensors (models/),
merged in anti-entropy rounds (parallel/gossip.py) by hand-written CUDA
kernels for Hopper (ops/cuda_merge.py, ops/cuda_delta.py, csrc/), each
beside a plain PyTorch version of the same function.  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
