"""das_tpu_torch — the PyTorch/CUDA port of das_tpu.

The same store layout, plans and answers as the JAX package `das_tpu`,
with the device work in PyTorch and every TPU kernel of the query path
written again by hand for NVIDIA Hopper (`das_tpu_torch/kernels/`).  The
port imports nothing of `das_tpu` and no JAX.

Entry point: `das_tpu_torch.api.atomspace.DistributedAtomSpace`."""
