"""Hand-written CUDA kernels for the SAFE masking hot spots (Hopper, sm_90a).

threefry_mask_add — fused keystream + fixed-point encode + masked add
chain_combine     — fused SAFE non-initiator hop, single and batched rows
bon_mask          — fused BON pairwise masking over m keys

Sources live in ``repro_torch/csrc``; ``build`` compiles them with nvcc on
first use. Each kernel has a plain PyTorch version in ``ref.py``;
``ops.py`` defines each as a ``torch.library`` op that sends CUDA tensors
to the kernel, CPU tensors to the plain version and meta tensors to a
shape function. Callers import the entry points from ``ops`` (the submodule
names ``bon_mask``, ``chain_combine`` and ``threefry_mask_add`` are the
wrappers' own).
"""
