"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers:
``build`` compiles ``csrc/`` with nvcc, ``flash_attention`` binds the
flash-attention kernels."""
