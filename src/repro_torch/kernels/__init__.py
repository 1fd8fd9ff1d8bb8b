"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the device-dispatching wrappers.

imc_mvm   — INT8 weight-stationary matmul (IMC crossbar analogue)
conv2d    — INT8 implicit-GEMM conv
flash_attention — online-softmax attention (the LM tier's kernel)
ops       — public wrappers (CUDA tensor -> kernel, CPU tensor -> plain)
counts    — the wrappers' launch counts across a CUDA graph's capture
ref       — the plain versions
_build    — nvcc build of ``csrc/*.cu`` and ctypes loading, on first use
"""
