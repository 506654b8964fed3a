"""Hand-written CUDA kernels of the port: their nvcc build and ctypes
bindings. Sources live in ``testground_tpu_torch/csrc/``; the build runs
at first use into ``testground_tpu_torch/build/`` (listed in
``.gitignore``). Nothing here is imported or built until a kernel is
launched on a CUDA tensor."""
