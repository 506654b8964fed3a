"""testground_tpu_torch: the PyTorch/CUDA port of testground_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports
torch and numpy, never jax and nothing of ``testground_tpu``; every
state leaf it computes is held bit for bit against the JAX package's
(``tests/test_torch_*.py``). Its entry points run on the card
(``device="cuda"``, the default) and raise without one unless the
caller passes ``device="cpu"``.

This slice runs the dht find-providers plan end to end with the fused
entry-mode deliver front as a hand-written CUDA kernel
(``csrc/deliver_front.cu``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
