"""testground_tpu_torch: the PyTorch/CUDA port of testground_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports
torch and numpy, never jax and nothing of ``testground_tpu``; every
state leaf it computes is held bit for bit against the JAX package's
(``tests/test_torch_*.py``). Its entry points run on the card
(``device="cuda"``, the default) and raise without one unless the
caller passes ``device="cpu"``.

It runs the dht find-providers, gossipsub mesh-propagation and storm
plans end to end; the hand-written CUDA kernels are in ``csrc/``.
``entry`` is one storm tick at 64 instances; ``python -m
testground_tpu_torch.bench`` runs storm at 10,000 instances.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"


def entry(device="cuda"):
    """(tick_fn, (state,)): one storm tick at 64 instances on ``device``
    (the counterpart of ``__graft_entry__.entry``)."""
    from .graft import entry as _entry

    return _entry(device)
