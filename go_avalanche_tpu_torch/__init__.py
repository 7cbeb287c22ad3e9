"""go_avalanche_tpu_torch — the PyTorch / CUDA port of go_avalanche_tpu.

A second package beside the JAX reference, mirroring its module names:

  config           the port's own AvalancheConfig (same fields, defaults)
  prng             threefry-2x32, bit-exact with jax.random
  stake            the per-node stake vector
  ops/             bitops, voterecord, sampling, adversary, exchange,
                   megakernel and pallas_vote (the wrappers of the
                   hand-written Hopper kernels in csrc/)
  models/          the dense avalanche round, the conflict DAG,
                   single-decree Snowball, Slush and Snowflake
  convert          state carried to and from the reference's numpy leaves
  workload         the flagship and BASELINE configurations

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.  Nothing here imports JAX or go_avalanche_tpu.
"""

from go_avalanche_tpu_torch.config import (
    AdversaryStrategy,
    AvalancheConfig,
    DEFAULT_CONFIG,
    VoteMode,
)

__all__ = ["AdversaryStrategy", "AvalancheConfig", "DEFAULT_CONFIG",
           "VoteMode"]
