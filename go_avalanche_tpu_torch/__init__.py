"""go_avalanche_tpu_torch — the PyTorch / CUDA port of go_avalanche_tpu.

A second package beside the JAX reference, mirroring its module names:

  config           the port's own AvalancheConfig (same fields, defaults)
  types, clock,    the host API: wire types, the clock, the peer registry
  net, processor   and the per-node Processor (plain Python)
  native           the ctypes binding to the C++ host runtime (`native/`)
  prng             threefry-2x32, bit-exact with jax.random
  stake            the per-node stake vector
  ops/             bitops, voterecord, sampling, adversary, exchange,
                   megakernel and pallas_vote (the wrappers of the
                   hand-written Hopper kernels in csrc/)
  models/          the dense avalanche round, the conflict DAG,
                   single-decree Snowball, Slush and Snowflake, and the
                   streaming schedulers
  convert          state carried to and from the reference's numpy leaves
  utils/           the golden oracle, npz checkpoints, metrics, tracing
  obs/             the flight recorder and the resource plane
  analysis/        the compile counter and the port-convention linter
  run_sim          the command-line runner
  connector/       the Connector server and client over TCP, and the Go
                   client's golden frames
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
from go_avalanche_tpu_torch.clock import Clock, StubClock
from go_avalanche_tpu_torch.net import Connman
from go_avalanche_tpu_torch.processor import Processor
from go_avalanche_tpu_torch.types import (
    NO_NODE,
    VOTE_NEUTRAL,
    VOTE_NO,
    VOTE_YES,
    Block,
    Hash,
    Inv,
    NodeID,
    RequestRecord,
    Response,
    Status,
    StatusUpdate,
    Target,
    Tx,
    Vote,
)

__all__ = [
    "AdversaryStrategy",
    "AvalancheConfig",
    "DEFAULT_CONFIG",
    "VoteMode",
    "Clock",
    "StubClock",
    "Connman",
    "Processor",
    "NO_NODE",
    "VOTE_NEUTRAL",
    "VOTE_NO",
    "VOTE_YES",
    "Block",
    "Hash",
    "Inv",
    "NodeID",
    "RequestRecord",
    "Response",
    "Status",
    "StatusUpdate",
    "Target",
    "Tx",
    "Vote",
]
