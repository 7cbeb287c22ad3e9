"""Device ms per round under the program's span `fused_round`: the
whole-round megakernel (`ops/megakernel.fused_round`, launched inside a
torch op so that the span holds it) and the round's vote count, in
`models/avalanche.round_step` on the megakernel engine."""

from portbench.tracing import per_round


def read(slice_):
    return per_round(slice_, "fused_round")
