"""Element-wise consensus ops and the hand-written kernels."""
