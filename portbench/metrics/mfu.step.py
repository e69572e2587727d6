"""The model FLOPs of the traced blocks' images over the device's busy time in them, as a share of the card's bf16 dense peak: the whole step's share, every kernel of it counted."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
