"""The mean of the trainer's 'draws' range (the host part of a block: draws, K1's plan, the upload) over the traced blocks."""

from portbench.harness import readers


def read(ctx):
    return readers.mean_range_ms(ctx, "draws")
