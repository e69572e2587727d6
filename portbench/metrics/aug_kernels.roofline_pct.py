"""K1-K3's share of their roofline in the traced blocks: their bounds for the blocks' draws over their device time."""

from portbench.harness import readers


def read(ctx):
    return readers.aug_roofline_pct(ctx)
