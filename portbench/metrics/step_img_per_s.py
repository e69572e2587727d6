"""Images trained a second over the window, traffic resident on the device."""

from portbench.harness import readers


def read(ctx):
    return readers.images_per_s(ctx)
