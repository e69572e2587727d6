"""Seconds from the process's start to the window: loading, building or loading the kernels, the weights, the traffic, the first blocks and the graph captures."""


def read(ctx):
    return ctx.window["setup_s"]
