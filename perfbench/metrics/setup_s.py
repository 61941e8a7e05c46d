"""From the process's start to the window's: importing torch, the CUDA
context, the weights, the program's pipeline and the warm-up."""


def read(ctx):
    return ctx.record["setup_s"]
