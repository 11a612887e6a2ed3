"""setup_s: from the process's start to the window's start (host clock):
imports, the card's context, weights and inputs, the program's build
(kernels compile in a checkout's first run), warm-up, the first training
steps of a training cell."""


def read(ctx):
    return ctx.setup_s
