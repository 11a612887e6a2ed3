"""train_qps: questions trained in the window (batch size x steps) over
the window's length, which ends when the last step's device work has
finished (host clock; cells whose run counts the questions it
trained)."""


def read(ctx):
    if "questions" not in ctx.out:
        return None
    return ctx.out["questions"] / ctx.window_s
