"""mfu: the model FLOPs of the window's work (training steps where the
run counts them, else served requests answered in the window) over the
window's length times the card's dense bf16 peak (989 TFLOP/s, H100
SXM), in %. The configuration's flops/<config>.py counts them."""


def read(ctx):
    cell = ctx.cell
    if "steps" in ctx.out:
        flops = ctx.out["steps"] * cell.flops.step_flops(cell.cfg, cell.work)
    else:
        flops = ctx.log.completed_in_window * cell.flops.request_flops(
            cell.cfg, cell.work)
    return 100.0 * flops / (ctx.window_s * ctx.peak_flops)
