"""train.mfu: the model FLOPs of the window over its wall, against the
card's dense bf16 peak (989 TFLOP/s). A step's FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference's forward
and backward at the cell's shapes (the optimizer's elementwise work is not
counted), whatever implements the step."""

from portbench.work import BF16_FLOP_PER_S


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("flops_per_step"):
        return None
    steps = ctx["epochs"] * ctx["steps_per_epoch"]
    return 100.0 * ctx["flops_per_step"] * steps / ctx["window_s"] / BF16_FLOP_PER_S
