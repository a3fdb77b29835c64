"""train.epoch_rest_ms: what an epoch spends outside its train steps
(validation replays, the fetch, the scheduler, the last epoch's
checkpoint): the summary's epoch_s less its steps times step_ms."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    s = ctx["summary"]
    return 1e3 * s["epoch_s"] - ctx["steps_per_epoch"] * s["step_ms"]
