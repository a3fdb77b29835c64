"""train.replay_step_ms: a replayed train step on the card's clock, the
measured call's epochs after its first (``train_config``'s summary
``spans``): the device seconds of the ``epoch.replays`` spans (a CUDA event
on each side of each group's graph replay) over the steps they replayed.
None where the summary has no spans (a program without them)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    span = ctx["summary"].get("spans", {}).get("epoch.replays")
    if not span or "device_s" not in span or not span.get("steps"):
        return None
    return 1e3 * span["device_s"] / span["steps"]
