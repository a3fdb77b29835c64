"""train.validation_ms: an epoch's validation on the host clock, from its
index batches through its graph replays, its fetch, the weighting and the
latents: the ``epoch.validation`` spans' seconds over the summary's
``span_epochs``. None where the summary has no spans (a program without
them)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    span = ctx["summary"].get("spans", {}).get("epoch.validation")
    if not span:
        return None
    return 1e3 * span["s"] / ctx["summary"]["span_epochs"]
