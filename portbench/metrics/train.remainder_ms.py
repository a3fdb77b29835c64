"""train.remainder_ms: an epoch's single train steps after its groups of K
(the eager remainder) on the card's clock: the device seconds of the
``epoch.remainder`` spans (a CUDA event before the first such step and
after the last) over the summary's ``span_epochs``; 0 where no epoch has
such steps. None where the summary has no spans (a program without them)
or they hold no card times."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["summary"].get("spans"):
        return None
    span = ctx["summary"]["spans"].get("epoch.remainder")
    if span is None:
        return 0.0
    if "device_s" not in span:
        return None
    return 1e3 * span["device_s"] / ctx["summary"]["span_epochs"]
