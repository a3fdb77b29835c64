"""train.checkpoint_ms: one checkpoint written by the epoch loop
(``logs/logger.py:save_checkpoint``: the state gathered to the host,
``torch.save`` and the meta file), the mean over the ``epoch.checkpoint``
spans of the measured call's epochs after its first. None where the
summary has no spans (a program without them) or those epochs wrote no
checkpoint."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    span = ctx["summary"].get("spans", {}).get("epoch.checkpoint")
    if not span:
        return None
    return 1e3 * span["s"] / span["n"]
