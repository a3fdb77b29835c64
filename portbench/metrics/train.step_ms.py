"""train.step_ms: the measured call's own step time (``train_config``'s
summary ``step_ms``: its epochs' train phases on the host clock up to each
epoch's one fetch, over their steps, the first step and the graph capture
left out)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["summary"]["step_ms"]
