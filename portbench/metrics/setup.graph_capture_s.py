"""setup.graph_capture_s: the seconds the measured call spent capturing
its CUDA graphs (the summary's ``graph_capture_s``)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["graph_capture_s"]
