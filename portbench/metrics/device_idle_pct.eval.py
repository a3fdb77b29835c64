"""device_idle_pct.eval: the share of the traced window in which no
kernel, copy or fill ran on the card (``trace.py``), over measured passes."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
