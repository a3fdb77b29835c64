"""setup.corpus_roofline_pct: the least time the card could take for the
corpus pass's F1, F2 and K1 work (``kinds.corpus_bound_s``: the copied
work formulas at 67 TFLOP/s f32 and 3.35 TB/s) over the pass's seconds."""


def read(ctx):
    if not ctx.get("corpus_s"):
        return None
    return 100.0 * ctx["corpus_bound_s"] / ctx["corpus_s"]
