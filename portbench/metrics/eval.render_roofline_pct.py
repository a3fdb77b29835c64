"""eval.render_roofline_pct: the least time the card could take for a
pass's F1 and F2 work (the ground truth and the inferred presets of every
item: the copied work formulas at 67 TFLOP/s f32 and 3.35 TB/s) over the
pass's render seconds. It uses no kernel names."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx["phase_s"].get("render"):
        return None
    return 100.0 * ctx["render_bound_s"] / ctx["phase_s"]["render"]
