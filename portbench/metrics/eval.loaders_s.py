"""eval.loaders_s: the config resolution and the split loaders of an evaluation
pass (``evaluate_model``'s ``phase_seconds['dataset']``; no corpus pass,
since the cell hands the pass its dataset), in seconds, the mean over the
window's passes. None where the passes have no spans (a program whose
``phase_seconds`` lacks the dotted parts of its phases)."""


def read(ctx):
    if ctx.get("kind") != "eval" or "model.init" not in ctx["phase_s"]:
        return None
    return ctx["phase_s"]["dataset"]
