"""eval.model_init_s: the model's build on the host and its copy to the card in
an evaluation pass (``evaluate_model``'s ``phase_seconds['model.init']``:
``build_extended_ae_model`` and ``.to(dev)``), in seconds, the mean over the
window's passes. None where the passes have no spans (a program whose
``phase_seconds`` lacks the dotted parts of its phases)."""


def read(ctx):
    if ctx.get("kind") != "eval" or "model.init" not in ctx["phase_s"]:
        return None
    return ctx["phase_s"]["model.init"]
