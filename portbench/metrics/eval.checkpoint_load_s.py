"""eval.checkpoint_load_s: the checkpoint's read and restore in an evaluation
pass (``evaluate_model``'s ``phase_seconds['model.load']``:
``load_checkpoint``, ``load_state_dict`` and ``eval()``), in seconds, the
mean over the window's passes. None where the passes have no spans (a
program whose ``phase_seconds`` lacks the dotted parts of its phases)."""


def read(ctx):
    if ctx.get("kind") != "eval" or "model.init" not in ctx["phase_s"]:
        return None
    return ctx["phase_s"]["model.load"]
