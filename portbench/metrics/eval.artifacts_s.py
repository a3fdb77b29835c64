"""eval.artifacts_s: the artifacts of an evaluation pass (``evaluate_model``'s
``phase_seconds['artifacts']``: the z0 and zK Spearman matrices, the npz,
npy and json files, the per-UID means), in seconds, the mean over the
window's passes. None where the passes have no spans (a program whose
``phase_seconds`` lacks the dotted parts of its phases)."""


def read(ctx):
    if ctx.get("kind") != "eval" or "model.init" not in ctx["phase_s"]:
        return None
    return ctx["phase_s"]["artifacts"]
