"""eval.similarity_s: the similarity phase of an evaluation pass, in seconds, the mean
over the window's passes (``evaluate_model``'s ``phase_seconds['similarity']``, each
phase synchronised)."""


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return ctx["phase_s"].get("similarity")
