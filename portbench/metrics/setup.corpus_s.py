"""setup.corpus_s: the corpus pass's seconds (the dataset's
``corpus_seconds``: render, log-mel and normalisation, synchronised)."""


def read(ctx):
    return ctx.get("corpus_s")
