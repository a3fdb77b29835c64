"""train.host_only_ms: what an epoch spends on the host alone, with nothing
queued on the card (from a blocking fetch's return to the next launch:
the train scalars, validation's batches and bookkeeping, the schedule, the
checkpoint, the logger, the next epoch's start and batches): the self
seconds of the summary's spans marked ``host_only``, over its
``span_epochs``. The loop's own counterpart of ``device_idle_pct.train``.
None where the summary has no spans (a program without them)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["summary"].get("spans"):
        return None
    spans = ctx["summary"]["spans"]
    host = sum(s["self_s"] for s in spans.values() if s.get("host_only"))
    return 1e3 * host / ctx["summary"]["span_epochs"]
