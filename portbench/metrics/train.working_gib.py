"""train.working_gib: what the train loop holds on the card at the call's
end beyond the resident corpus and the model's state: the CUDA graphs'
private pools whole (the train, remainder and validation steps'
activations, gradients, cuDNN workspaces and static outputs) and the rest
of what stays allocated (the index rows, the targets, the validation
scalars). ``train_config``'s summary ``memory`` block: (``resident_bytes``
- ``corpus_bytes`` - ``model_state_bytes``) / 2**30, the model's state
being its parameters, buffers and Adam's state. Read from the allocator's
bookkeeping, not from its peak: every train cell's ``peak_device_gib`` is
the corpus pass's (its float16 raw tier beside the bf16 corpus), under
which the train step's own working set hides. None where the summary has
no such block (off the card, or a program without it)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    memory = ctx["summary"].get("memory")
    if not memory:
        return None
    return (memory["resident_bytes"] - memory["corpus_bytes"]
            - memory["model_state_bytes"]) / 2**30
