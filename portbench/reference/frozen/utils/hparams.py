"""Copy of ``preset_gen_vae_tpu/utils/hparams.py``, the JAX package's
counterpart, unchanged apart from this line.

Epoch-indexed hyper-parameter schedules (reference: utils/hparams.py:3-35)."""


class LinearDynamicParam:
    """Hyper-parameter linearly interpolated between two values over a range
    of epochs; provides metric-compatible methods for TensorBoard logging."""

    def __init__(self, start_value, end_value, start_epoch=0, end_epoch=10, current_epoch=-1):
        self.current_epoch = current_epoch - 1  # incremented when epoch starts
        self.start_value = start_value
        self.end_value = end_value
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        assert self.end_epoch >= self.start_epoch

    def on_new_epoch(self):
        self.current_epoch += 1

    def get(self, current_epoch=None):
        if current_epoch is None:
            current_epoch = self.current_epoch
        else:
            self.current_epoch = current_epoch
        if current_epoch >= self.end_epoch:
            return self.end_value
        if current_epoch <= self.start_epoch:
            return self.start_value
        offset = current_epoch - self.start_epoch
        return self.start_value + (self.end_value - self.start_value) * offset / (
            self.end_epoch - self.start_epoch
        )

    @property
    def value(self):
        return self.get()
