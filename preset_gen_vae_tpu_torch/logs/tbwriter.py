"""Copy of ``preset_gen_vae_tpu/logs/tbwriter.py``, the JAX package's
counterpart, unchanged apart from this paragraph: it is the one module of
the port that imports tensorboard when it is imported, so
``logs/logger.py:RunLogger`` imports it only for ``use_tensorboard=True``,
and that call raises ``ImportError`` where tensorboard is not installed.

TensorBoard writer with config-derived hparams
(reference: logs/tbwriter.py:9-101).

Includes the same fix the reference applies to ``add_hparams``: write the
hparams summary into the run's own event file instead of a spurious
sub-run directory."""

from __future__ import annotations

from typing import Dict

from torch.utils.tensorboard import SummaryWriter
from torch.utils.tensorboard.summary import hparams


class TensorboardSummaryWriter(SummaryWriter):
    def __init__(
        self, log_dir, model_config=None, train_config=None, **kwargs
    ):
        super().__init__(log_dir=str(log_dir), **kwargs)
        self.model_config = model_config
        self.train_config = train_config
        self.hyper_params: Dict = {}
        if model_config is not None and train_config is not None:
            # hparams tracked for the TB table (reference: tbwriter.py:45-73)
            mc, tc = model_config, train_config
            self.hyper_params = {
                "batchsz": tc.minibatch_size,
                "kfold": tc.current_k_fold,
                "wdecay": tc.weight_decay,
                "fcdrop": tc.fc_dropout,
                "z_dim": mc.dim_z,
                "archi": mc.encoder_architecture,
                "controls": mc.params_regression_architecture,
                "latent_flow": mc.latent_flow_arch or "None",
                "mels": mc.mel_bins,
                "mididyn": str(mc.midi_notes),
                "synth": mc.synth_args_str,
            }

    def add_hparams_no_subdir(self, hparam_dict: Dict, metric_dict: Dict):
        """add_hparams into THIS run dir (reference bugfix: tbwriter.py:9-29)."""
        exp, ssi, sei = hparams(hparam_dict, metric_dict)
        self.file_writer.add_summary(exp)
        self.file_writer.add_summary(ssi)
        self.file_writer.add_summary(sei)
        for k, v in metric_dict.items():
            self.add_scalar(k, v)

    def init_hparams_and_metrics(self, metrics: Dict):
        """(reference: tbwriter.py:75-85)"""
        md = {k: 0.0 for k in metrics if k != "epochs"}
        self.add_hparams_no_subdir(self.hyper_params, md)

    def update_metrics(self, metrics: Dict):
        """(reference: tbwriter.py:86-101)"""
        for k, m in metrics.items():
            if k == "epochs":
                continue
            try:
                self.add_scalar(k, m.get() if hasattr(m, "get") else float(m))
            except ValueError:
                pass  # empty buffered metric early in training
