"""Where a saved run's validation latent loss is not finite: the rows, the
latent dimensions and the log-variances behind them.

    python -m preset_gen_vae_tpu_torch.scripts.latent_nan_report MODEL/RUN \\
        [--n-presets N] [--style S] [--out report.npz] \\
        [--device cuda] [--data-root DIR] [--logs-root saved]

The run's frozen ``config.json`` and last checkpoint go through the
validation split one padded batch at a time, with
the training loop's own ``eval_step`` (eagerly, no graph), in the run's
``compute_dtype``. In eval mode z0 = mu, so each row's ``log q(z0)`` sums
``logvar + 0 / exp(logvar)`` over its latent dimensions: a dimension
whose ``exp(logvar)`` is 0 in float32 makes the row NaN, and a subnormal
one makes it finite. The report counts, per row, the dimensions at 0 and
at a subnormal, and holds the rows' per-row latent loss against the
batches' ``LatLoss`` and the loop's weighted mean.

The ``.npz`` written to ``--out`` keeps what a CPU check against the JAX
package needs without the checkpoint (the encoder's dense head alone is
120 MB in float32): for the non-finite rows, the finite rows with an
``exp(logvar)`` at 0 or subnormal somewhere, and the first
``FINITE_ROWS`` other finite ones, their items, ``sample_info``, the
latent tensors ``z0_mu_logvar``, ``z0``, ``zK`` and ``log_abs_det_jac``
and per-row latent loss; for the non-finite rows also the encoder head's
input ``h`` and, for the latent dimensions at 0 or subnormal, the head's
weight rows, bias and the output batch norm's parameters and running
statistics. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from .. import config as cfg
from ..device import resolve_device
from ..data.pipeline import get_split_loaders
from ..logs.logger import load_checkpoint
from ..models.build import build_extended_ae_model
from ..ops.probability import gaussian_log_probability, standard_gaussian_log_probability
from ..training.loop import prepare_dataset, valid_real_rows
from ..training.train_step import Criteria, autocast, eval_step

# the least normal float32. exp(logvar) is classed on the device: the host
# process flushes subnormals once the C++ engine is loaded (it is built with
# -ffast-math), so on the host a subnormal compares equal to 0
F32_TINY = float(np.finfo(np.float32).tiny)
FINITE_ROWS = 8  # finite rows kept in the .npz beside the non-finite ones


def row_latent_loss(mu_logvar, z0, zK, logdet) -> torch.Tensor:
    """Each row's term of ``flow_vae_latent_loss`` (normalised by dim_z):
    the batch's LatLoss is their mean."""
    log_q = gaussian_log_probability(z0, mu_logvar[:, 0, :], mu_logvar[:, 1, :])
    return -(standard_gaussian_log_probability(zK) - log_q + logdet) / z0.shape[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Report a run's non-finite validation latent loss")
    ap.add_argument("run", metavar="MODEL/RUN")
    ap.add_argument("--n-presets", type=int, default=8192)
    ap.add_argument("--style", default="structured2")
    ap.add_argument("--out", default=None, help="the .npz to write")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--logs-root", default="saved")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    run_dir = pathlib.Path(args.logs_root) / args.run
    model_c, train_c = cfg.load_config(run_dir / "config.json")
    model_c.logs_root_dir = args.logs_root
    dataset_kwargs = {"n_synthetic_presets": args.n_presets, "synthetic_style": args.style}
    if args.data_root:
        dataset_kwargs["data_root"] = args.data_root
    model_c, train_c, dataset = prepare_dataset(*cfg.resolve(model_c, train_c), dev, None,
                                                dataset_kwargs)
    helper = dataset.preset_indexes_helper
    loader = get_split_loaders(dataset, train_c)["validation"]
    model = build_extended_ae_model(model_c, train_c, helper).to(dev)
    ckpt = load_checkpoint(model_c)
    model.load_state_dict(ckpt["state"]["model"])
    model.eval()
    criteria = Criteria(model_c, train_c, helper)
    encoder = model.ae_model.encoder
    heads = []
    hook = encoder.mlp_out.register_forward_hook(lambda m, i, o: heads.append(i[0].detach()))

    batch_lat, weights, rows = [], [], {k: [] for k in (
        "item", "info", "mu_logvar", "zero", "subnormal", "z0", "zK", "logdet", "h", "lat")}
    for i, sel in enumerate(loader.epoch_index_batches(0)):
        x, v, info = loader.gather(sel)
        heads.clear()
        m = eval_step(model, criteria, train_c, x, v, info)
        batch_lat.append(float(m["LatLoss"]))
        weights.append(loader.batch_weight(i))
        with torch.no_grad(), autocast(dev, train_c):  # the latents, as the step computed them
            outs = model.forward_full(x, info)
        n = valid_real_rows(loader, i)
        mu_logvar, z0, zK, logdet = (t[:n].float() for t in outs[:4])
        rows["item"].append(np.asarray(sel[:n]))
        rows["info"].append(info[:n].cpu().numpy())
        var = torch.exp(mu_logvar[:, 1, :])  # compared on the device: see F32_TINY
        for k, t in (("mu_logvar", mu_logvar), ("zero", var == 0),
                     ("subnormal", (var > 0) & (var < F32_TINY)), ("z0", z0), ("zK", zK),
                     ("logdet", logdet), ("h", heads[-1][:n].float())):
            rows[k].append(t.cpu().numpy())
        rows["lat"].append(row_latent_loss(mu_logvar, z0, zK, logdet).cpu().numpy())
    hook.remove()
    rows = {k: np.concatenate(v) for k, v in rows.items()}

    logvar, at_zero, subnormal = rows["mu_logvar"][:, 1, :], rows["zero"], rows["subnormal"]
    bad = ~np.isfinite(rows["lat"])
    good = np.flatnonzero(~bad)[:FINITE_ROWS]
    dims = np.flatnonzero((at_zero | subnormal).any(axis=0))  # exp(logvar) at its edge
    n_head = model.ae_model.concat_midi_to_z0 * 2  # MIDI dims come first in z0
    enc_dims = dims - n_head  # each dim's index in the encoder's output
    bn = encoder.lat_in_regularization if encoder.output_bn else None
    out_rows = encoder.mlp_out.weight.shape[0] // 2 + enc_dims  # the log-variance rows

    sel = np.flatnonzero(bad)
    edge = np.flatnonzero(~bad & (at_zero | subnormal).any(axis=1))  # finite, exp at its edge
    report = {
        "run": args.run, "epoch": int(ckpt["epoch"]), "n_items": int(len(rows["lat"])),
        "batches": len(batch_lat), "batch_lat_nan": int(np.sum(~np.isfinite(batch_lat))),
        "lat_valid": float(np.average(batch_lat, weights=weights)),
        "rows_nan": int(bad.sum()), "rows_with_zero_var": int(at_zero.any(axis=1).sum()),
        "rows_with_subnormal_var": int(subnormal.any(axis=1).sum()),
        "dims_at_zero": np.flatnonzero(at_zero.any(axis=0)).tolist(),
        "dims_subnormal": np.flatnonzero(subnormal.any(axis=0)).tolist(),
        "cells_at_zero": int(at_zero.sum()),
        "cells_subnormal": int(subnormal.sum()),
        "logvar_min": float(logvar.min()), "logvar_max": float(logvar.max()),
        "logvar_at_zero": ([float(logvar[at_zero].min()), float(logvar[at_zero].max())]
                           if at_zero.any() else None),
        "logvar_subnormal": ([float(logvar[subnormal].min()), float(logvar[subnormal].max())]
                             if subnormal.any() else None),
        "rows_nan_items": rows["item"][sel].tolist(),
        "rows_edge_items": rows["item"][edge].tolist(),
        "rows_nan_uid_pitch_vel": rows["info"][sel].tolist(),
        "lat_finite_mean": float(rows["lat"][~bad].mean()) if (~bad).any() else None,
        "rows_nan_zK_nonfinite": int((~np.isfinite(rows["zK"][bad])).any(axis=1).sum()),
        "rows_nan_logdet_nonfinite": int((~np.isfinite(rows["logdet"][bad])).sum()),
    }
    if args.out:
        keep = np.concatenate([sel, edge, good])
        payload = {k: rows[k][keep] for k in ("item", "info", "mu_logvar", "z0", "zK",
                                              "logdet", "lat")}
        payload.update(n_bad=np.int64(len(sel)), n_edge=np.int64(len(edge)), dims=dims,
                       h=rows["h"][sel], compute_dtype=np.array(train_c.compute_dtype))
        if len(dims):
            payload["w"] = encoder.mlp_out.weight.detach()[out_rows].float().cpu().numpy()
            payload["b"] = encoder.mlp_out.bias.detach()[out_rows].float().cpu().numpy()
            if bn is not None:
                for k in ("running_mean", "running_var", "weight", "bias"):
                    payload[f"bn_{k}"] = getattr(bn, k).detach()[out_rows].float().cpu().numpy()
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.out, **payload)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
