"""preset_gen_vae_tpu_torch: the PyTorch/CUDA port of ``preset_gen_vae_tpu``.

Same layout as the JAX package (config, synth, data, ops, models, losses,
training, logs, utils, evaluation); imports torch, numpy and scipy only.
Entry points: ``training.loop.train_config``, ``training.queue.run_queue``
and ``evaluation.evaluate.evaluate_model`` / ``evaluate_model_from_dir`` /
``evaluate_all_models``. Hand-written CUDA kernels live in ``csrc/`` and
are built with nvcc at first use.
"""
