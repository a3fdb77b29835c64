"""preset_gen_vae_tpu_torch: the PyTorch/CUDA port of ``preset_gen_vae_tpu``.

Same layout as the JAX package (config, synth, data, ops, models, losses,
training); imports torch and numpy only. Entry point:
``training.loop.train_config``. Hand-written CUDA kernels live in ``csrc/``
and are built with nvcc at first use.
"""
