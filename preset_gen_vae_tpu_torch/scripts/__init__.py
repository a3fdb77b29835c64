"""The port's command-line entry points, run with ``python -m``:
``train_from_syx`` (DX7 cartridges -> SQLite -> train -> eval) and
``preset_morph_demo`` (latent-space morph between two presets)."""
