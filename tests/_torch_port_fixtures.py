"""Fixtures shared by the port's test modules. A module takes one by
importing its name (``from _torch_port_fixtures import isolated_data_root``);
both are autouse, so the import alone applies it to every test of the
module. ``test_torch_port_imports.py`` checks that every port test module
that builds a dataset, trains or evaluates imports ``isolated_data_root``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def isolated_data_root(tmp_path_factory):
    """Any port dataset of the module without a data_root caches its corpus
    (the default 'disk' policy) under a fresh PGV_TPU_DATA_DIR, never in
    the repository's data_cache/, where another run's corpus could be
    served."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PGV_TPU_DATA_DIR", str(tmp_path_factory.mktemp("data_cache")))
        yield


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for the module's CPU convolutions, restored
    after it: the suite runs in several worker processes on one machine,
    where torch's default of one thread per core oversubscribes the cores
    and slows the full-size (257x347) runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny_configs(config_module, logs_root, run_name, **train_kwargs):
    """(ModelConfig, TrainConfig) of ``config_module`` (the port's or the JAX
    package's ``config``): the tiny model of the JAX package's loop tests
    (``tests/test_loop.py:_configs``), BasicVAE with dim_z 16 and an MLP
    head, at full-size log-mels, batch 8, 2 epochs, float32."""
    model_c = config_module.ModelConfig(
        name="TestVAE", run_name=run_name, latent_flow_arch=None,
        params_regression_architecture="mlp_2l64", dim_z=16, logs_root_dir=str(logs_root))
    kw = dict(minibatch_size=8, n_epochs=2, save_period=1, lr_warmup_epochs=1,
              beta_warmup_epochs=2, compute_dtype="float32", verbosity=0)
    kw.update(train_kwargs)
    return model_c, config_module.TrainConfig(**kw)
