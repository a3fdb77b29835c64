"""Copy of ``preset_gen_vae_tpu/data/dexed_spec.py``, the JAX package's counterpart,
unchanged apart from this line.

Builds the Dexed ``PresetSpec`` from dataset constraints.

Re-implements the learnable-parameter carving and num/cat model assignment
of the reference DexedDataset constructor (reference: data/dexeddataset.py:
79-167) as a standalone pure function, so the domain layer does not depend
on a database being present.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..synth import dexed_params as dx
from .preset import PresetSpec

ALL_OPERATORS = (1, 2, 3, 4, 5, 6)


def build_dexed_preset_spec(
    algos: Optional[Sequence[int]] = None,
    operators: Optional[Sequence[int]] = None,
    vst_params_learned_as_categorical: Optional[str] = "all<=32",
    constant_filter_and_tune_params: bool = True,
    learn_mod_wheel_params: bool = True,
    param_names: Optional[Sequence[str]] = None,
) -> PresetSpec:
    """:param algos: restricts the dataset to these DX7 algorithms (1..32);
        None/empty = all 32 (reference: dexeddataset.py:98-105, 119-122).
    :param operators: enabled operators (1..6); None = all
        (reference: dexeddataset.py:83-89).
    :param vst_params_learned_as_categorical: None (all numerical),
        'vst_cat', or 'all<=N' (numerical params with cardinality <= N are
        also learned as categorical) (reference: dexeddataset.py:139-167).
    """
    algos = list(algos) if algos else []
    operators = list(operators) if operators is not None else list(ALL_OPERATORS)
    n = dx.N_PARAMS

    # --- learnable indexes carving (reference: dexeddataset.py:79-95)
    learnable = set(range(n))
    if constant_filter_and_tune_params:
        learnable -= {dx.IDX_CUTOFF, dx.IDX_RESO, dx.IDX_OUTPUT, dx.IDX_MASTER_TUNE,
                      dx.IDX_TRANSPOSE}
    for op in ALL_OPERATORS:
        if op not in operators:  # disabled op: remove its first 21 params
            learnable -= {dx.op_param_index(op, off) for off in range(21)}
    # OP switches are never learnable (reference: dexeddataset.py:88-89)
    learnable -= set(int(i) for i in dx.operator_switch_indexes())
    if not learn_mod_wheel_params:
        learnable -= set(dx.mod_wheel_related_param_indexes())
    if len(algos) == 1:
        learnable -= {dx.IDX_ALGORITHM}  # constant algo (dexeddataset.py:101-102)

    # --- learnable-representation cardinalities (reference: dexeddataset.py:113-138)
    card = dx.param_cardinalities()
    default_values = {}
    if len(algos) > 0:
        card[dx.IDX_ALGORITHM] = len(algos)
    if len(algos) == 1:
        default_values[dx.IDX_ALGORITHM] = (algos[0] - 1) / 31.0
    switches = dx.operator_switch_indexes()
    card[switches] = 1
    for op_i, sw in enumerate(switches):
        default_values[int(sw)] = 1.0 if (op_i + 1) in operators else 0.0
    if constant_filter_and_tune_params:
        const_idx = [dx.IDX_CUTOFF, dx.IDX_RESO, dx.IDX_OUTPUT, dx.IDX_MASTER_TUNE,
                     dx.IDX_TRANSPOSE]
        card[const_idx] = 1
        default_values.update({dx.IDX_CUTOFF: 1.0, dx.IDX_RESO: 0.0, dx.IDX_OUTPUT: 1.0,
                               dx.IDX_MASTER_TUNE: 0.5, dx.IDX_TRANSPOSE: 0.5})
    if not learn_mod_wheel_params:
        mw = dx.mod_wheel_related_param_indexes()
        card[mw] = 1
        for i in mw:
            default_values[i] = 0.0

    # --- None / 'num' / 'cat' assignment (reference: dexeddataset.py:139-167)
    num_threshold = None
    if vst_params_learned_as_categorical is not None:
        if vst_params_learned_as_categorical.startswith("all<="):
            num_threshold = int(vst_params_learned_as_categorical.replace("all<=", ""))
        else:
            assert vst_params_learned_as_categorical == "vst_cat"
    numerical_set = set(dx.numerical_param_indexes())
    categorical_set = set(dx.categorical_param_indexes())
    learnable_model = []
    for vst_idx in range(n):
        if vst_idx not in learnable:
            learnable_model.append(None)
        elif vst_params_learned_as_categorical is None:
            learnable_model.append("num")
        elif vst_idx in numerical_set:
            if num_threshold is not None and 1 < card[vst_idx] <= num_threshold:
                learnable_model.append("cat")
            else:
                learnable_model.append("num")
        elif vst_idx in categorical_set:
            learnable_model.append("cat")
        else:
            raise ValueError(f"VST param idx={vst_idx} is neither numerical nor categorical")

    names = (
        list(param_names)
        if param_names is not None
        else [f"dexed_param_{i}" for i in range(n)]
    )
    return PresetSpec(
        n_params=n,
        learnable_model=learnable_model,
        cardinalities=card,
        numerical_vst_params=sorted(numerical_set),
        categorical_vst_params=sorted(categorical_set),
        default_values=default_values,
        param_names=names,
        synth_name="Dexed",
    )
