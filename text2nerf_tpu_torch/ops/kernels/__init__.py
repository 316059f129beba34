"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version and a launch counter (``LAUNCHES``)."""


def launch_counts() -> dict:
    """Every kernel's launches in this process so far, by name and compute
    type (kernel A in fp32 as ``factor_features``, in bf16 as
    ``factor_features_bf16``; likewise ``_bwd`` for kernel A', and
    ``cp_features`` / ``cp_features_bwd`` for kernels C and C'; kernel B
    by mode, ``shading_mlp`` for ``MLP_Fea_noview`` and ``shading_mlp_view``
    for ``MLP_Fea``; the eval prepass as ``eval_prepass``).  Plain versions on CPU tensors count
    nothing."""
    from . import cp_features as cpk
    from . import eval_prepass as ep
    from . import factor_features as ff
    from . import shading_mlp as sm

    counts = {}
    for name, by_dtype in (("factor_features", ff.DTYPES), ("factor_features_bwd", ff.BWD_DTYPES),
                           ("cp_features", cpk.DTYPES), ("cp_features_bwd", cpk.BWD_DTYPES)):
        counts[name] = by_dtype["fp32"]
        counts[f"{name}_bf16"] = by_dtype["bf16"]
    counts["shading_mlp"] = sm.MODES["noview"]
    counts["shading_mlp_view"] = sm.MODES["view"]
    counts["eval_prepass"] = ep.LAUNCHES
    return counts


def reset_launch_counts() -> None:
    """Set every launch counter of the kernels to 0 (totals, and those by
    compute type, mode and route)."""
    from . import cp_features as cpk
    from . import eval_prepass as ep
    from . import factor_features as ff
    from . import shading_mlp as sm

    ff.LAUNCHES = ff.BWD_LAUNCHES = sm.LAUNCHES = cpk.LAUNCHES = cpk.BWD_LAUNCHES = 0
    ep.LAUNCHES = 0
    for counts in (ff.DTYPES, ff.BWD_DTYPES, ff.BWD_MODES, ff.BWD_ROUTES, sm.MODES, cpk.DTYPES,
                   cpk.BWD_DTYPES, cpk.BWD_ROUTES):
        for k in counts:
            counts[k] = 0
