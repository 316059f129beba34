"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version and a launch counter (``LAUNCHES``)."""


def launch_counts() -> dict:
    """Every kernel's launches in this process so far, by name (kernel A'
    by compute type: fp32 as ``factor_features_bwd``, bf16 as
    ``factor_features_bwd_bf16``).  Plain versions on CPU tensors count
    nothing."""
    from . import cp_features as cpk
    from . import factor_features as ff
    from . import shading_mlp as sm

    return {"factor_features": ff.LAUNCHES, "factor_features_bwd": ff.BWD_DTYPES["fp32"],
            "factor_features_bwd_bf16": ff.BWD_DTYPES["bf16"], "shading_mlp": sm.LAUNCHES,
            "cp_features": cpk.LAUNCHES, "cp_features_bwd": cpk.BWD_LAUNCHES}
