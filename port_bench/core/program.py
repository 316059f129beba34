"""The program under test, seen from the benchmark: its field built from
the benchmark's weights, and the field's tensors under the reference's
names."""

from __future__ import annotations

import torch



def model_cfg(cfg):
    """The program's ``TensoRFConfig`` of a configuration file."""
    from text2nerf_tpu_torch.models import tensorf as tf

    return tf.TensoRFConfig(
        model_name=cfg["model_name"], density_n_comp=tuple(cfg["n_lamb_sigma"]),
        app_n_comp=tuple(cfg["n_lamb_sh"]), app_dim=cfg["app_dim"],
        shading_mode=cfg["shadingMode"], pos_pe=cfg["pos_pe"], view_pe=cfg["view_pe"],
        fea_pe=cfg["fea_pe"], feature_c=cfg["featureC"], density_shift=cfg["density_shift"],
        distance_scale=cfg["distance_scale"],
        raymarch_weight_thres=cfg["raymarch_weight_thres"],
        alpha_mask_thres=cfg["alpha_mask_thres"], fea2dense=cfg["fea2denseAct"],
        step_ratio=cfg["step_ratio"], near=cfg["near"], far=cfg["far"],
    )


def leaves(field):
    """(name, parameter) of the program's field, named as the reference
    names its tensors."""
    for i, p in enumerate(field.planes):
        yield f"planes.{i}", p
    for i, p in enumerate(field.lines):
        yield f"lines.{i}", p
    yield "basis", field.basis
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        yield f"mlp.{k}", getattr(field.mlp, k)


def field(cfg, reso, weights: dict, device):
    """The program's field holding copies of ``weights``."""
    from text2nerf_tpu_torch.models import tensorf as tf

    f = tf.TensoRF(model_cfg(cfg), reso, device=device)
    with torch.no_grad():
        for name, p in leaves(f):
            p.copy_(weights[name])
    return f
