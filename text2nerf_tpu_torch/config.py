"""The config file and command-line flags (port of
``text2nerf_tpu/config.py``).

A ``--config`` file of ``key = value`` lines (``#`` comments, lists as
``[a,b,c]``) gives the defaults; the command line overrides them.  The
flags and their defaults are the JAX package's, so the same command
line parses to the same namespace; :func:`to_configs` maps it onto the
port's :class:`~.engine.trainer.TrainConfig`,
:class:`~.data.scene_state.SceneConfig` and
:class:`~.engine.expansion.ExpansionConfig`.  Flags the reference
accepts and never reads are accepted here too and ignored, as there.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .data.scene_state import SceneConfig
from .engine.expansion import ExpansionConfig
from .engine.trainer import TrainConfig
from .models.tensorf import TensoRFConfig


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        return [_parse_value(v) for v in raw[1:-1].split(",") if v.strip()]
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    return raw


def read_config_file(path: str) -> dict:
    """A ``key = value`` config file with ``#`` comments, as a dict."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            out[key.strip()] = _parse_value(val)
    return out


_MODEL_NAME_MAP = {"TensorVMSplit": "vm_split", "TensorCP": "cp", "TensorVM": "vm"}
_IGNORED = "accepted as the reference accepts it; never read"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("text2nerf_tpu_torch")
    a = p.add_argument
    a("--config", type=str, default=None)
    # experiment
    a("--expname", type=str, default="exp")
    a("--basedir", type=str, default="./log")
    a("--datadir", type=str, default="./data/scene")
    a("--prompt", type=str, default="a cozy living room")
    a("--weights_dir", type=str, default="weights")
    # schedule
    a("--n_stage1", type=int, default=50)
    a("--n_stage2", type=int, default=50)
    a("--batch_size", type=int, default=16384)
    a("--seed", type=int, default=1024)
    # scene
    a("--pose_traj", type=str, default="local_fixed")
    a("--num_training", type=int, default=24)
    a("--angle", type=float, default=0.2)
    a("--trans_range", type=float, default=0.2)
    a("--push_depth", type=float, default=2.0)
    a("--num_sprt_poses", type=int, default=8,
      help=f"{_IGNORED}: the support poses are the fixed 8-direction set")
    a("--dist_sprt_poses", type=float, default=0.2,
      help=f"{_IGNORED}: trans_range sets the support poses' distance")
    a("--regen_pose", action=argparse.BooleanOptionalAction, default=True)
    a("--use_support_set", action=argparse.BooleanOptionalAction, default=True)
    a("--hw", type=int, nargs=2, default=[512, 512])
    # learning rates, losses
    a("--lr_init", type=float, default=0.02)
    a("--lr_basis", type=float, default=1e-3)
    a("--lr_decay_iters", type=int, default=-1)
    a("--lr_decay_target_ratio", type=float, default=0.1)
    a("--TV_weight_density", type=float, default=0.1)
    a("--TV_weight_app", type=float, default=0.01)
    a("--L1_weight_inital", type=float, default=0.0)
    a("--Ortho_weight", type=float, default=0.0)
    # model
    a("--model_name", type=str, default="TensorVMSplit", choices=list(_MODEL_NAME_MAP))
    a("--n_lamb_sigma", type=int, nargs="*", default=[16, 16, 16])
    a("--n_lamb_sh", type=int, nargs="*", default=[48, 48, 48])
    a("--data_dim_color", type=int, default=27)
    a("--shadingMode", type=str, default="MLP_Fea_noview")
    a("--pos_pe", type=int, default=6)
    a("--view_pe", type=int, default=2)
    a("--fea_pe", type=int, default=6)
    a("--featureC", type=int, default=128)
    a("--density_shift", type=float, default=-10.0)
    a("--distance_scale", type=float, default=25.0)
    a("--rm_weight_mask_thre", type=float, default=1e-4)
    a("--alpha_mask_thre", type=float, default=1e-4)
    a("--fea2denseAct", type=str, default="softplus")
    a("--step_ratio", type=float, default=1.0)
    a("--N_voxel_init", type=int, default=27_000_000)
    a("--N_voxel_final", type=int, default=27_000_000)
    a("--upsamp_list", type=int, nargs="*", default=[])
    a("--update_AlphaMask_list", type=int, nargs="*", default=[])
    a("--nSamples", type=int, default=10 ** 6)
    a("--ndc_ray", type=int, default=0)
    a("--app_k", type=int, default=64)
    # rendering entries
    a("--ckpt", type=str, default=None)
    a("--render_only", type=int, default=0)
    a("--render_test", type=int, default=0)
    a("--render_path", type=int, default=0)
    a("--render_train", type=int, default=0)
    a("--type_depth_loss", type=str, default="mse", choices=["mse", "ssi", "silog"])
    a("--n_stage3", type=int, default=10, help="stage-3 epochs over every view's pool")
    a("--N_vis", type=int, default=-1, help="evaluate only N_vis equally spaced views")
    a("--vis_every", type=int, default=10000,
      help=f"{_IGNORED}: evaluations follow the epochs")
    a("--progress_refresh_rate", type=int, default=50, help="scalar-log cadence in steps")
    a("--lr_upsample_reset", type=int, default=1,
      help="reset the LR schedule after a grid upsample")
    a("--L1_weight_rest", type=float, default=0.0,
      help="L1 weight after the first alpha-mask update")
    a("--add_timestamp", type=int, default=0, help="append a timestamp to the log folder")
    a("--n_iters", type=int, default=30000,
      help=f"{_IGNORED}: the schedule is in epochs (n_stage1/2/3)")
    a("--perturb", type=float, default=1.0,
      help=f"{_IGNORED}: train-time sample jitter is always on")
    a("--accumulate_decay", type=float, default=0.998, help=_IGNORED)
    a("--white_bkgd", action="store_true", default=False,
      help=f"{_IGNORED}: the background comes from the scene config")
    a("--dibr_fill_strategy", type=str, default="filter",
      help=f"{_IGNORED}: hole filling follows use_filter_filling_holes")
    a("--inpaint_method", type=str, default="sdm",
      help=f"{_IGNORED}: SD inpainting is the only method")
    a("--inpainted_dir", type=str, default="", help=_IGNORED)
    a("--eval_compact_k", type=int, default=64,
      help="eval renders: compacted K (-1 the adaptive renderer, 0 dense)")
    a("--train_density_group", type=int, default=2,
      help="ray-consecutive samples per grouped density row (1 = per sample)")
    a("--train_compact_k", type=int, default=64,
      help="compacted train samples per ray once a mask exists (0 = dense)")
    a("--train_depth_cap_band", type=int, default=6,
      help="depth-anchored compaction band in march steps (0 = first-K-live)")
    a("--train_microbatch", type=int, default=32, help="micro-batches of the dense step")
    a("--train_microbatch_compact", type=int, default=1,
      help="micro-batches of the compacted step (0 = --train_microbatch)")
    a("--train_compute_dtype", type=str, default="fp32", choices=("fp32", "bf16"))
    a("--export_mesh", type=int, default=0)
    a("--resume", type=int, default=0,
      help="resume a crashed run from the last stage boundary")
    a("--resume_every_epochs", type=int, default=0,
      help="also checkpoint every N epochs (0 = stage boundaries only)")
    # expansion
    a("--frame_select_type", type=str, default="auto_cos")
    a("--use_filter_filling_holes", action=argparse.BooleanOptionalAction, default=True)
    a("--use_rendered_img_to_warp", action=argparse.BooleanOptionalAction, default=True)
    a("--update_known_views", action="store_true", default=False)
    return p


def parse_args(argv: Optional[List[str]] = None):
    """The command line (``sys.argv`` when ``argv`` is None) over the
    optional config file: the file's values are defaults, flags win."""
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        file_vals = read_config_file(args.config)
        known = {act.dest for act in parser._actions}
        parser.set_defaults(**{k: v for k, v in file_vals.items() if k in known})
        args = parser.parse_args(argv)
    return args


def to_configs(args):
    """Namespace → (TrainConfig, SceneConfig, ExpansionConfig)."""
    model = TensoRFConfig(
        model_name=_MODEL_NAME_MAP[args.model_name],
        density_n_comp=tuple(args.n_lamb_sigma), app_n_comp=tuple(args.n_lamb_sh),
        app_dim=args.data_dim_color, shading_mode=args.shadingMode,
        pos_pe=args.pos_pe, view_pe=args.view_pe, fea_pe=args.fea_pe,
        feature_c=args.featureC, density_shift=args.density_shift,
        distance_scale=args.distance_scale,
        raymarch_weight_thres=args.rm_weight_mask_thre,
        alpha_mask_thres=args.alpha_mask_thre, fea2dense=args.fea2denseAct,
        step_ratio=args.step_ratio,
    )
    train = TrainConfig(
        expname=args.expname, basedir=args.basedir,
        n_stage1=args.n_stage1, n_stage2=args.n_stage2, batch_size=args.batch_size,
        lr_init=args.lr_init, lr_basis=args.lr_basis, lr_decay_iters=args.lr_decay_iters,
        lr_decay_target_ratio=args.lr_decay_target_ratio,
        tv_weight_density=args.TV_weight_density, tv_weight_app=args.TV_weight_app,
        l1_weight=args.L1_weight_inital, ortho_weight=args.Ortho_weight,
        resume=bool(args.resume),
        n_voxel_init=args.N_voxel_init, n_voxel_final=args.N_voxel_final,
        upsamp_list=tuple(args.upsamp_list),
        update_alphamask_list=tuple(args.update_AlphaMask_list),
        n_samples_cap=args.nSamples, app_k=args.app_k, ndc_ray=bool(args.ndc_ray),
        ckpt=args.ckpt, render_test=bool(args.render_test),
        render_path=bool(args.render_path), render_train=bool(args.render_train),
        depth_loss_type=args.type_depth_loss, eval_compact_k=args.eval_compact_k,
        n_stage3=args.n_stage3, n_vis=args.N_vis,
        progress_refresh_rate=args.progress_refresh_rate,
        lr_upsample_reset=bool(args.lr_upsample_reset), l1_weight_rest=args.L1_weight_rest,
        add_timestamp=bool(args.add_timestamp),
        train_density_group=args.train_density_group,
        train_compact_k=args.train_compact_k,
        train_depth_cap_band=args.train_depth_cap_band,
        train_microbatch=args.train_microbatch,
        train_microbatch_compact=args.train_microbatch_compact,
        train_compute_dtype=args.train_compute_dtype,
        resume_every_epochs=args.resume_every_epochs, seed=args.seed, model=model,
    )
    scene = SceneConfig(
        datadir=args.datadir, prompt=args.prompt, pose_traj=args.pose_traj,
        num_training=args.num_training, angle=args.angle, trans_range=args.trans_range,
        push_depth=args.push_depth, hw=tuple(args.hw),
        use_support_set=args.use_support_set, regen_pose=args.regen_pose,
    )
    expansion = ExpansionConfig(
        prompt=args.prompt, push_depth=args.push_depth, trans_range=args.trans_range,
        use_support_set=args.use_support_set, update_known_views=args.update_known_views,
        use_filter_filling_holes=args.use_filter_filling_holes,
        use_rendered_img_to_warp=args.use_rendered_img_to_warp,
        frame_select_type=args.frame_select_type, chunk=args.batch_size, app_k=args.app_k,
    )
    return train, scene, expansion
