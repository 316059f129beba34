"""The command-line entry point of the port:

    python -m text2nerf_tpu_torch.main --config configs/text2nerf_scenes.txt \
        --prompt "a cozy living room" --weights_dir weights [flags]

(port of ``text2nerf_tpu/main.py``).  Parses the config file and the
flags (:mod:`.config`), applies the production overrides (support set
on, known views not updated, hole filling and rendered-image warps on, a
300³ grid from the first step, batch 16384, poses regenerated), then
either renders a checkpoint (``--render_only 1`` with ``--render_test``
or ``--render_path``) or runs the fit on the services of
``--weights_dir``; ``--export_mesh 1`` writes the field's mesh beside
the log or the checkpoint.

Everything runs on ``cuda`` unless :func:`main` is asked for the CPU.
The JAX entry's persistent compilation cache is XLA's and has no
counterpart: the port's CUDA kernels are built once per checkout and
kept in ``text2nerf_tpu_torch/build/``.
"""

from __future__ import annotations

import os
import sys


def main(argv=None, *, device=None) -> int:
    """Run the command line ``argv`` (``sys.argv[1:]`` when None) on
    ``device`` (cuda unless asked; raises without CUDA).  Returns 0."""
    from . import config as cfg_mod
    from .device import resolve_device
    from .engine import trainer
    from .services.registry import default_services
    from .utils.seeding import set_seed

    dev = resolve_device(device)
    args = cfg_mod.parse_args(argv)
    # the production overrides
    args.use_support_set = True
    args.update_known_views = False
    args.use_filter_filling_holes = True
    args.use_rendered_img_to_warp = True
    args.N_voxel_init = 27_000_000
    args.N_voxel_final = 27_000_000
    args.batch_size = 1024 * 16
    args.regen_pose = True

    train_cfg, scene_cfg, expansion_cfg = cfg_mod.to_configs(args)
    set_seed(args.seed)

    # a datadir without a seed image falls back to the prompt-suffixed one
    if not os.path.isfile(os.path.join(scene_cfg.datadir, "rgbs/00000.png")):
        scene_cfg.datadir = scene_cfg.datadir + "_" + scene_cfg.prompt.replace(" ", "_")

    if args.render_only and (args.render_test or args.render_path):
        trainer.render_test(train_cfg, scene_cfg, device=dev)
        if args.export_mesh:
            _export_mesh(train_cfg.ckpt, dev)
        return 0

    services = default_services(weights_dir=args.weights_dir, hw=scene_cfg.hw, device=dev)
    _, field, aabb, _, logfolder = trainer.reconstruction(
        train_cfg, scene_cfg, services, expansion_cfg, device=dev)
    if args.export_mesh:
        from .utils.mesh import export_field_mesh

        export_field_mesh(field, aabb, os.path.join(logfolder, "mesh.ply"))
    return 0


def _export_mesh(ckpt_path: str, dev):
    """``--export_mesh`` of a render-only run: the checkpoint's field."""
    from .engine.checkpoints import load_checkpoint
    from .utils.mesh import export_field_mesh

    _, field, aabb, _, _ = load_checkpoint(ckpt_path, device=dev)
    export_field_mesh(field, aabb, os.path.join(os.path.dirname(ckpt_path), "mesh.ply"))


if __name__ == "__main__":
    sys.exit(main())
