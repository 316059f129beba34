"""Stage 3 with ``stage3_balance="uniform"`` through both packages on the
CPU, at a reduced schedule, under two eval-mask dilations.

    JAX_PLATFORMS=cpu python tests/repro_stage3_uniform.py \
        [--views 2] [--stages 2 1 2] [--pools 3 5] [--out DIR]

For each ``eval_mask_pool``, the JAX trainer and the port's run the same
progressive fit (the tiny field, batch and merge net of
``test_torch_expansion.py``'s progressive fit, one seed; the JAX
trainer's jitter injected into the port's steps).  Prints one JSON line
per pool with:

- ``stage3_views``: per stage-3 step, how many of the batch's rays came
  from each view's update pool (its own rays and its support rays), for
  each package, and whether the two are equal step by step;
- ``eval_psnr``: each package's stage-boundary eval PSNRs, by step;
- ``compacted_steps``: the port's steps that ran compacted (train mask
  on), by stage;
- ``mse_rel_max``: the largest relative per-step mse difference, and
  ``first_step_apart``: the first step whose mse differs by more than
  1e-5 relative (None if none does).

At 2 views the two packages take the same steps (the sampler ids equal).
At 3 views a few rays of view 1's support warps differ by up to one uint8
level between the packages, so the steps part after its boundary and
view 2's pool can differ in size; compare the views' shares and the
evals there, not the steps.

The JAX package's trainer took ``eval_mask_pool=3`` as its default after
its ``uniform`` full-schedule run of record and before its
``tail_deficit`` one; pool 5 licenses the group-2 strided occupancy test
that switches the compacted train step on, pool 3 does not.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_expansion as TE  # noqa: E402
from test_torch_trainer import _jax_key_stream, _Recorder, _rows  # noqa: E402


def _view_counts(batches, scene):
    """Rays per view of each batch: a ray's view is the update pool that
    holds it (the last column counts rays found in none)."""
    owner = {}
    for v, key in enumerate(sorted(scene.updates)):
        for row in np.asarray(scene.updates[key][0], np.float32):
            owner.setdefault(row.tobytes(), v)
    n = len(scene.updates)
    return [np.bincount([owner.get(r.tobytes(), n) for r in b], minlength=n + 1).tolist()
            for b in batches]


def _batches(module):
    """Record each batch's rays as the trainer draws it."""
    real = module._batch_from_pool
    seen = []

    def wrapped(pool, ids, *a, **kw):
        seen.append(np.asarray(pool[0][ids], np.float32))
        return real(pool, ids, *a, **kw)

    return real, wrapped, seen


def run(root, pool, views, stages):
    sched = dict(TE.SCHEDULE, n_stage1=stages[0], n_stage2=stages[1], n_stage3=stages[2],
                 eval_mask_pool=pool, stage3_balance="uniform")
    reso = TE.tf.n_to_reso(sched["n_voxel_init"], np.array([[-8.0] * 3, [8.0] * 3]))
    init = os.path.join(root, "init.npz")
    TE.jsave(init, TE.tf.TensoRFConfig(**TE.MODEL), TE.slab_params(reso),
             jnp.asarray([[-8.0] * 3, [8.0] * 3]))
    js, ps = TE._services()
    scene = dict(prompt=TE.PROMPT, pose_traj="circle0_30", num_training=views, hw=TE.HW,
                 num_filter_iter=2, filter_size=(3, 3))
    jreal, jwrap, jseen = _batches(TE.JT)
    preal, pwrap, pseen = _batches(TE.PT)
    TE.JT._batch_from_pool, TE.PT._batch_from_pool = jwrap, pwrap
    try:
        with TE._no_warmup(), _Recorder(TE.JTS.PermutationSampler) as jids:
            jres = TE.JT.reconstruction(
                TE.JT.TrainConfig(expname="j", basedir=os.path.join(root, "jl"), ckpt=init,
                                  model=TE.tf.TensoRFConfig(**TE.MODEL), **sched),
                TE.ss.SceneConfig(datadir=os.path.join(root, "jd"), **scene), js,
                TE._expansion_cfg(TE.JE.ExpansionConfig))
        kinds = []
        with _Recorder(TE.PTS.PermutationSampler) as pids, \
                _jax_key_stream(sched["seed"], kinds):
            pres = TE.PT.reconstruction(
                TE.PT.TrainConfig(expname="p", basedir=os.path.join(root, "pl"), ckpt=init,
                                  model=TE.ptf.TensoRFConfig(**TE.MODEL), **sched),
                TE.pss.SceneConfig(datadir=os.path.join(root, "pd"), **scene), ps,
                TE._expansion_cfg(TE.PE.ExpansionConfig), device="cpu")
    finally:
        TE.JT._batch_from_pool, TE.PT._batch_from_pool = jreal, preal

    jrows, prows = _rows(jres[4]), _rows(pres[4])
    # stage 1 ends at the first view's boundary; stage 3 starts n_stage2
    # epochs after the last one
    bounds = [r for r in prows if "pool_new_rays" in r]
    n1 = bounds[0]["step"]
    s3 = bounds[-1]["step"] + sched["n_stage2"] * bounds[-1]["iters_per_epoch"]
    n2, n3 = s3 - n1, len(kinds) - s3
    drawn = {"jax": _view_counts(jseen[s3:], jres[3]),
             "port": _view_counts(pseen[s3:], pres[3])}
    mj = np.array([r["mse"] for r in jrows if "mse" in r])
    mp = np.array([r["mse"] for r in prows if "mse" in r])
    apart = np.nonzero(np.abs(mp / mj - 1) > 1e-5)[0] if len(mj) == len(mp) else [0]
    return {
        "eval_mask_pool": pool, "views": views, "stages": list(stages),
        "steps": {"stage1": n1, "stage2": n2, "stage3": n3},
        "stage3_views": drawn,
        "stage3_views_equal": drawn["jax"] == drawn["port"] and len(drawn["port"]) == n3,
        "sampler_ids_equal": len(jids.ids) == len(pids.ids)
        and all(np.array_equal(a, b) for a, b in zip(jids.ids, pids.ids)),
        "compacted_steps": {"stage1": int(sum(kinds[:n1])),
                            "stage2": int(sum(kinds[n1:n1 + n2])),
                            "stage3": int(sum(kinds[n1 + n2:]))},
        "mse_rel_max": float(np.abs(mp / mj - 1).max()) if len(mj) == len(mp) else None,
        "first_step_apart": int(apart[0]) + 1 if len(apart) else None,
        "eval_psnr": {"jax": [(r["step"], round(r["eval_psnr"], 4)) for r in jrows
                              if "eval_psnr" in r],
                      "port": [(r["step"], round(r["eval_psnr"], 4)) for r in prows
                               if "eval_psnr" in r]},
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--views", type=int, default=2)
    p.add_argument("--stages", type=int, nargs=3, default=(2, 1, 2))
    p.add_argument("--pools", type=int, nargs="+", default=(3, 5))
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    for pool in args.pools:
        root = args.out and os.path.join(args.out, f"pool{pool}")
        if root:
            os.makedirs(root, exist_ok=True)
        else:
            root = tempfile.mkdtemp(prefix=f"stage3_pool{pool}_")
        print(json.dumps(run(root, pool, args.views, args.stages)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
