"""The weights tool for the merge net:

    python -m text2nerf_tpu_torch.convert_weights --weights_dir D --out_dir O

It validates the tree ``D`` through :mod:`.services.weights_manifest`,
reads the merge generator's torch checkpoint (the first of
``merge_model_sc/**/*net_G*.pth``, then ``**/epoch_*``, such as the
reference's ``latest_net_G.pth``) through
:func:`.services.merge.state_from_torch` (unet_1024: 10 levels, every
entry the checkpoint lacks zero) and writes ``O/merge_model_sc.npz``: the
``generator/UnetSkipBlock_i/...`` keys in the flax layouts, as the JAX
package's tool writes them, which both packages' registries look for.
The port's :class:`.services.merge.DepthMergeService` reads it.

Prints one JSON status line ({"family", "status", "detail"}; status
``converted``, ``absent`` or ``error``) and exits 1 on an error.  The
other families need no conversion: the port reads them in place.
Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

FAMILY = "merge_model_sc"
NUM_DOWNS = 10


def _status(name, state, detail=""):
    print(json.dumps({"family": name, "status": state, "detail": detail}))
    return state != "error"


def write_merge_npz(src: str, path: str, num_downs: int = NUM_DOWNS) -> None:
    """The generator of the torch checkpoint ``src`` as the npz at
    ``path`` (``generator/...`` keys, flax layouts)."""
    from .models.pix2pix import UnetGenerator, state_to_flax
    from .services.merge import state_from_torch
    from .utils.atomic_io import atomic_savez

    state = state_from_torch(src, UnetGenerator(1, 1, num_downs), num_downs)
    atomic_savez(path, **{f"generator/{k}": v for k, v in state_to_flax(state).items()})


def convert_merge(weights_dir: str, out_dir: str) -> bool:
    from .services import weights_manifest
    from .services.registry import MERGE_WEIGHTS

    report = next(r for r in weights_manifest.validate_tree(weights_dir)
                  if r["family"] == FAMILY)
    if report["status"] == "absent":
        return _status(FAMILY, "absent")
    if report["status"] != "ok":
        return _status(FAMILY, "error", "; ".join(report["diffs"])[:200])
    src = report["detail"]
    try:
        write_merge_npz(src, os.path.join(out_dir, MERGE_WEIGHTS))
    except Exception as e:  # noqa: BLE001 — reported as the family's status
        return _status(FAMILY, "error", str(e)[:200])
    return _status(FAMILY, "converted", src)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights_dir", default="weights")
    p.add_argument("--out_dir", default=None, help="where merge_model_sc.npz goes "
                                                   "(default: --weights_dir)")
    args = p.parse_args(argv)
    out_dir = args.out_dir or args.weights_dir
    os.makedirs(out_dir, exist_ok=True)
    return 0 if convert_merge(args.weights_dir, out_dir) else 1


if __name__ == "__main__":
    raise SystemExit(main())
