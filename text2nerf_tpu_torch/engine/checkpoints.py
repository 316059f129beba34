"""npz checkpoints (port of ``save_checkpoint`` / ``load_checkpoint`` from
``text2nerf_tpu/engine/checkpoints.py``) and the bridge between the JAX
parameter pytree and the port's field.

The format is the JAX package's, so a file written by either package loads
in the other:

- ``params/<path>``: the parameter pytree flattened with '/'-joined keys
  (``density_planes/0``, ..., ``basis``, ``mlp/w1``, ...);
- ``aabb``;
- ``__kwargs__``: the TensoRFConfig as JSON bytes;
- ``alphaMask.mask`` (np.packbits of the [z, y, x] volume),
  ``alphaMask.shape``, ``alphaMask.aabb``, ``alphaMask.pool``;
- ``__loop_state__``: optional JSON bytes.

:func:`train_state_from_jax` / :func:`train_state_to_jax` carry a train
state (the params and optax's Adam moments) across, so a JAX run can be
resumed in the port; :func:`grads_to_jax` splits gradients as the params.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.tensorf import TensoRF, TensoRFConfig
from ..utils.atomic_io import atomic_savez


def _jax_leaves(field: TensoRF):
    """(parameter, [(JAX key, channel slice)]) for every parameter of the
    field: a fused table splits into its density and app channels."""
    out = []
    for name, tables in (("planes", field.planes), ("lines", field.lines)):
        for i, t in enumerate(tables):
            nd = field.nd[i]
            out.append((t, [(f"density_{name}/{i}", slice(0, nd)),
                            (f"app_{name}/{i}", slice(nd, None))]))
    out.append((field.basis, [("basis", None)]))
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        out.append((field.mlp[k], [(f"mlp/{k}", None)]))
    return out


def _split(field: TensoRF, value_of) -> dict:
    """{JAX key: ndarray} of ``value_of(parameter)`` for every parameter,
    copies (a training step updates the parameters in place)."""
    flat = {}
    for p, keys in _jax_leaves(field):
        v = value_of(p).detach().cpu()
        for key, sl in keys:
            flat[key] = np.array((v if sl is None else v[..., sl]).numpy())
    return flat


def params_to_jax(field: TensoRF) -> dict:
    """The field as the JAX parameter pytree, flattened: {path: ndarray}."""
    return _split(field, lambda p: p)


def grads_to_jax(field: TensoRF) -> dict:
    """The field's ``.grad`` split as :func:`params_to_jax` splits the
    values (zeros for a parameter without a gradient)."""
    return _split(field, lambda p: torch.zeros_like(p) if p.grad is None else p.grad)


def _flatten_tree(tree, prefix=""):
    """{'/'-joined path: ndarray} of a nested dict / tuple of arrays; empty
    tuples (optax's MaskedNode) have no leaves."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _adam_moments(opt_state):
    """(count, {key: mu}, {key: nu}) from an optax optimizer state (every
    ``ScaleByAdamState`` in it, found by its count/mu/nu fields) or from
    the dict :func:`train_state_to_jax` returns."""
    if isinstance(opt_state, dict) and "mu" in opt_state:
        return int(opt_state["count"]), dict(opt_state["mu"]), dict(opt_state["nu"])
    found = []

    def walk(node):
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    if not found:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    counts = {int(np.asarray(a.count)) for a in found}
    if len(counts) != 1:
        raise ValueError(f"Adam states disagree on their count: {sorted(counts)}")
    mu, nu = {}, {}
    for a in found:
        mu.update(_flatten_tree(a.mu))
        nu.update(_flatten_tree(a.nu))
    return counts.pop(), mu, nu


def train_state_from_jax(params_flat: dict, opt_state, cfg: Optional[TensoRFConfig] = None,
                         *, step: Optional[int] = None, lr_init=0.02, lr_basis=1e-3,
                         factor=1.0, runtime_decay=False, device=None):
    """A port TrainState resuming a JAX run: the field from the flattened
    params, and its Adam state from optax's (``count``, ``mu``/``nu`` per
    leaf → ``step``, ``exp_avg``/``exp_avg_sq`` per parameter, a fused
    table's density ‖ app moments concatenated along channels).  ``step``
    defaults to the Adam count."""
    from .train_step import TrainState, make_optimizer

    field = params_from_jax(params_flat, cfg, device=device)
    opt = make_optimizer(field, lr_init, lr_basis, factor, runtime_decay)
    count, mu, nu = _adam_moments(opt_state)

    def joined(tree, keys, like):
        parts = [torch.from_numpy(np.array(tree[k], np.float32)) for k, _ in keys]
        return torch.cat(parts, -1).to(like.device).reshape(like.shape)

    for p, keys in _jax_leaves(field):
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": joined(mu, keys, p),
            "exp_avg_sq": joined(nu, keys, p),
        }
    return TrainState(field, opt, count if step is None else int(step))


def train_state_to_jax(state) -> dict:
    """The state as JAX arrays: ``params`` (flattened), the Adam ``count``
    (int32), ``mu`` / ``nu`` (flattened like the params) and ``step``."""
    field, opt = state.field, state.optimizer
    counts = {int(opt.state[p]["step"]) for p, _ in _jax_leaves(field) if p in opt.state}
    if len(counts) > 1:
        raise ValueError(f"parameters disagree on their Adam step: {sorted(counts)}")

    def moment(name):
        return _split(field, lambda p: opt.state[p][name] if p in opt.state
                      else torch.zeros_like(p))

    return {
        "params": params_to_jax(field),
        "count": np.int32(counts.pop() if counts else 0),
        "mu": moment("exp_avg"),
        "nu": moment("exp_avg_sq"),
        "step": np.int32(state.step),
    }


def _infer_cfg(flat: dict) -> TensoRFConfig:
    nd = tuple(int(flat[f"density_lines/{i}"].shape[1]) for i in range(3))
    na = tuple(int(flat[f"app_lines/{i}"].shape[1]) for i in range(3))
    app_dim = int(flat["basis"].shape[1])
    in_dim, feature_c = (int(v) for v in flat["mlp/w1"].shape)
    return TensoRFConfig(
        density_n_comp=nd, app_n_comp=na, app_dim=app_dim,
        fea_pe=(in_dim // app_dim - 1) // 2, feature_c=feature_c,
    )


def params_from_jax(flat: dict, cfg: Optional[TensoRFConfig] = None, *,
                    device=None) -> TensoRF:
    """A field from the flattened JAX parameter pytree (numpy arrays keyed
    like ``_flatten``).  Without ``cfg`` the widths are read from the
    shapes and the rest of the config keeps its defaults."""
    dev = resolve_device(device)
    cfg = cfg or _infer_cfg(flat)
    if cfg.model_name != "vm_split":
        raise NotImplementedError(f"model_name={cfg.model_name!r} is not ported yet")
    reso = tuple(int(flat[f"density_lines/{i}"].shape[0]) for i in (2, 1, 0))
    field = TensoRF(cfg, reso, device=dev)

    def t(key):
        return torch.from_numpy(np.array(flat[key], np.float32))

    with torch.no_grad():
        for i in range(3):
            field.planes[i].copy_(
                torch.cat([t(f"density_planes/{i}"), t(f"app_planes/{i}")], -1)
            )
            field.lines[i].copy_(
                torch.cat([t(f"density_lines/{i}"), t(f"app_lines/{i}")], -1)
            )
        field.basis.copy_(t("basis"))
        for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
            field.mlp[k].copy_(t(f"mlp/{k}"))
    return field


def save_checkpoint(
    path: str,
    field: TensoRF,
    aabb,
    alpha_mask=None,
    loop_state: Optional[dict] = None,
):
    """Save a checkpoint; the alpha mask volume is stored bit-packed."""
    blobs = {f"params/{k}": v for k, v in params_to_jax(field).items()}
    blobs["aabb"] = np.asarray(torch.as_tensor(aabb).cpu())
    blobs["__kwargs__"] = np.frombuffer(
        json.dumps(field.cfg.to_dict()).encode(), dtype=np.uint8
    )
    if alpha_mask is not None:
        vol = np.asarray(torch.as_tensor(alpha_mask["volume"]).cpu()).astype(bool)
        blobs["alphaMask.shape"] = np.asarray(vol.shape)
        blobs["alphaMask.mask"] = np.packbits(vol.reshape(-1))
        blobs["alphaMask.aabb"] = np.asarray(torch.as_tensor(alpha_mask["aabb"]).cpu())
        blobs["alphaMask.pool"] = np.asarray(int(alpha_mask.get("pool", 3)))
    if loop_state is not None:
        blobs["__loop_state__"] = np.frombuffer(
            json.dumps(loop_state).encode(), dtype=np.uint8
        )
    atomic_savez(path, **blobs)


def load_checkpoint(path: str, *, device=None):
    """Load a checkpoint → (cfg, field, aabb, alpha_mask | None,
    loop_state | None), tensors on ``device`` (cuda unless asked)."""
    dev = resolve_device(device)
    data = dict(np.load(path, allow_pickle=False))
    cfg = TensoRFConfig.from_dict(
        json.loads(bytes(data.pop("__kwargs__").tobytes()).decode())
    )
    aabb = torch.as_tensor(data.pop("aabb")).to(dev)
    alpha_mask = None
    if "alphaMask.mask" in data:
        shape = tuple(int(s) for s in data.pop("alphaMask.shape"))
        n = int(np.prod(shape))
        bits = np.unpackbits(data.pop("alphaMask.mask"))[:n].reshape(shape)
        alpha_mask = {
            "volume": torch.as_tensor(bits, dtype=torch.float32).to(dev),
            "aabb": torch.as_tensor(data.pop("alphaMask.aabb")).to(dev),
            "pool": int(data.pop("alphaMask.pool", 3)),
        }
    loop_state = None
    if "__loop_state__" in data:
        loop_state = json.loads(bytes(data.pop("__loop_state__").tobytes()).decode())
    flat = {k[len("params/"):]: v for k, v in data.items() if k.startswith("params/")}
    field = params_from_jax(flat, cfg, device=dev)
    return cfg, field, aabb, alpha_mask, loop_state
