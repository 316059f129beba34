"""npz checkpoints (port of ``save_checkpoint`` / ``load_checkpoint`` from
``text2nerf_tpu/engine/checkpoints.py``) and the bridge between the JAX
parameter pytree and the port's field, for the three decompositions.

The format is the JAX package's, so a file written by either package loads
in the other:

- ``params/<path>``: the parameter pytree flattened with '/'-joined keys
  (``vm_split``: ``density_planes/0``, ..., ``app_lines/2``; ``cp``:
  ``density_lines/i``, ``app_lines/i``; ``vm``: the stacks ``planes``
  [3, R, R, na + nd] and ``lines`` [3, R, na + nd], app channels first;
  then ``basis`` and ``mlp/w1``, ... for the MLP heads);
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


_MLP_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def _jax_leaves(field: TensoRF):
    """(parameter, [(JAX key, channel slice)]) for every parameter of the
    field, in a fixed order (planes, lines, basis, the head's weights): a
    fused table splits into its density and app channels; ``vm``'s tables
    all feed the stacks ``planes`` / ``lines`` (slice None)."""
    vm = field.cfg.model_name == "vm"
    out = []
    for name, tables in (("planes", field.planes), ("lines", field.lines)):
        for i, t in enumerate(tables):
            d = field.nd[i]
            out.append((t, [(name, None)] if vm else [(f"density_{name}/{i}", slice(0, d)),
                                                       (f"app_{name}/{i}", slice(d, None))]))
    out.append((field.basis, [("basis", None)]))
    if field.mlp is not None:
        out.extend((field.mlp[k], [(f"mlp/{k}", None)]) for k in _MLP_KEYS)
    return out


def _params(field: TensoRF) -> list:
    return [p for p, _ in _jax_leaves(field)]


def _to_flat(field: TensoRF, values) -> dict:
    """{JAX key: ndarray} of ``values`` (tensors aligned with
    :func:`_params`), copies: a fused table splits into its density and
    app channels, ``vm``'s are stacked over the axes, app channels
    first."""
    flat, stacks = {}, {}
    nd = field.nd[0]
    for (_, keys), t in zip(_jax_leaves(field), values, strict=True):
        v = np.array(t.detach().cpu().numpy())
        for key, sl in keys:
            if field.cfg.model_name == "vm" and key in ("planes", "lines"):
                stacks.setdefault(key, []).append(np.concatenate([v[..., nd:], v[..., :nd]], -1))
            else:
                flat[key] = v if sl is None else np.array(v[..., sl])
    flat.update({k: np.stack(v) for k, v in stacks.items()})
    return flat


def _from_flat(cfg: TensoRFConfig, flat: dict) -> list:
    """Tensors aligned with :func:`_params` of a ``cfg`` field, from the
    flattened JAX tree ``flat`` (the inverse of :func:`_to_flat`)."""

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    if cfg.model_name == "vm":
        na = int(cfg.app_n_comp[0])
        tables = [torch.cat([t(flat[key][i])[..., na:], t(flat[key][i])[..., :na]], -1)
                  for key in ("planes", "lines") for i in range(3)]
    else:
        keys = ("lines",) if cfg.model_name == "cp" else ("planes", "lines")
        tables = [torch.cat([t(flat[f"density_{key}/{i}"]), t(flat[f"app_{key}/{i}"])], -1)
                  for key in keys for i in range(3)]
    mlp = [t(flat[f"mlp/{k}"]) for k in _MLP_KEYS if f"mlp/{k}" in flat]
    return [*tables, t(flat["basis"]), *mlp]


def params_to_jax(field) -> dict:
    """The field as the JAX parameter pytree, flattened: {path: ndarray}.
    A sequence of S fields of one shape gives a farm's stacked pytree,
    every leaf with a leading S axis."""
    if isinstance(field, (list, tuple)):
        flats = [_to_flat(f, _params(f)) for f in field]
        return {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return _to_flat(field, _params(field))


def grads_to_jax(field: TensoRF) -> dict:
    """The field's ``.grad`` split as :func:`params_to_jax` splits the
    values (zeros for a parameter without a gradient)."""
    return _to_flat(field, [torch.zeros_like(p) if p.grad is None else p.grad
                            for p in _params(field)])


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

    cfg = field.cfg
    for p, m, v in zip(_params(field), _from_flat(cfg, mu), _from_flat(cfg, nu)):
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(p.device).reshape(p.shape),
            "exp_avg_sq": v.to(p.device).reshape(p.shape),
        }
    return TrainState(field, opt, count if step is None else int(step))


def train_state_to_jax(state) -> dict:
    """The state as JAX arrays: ``params`` (flattened), the Adam ``count``
    (int32), ``mu`` / ``nu`` (flattened like the params) and ``step``."""
    field, opt = state.field, state.optimizer
    counts = {int(opt.state[p]["step"]) for p in _params(field) if p in opt.state}
    if len(counts) > 1:
        raise ValueError(f"parameters disagree on their Adam step: {sorted(counts)}")

    def moment(name):
        return _to_flat(field, [opt.state[p][name] if p in opt.state else torch.zeros_like(p)
                                for p in _params(field)])

    return {
        "params": params_to_jax(field),
        "count": np.int32(counts.pop() if counts else 0),
        "mu": moment("exp_avg"),
        "nu": moment("exp_avg_sq"),
        "step": np.int32(state.step),
    }


def _infer_cfg(flat: dict) -> TensoRFConfig:
    """The decomposition and widths read from the shapes: ``planes`` (a
    stack) is ``vm``, ``density_planes/*`` ``vm_split``, lines alone
    ``cp``; a head is ``MLP_Fea_noview`` (its fea_pe from its input
    width), none ``RGB`` for a 3-wide basis else ``SH``.  The rest keeps
    the defaults."""
    app_dim = int(flat["basis"].shape[1])
    if "planes" in flat:
        na = int(flat["basis"].shape[0]) // 3
        nd = int(flat["planes"].shape[-1]) - na
        kw = dict(model_name="vm", density_n_comp=(nd,) * 3, app_n_comp=(na,) * 3)
    else:
        model = "vm_split" if "density_planes/0" in flat else "cp"
        nd = tuple(int(flat[f"density_lines/{i}"].shape[1]) for i in range(3))
        na = tuple(int(flat[f"app_lines/{i}"].shape[1]) for i in range(3))
        kw = dict(model_name=model, density_n_comp=nd, app_n_comp=na)
    if "mlp/w1" in flat:
        in_dim, feature_c = (int(v) for v in flat["mlp/w1"].shape)
        kw.update(fea_pe=(in_dim // app_dim - 1) // 2, feature_c=feature_c)
    else:
        kw.update(shading_mode="RGB" if app_dim == 3 else "SH")
    return TensoRFConfig(app_dim=app_dim, **kw)


def params_from_jax(flat: dict, cfg: Optional[TensoRFConfig] = None, *,
                    device=None, stacked: bool = False):
    """A field from the flattened JAX parameter pytree (numpy arrays keyed
    like ``_flatten``).  Without ``cfg`` the widths are read from the
    shapes and the rest of the config keeps its defaults.  With
    ``stacked`` the tree is a farm's (a leading S axis on every leaf) and
    the result is a list of S fields; ``device`` may then be one device or
    a sequence, scene i on ``device[i % len(device)]``."""
    if stacked:
        n = {int(np.shape(v)[0]) for v in flat.values()}
        if len(n) != 1:
            raise ValueError(f"stacked leaves disagree on their leading axis: {sorted(n)}")
        devs = list(device) if isinstance(device, (list, tuple)) else [device]
        return [params_from_jax({k: np.asarray(v)[i] for k, v in flat.items()}, cfg,
                                device=devs[i % len(devs)])
                for i in range(n.pop())]
    dev = resolve_device(device)
    cfg = cfg or _infer_cfg(flat)
    if cfg.model_name == "vm":
        reso = (int(flat["planes"].shape[1]),) * 3
    else:
        reso = tuple(int(flat[f"density_lines/{i}"].shape[0]) for i in (2, 1, 0))
    field = TensoRF(cfg, reso, device=dev)
    with torch.no_grad():
        for p, v in zip(_params(field), _from_flat(cfg, flat), strict=True):
            p.copy_(v)
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
